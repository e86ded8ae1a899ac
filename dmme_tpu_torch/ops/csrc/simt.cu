// K1–K4 for f32 and fp16 activations, on the CUDA cores.
//
// The TPU kernels (dmme_tpu/ops/group_norm.py:_fwd_kernel and _bwd_kernel,
// dmme_tpu/ops/attention.py:_attn_kernel, dmme_tpu/ops/resblock.py:
// _resblock_kernel) are written for any activation dtype. The Hopper kernels
// in group_norm.cu, attention.cu and resblock.cu are bf16 only: their TMA
// boxes, 16-byte vectors and wgmma operands are laid out for 2-byte bf16.
// This file holds the same four functions for f32 and fp16 (the element type
// a template parameter, every sum in f32), in plain CUDA C++ without tensor
// cores, so that an f32 product stays an f32 product (TF32 would keep about
// three decimal digits):
//
//   gn_fwd_kernel   K1: y = silu(GN(x + bias)·γ + β) and the (N, G) mean and
//                   inverse std, a block per (group, sample);
//   gn_bwd_kernel   K2: dx, and the (N, C) dγ, dβ, dbias sums, a block per
//                   (group, sample);
//   attn_kernel     K3: softmax(QKᵀ·scale)·V, 16 queries a block, the keys in
//                   tiles of 32 with an online softmax;
//   conv_kernel     K4's convs: an implicit GEMM over NHWC with 64×64 output
//                   tiles, the 1×1 projection continuing the K loop and the
//                   identity skip added in the epilogue; K4 is GN1+SiLU, conv1,
//                   GN2+SiLU of conv1 + pre-bias, conv2 (dmme_simt_resblock).
//
// Bounds on an H100: K1 and K2 by bytes, K3 and K4 by operations, here at the
// f32 CUDA-core rate. The design is the simplest that is right: a GroupNorm
// group stays in one block (the block loops over its pixels twice, the second
// pass mostly from L2), sums are taken per thread, then across threads in a
// fixed order (no atomics: repeated runs agree bit for bit). Speed is later work.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

__device__ __forceinline__ float silu(float y) { return y / (1.0f + expf(-y)); }

// A group's channels over the block's threads: ``lc`` channel lanes (the
// group's channels, at most THREADS) by ``lp`` pixel lanes; thread
// py·lc + cx takes channel c0 + cx of pixels py, py + lp, ...
struct Lanes {
  int lc, lp, cx, py;
  bool active;
};

__device__ __forceinline__ Lanes lanes(int cg) {
  Lanes l;
  l.lc = cg < THREADS ? cg : THREADS;
  l.lp = THREADS / l.lc;
  l.cx = threadIdx.x % l.lc;
  l.py = threadIdx.x / l.lc;
  l.active = threadIdx.x < l.lc * l.lp;
  return l;
}

// Sums of two per-thread values over the pixel lanes of each channel lane,
// in lane order, into out0[c0 + cx] and out1[c0 + cx]. ``red``: 2·THREADS floats.
__device__ __forceinline__ void channel_sums(const Lanes& l, int c0, int cg, float a, float b,
                                             float* red, float* out0, float* out1) {
  red[threadIdx.x] = a;
  red[THREADS + threadIdx.x] = b;
  __syncthreads();
  if (threadIdx.x < l.lc && c0 + (int)threadIdx.x < cg) {
    float s0 = 0.f, s1 = 0.f;
    for (int r = 0; r < l.lp; ++r) {
      s0 += red[r * l.lc + threadIdx.x];
      s1 += red[THREADS + r * l.lc + threadIdx.x];
    }
    out0[c0 + threadIdx.x] = s0;
    if (out1) out1[c0 + threadIdx.x] = s1;
  }
  __syncthreads();
}

// ---------------------------------------------------------------- K1 forward
// grid (groups, N), THREADS threads; dynamic shared memory (2·THREADS + 2·cg) floats.
// γ, β and the pre-bias are f32 rows of a row stride (0: one row for the batch).
template <typename Tin, typename Tout>
__global__ void __launch_bounds__(THREADS) gn_fwd_kernel(
    const Tin* __restrict__ x, Tout* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ inv_out, const float* __restrict__ gamma, int sg,
    const float* __restrict__ beta, int sb, const float* __restrict__ bias, int sp, int hw,
    int c, int groups, float eps) {
  extern __shared__ float smem[];
  float* red = smem;
  const int g = blockIdx.x, n = blockIdx.y, cg = c / groups;
  float* c0s = red + 2 * THREADS;  // per channel: Σu, then γ·inv
  float* c1s = c0s + cg;           // per channel: Σu², then the shift
  __shared__ float stat[2];
  const Lanes l = lanes(cg);
  const size_t base = (size_t)n * hw * c + (size_t)g * cg;
  for (int c0 = 0; c0 < cg; c0 += l.lc) {
    const int ch = c0 + l.cx;
    float s = 0.f, q = 0.f;
    if (l.active && ch < cg) {
      const float b = bias ? bias[(size_t)n * sp + g * cg + ch] : 0.f;
      for (int p = l.py; p < hw; p += l.lp) {
        const float u = to_f(x[base + (size_t)p * c + ch]) + b;
        s += u;
        q += u * u;
      }
    }
    channel_sums(l, c0, cg, s, q, red, c0s, c1s);
  }
  if (threadIdx.x == 0) {
    float s = 0.f, q = 0.f;
    for (int i = 0; i < cg; ++i) {
      s += c0s[i];
      q += c1s[i];
    }
    const float cnt = (float)hw * (float)cg;
    const float m = s / cnt;
    const float var = fmaxf(q / cnt - m * m, 0.f);
    const float iv = 1.0f / sqrtf(var + eps);
    stat[0] = m;
    stat[1] = iv;
    mean_out[n * groups + g] = m;
    inv_out[n * groups + g] = iv;
  }
  __syncthreads();
  const float m = stat[0], iv = stat[1];
  for (int i = threadIdx.x; i < cg; i += THREADS) {
    const int cc = g * cg + i;
    const float ga = gamma[(size_t)n * sg + cc], be = beta[(size_t)n * sb + cc];
    const float b = bias ? bias[(size_t)n * sp + cc] : 0.f;
    c0s[i] = iv * ga;
    c1s[i] = be + (b - m) * iv * ga;
  }
  __syncthreads();
  if (!l.active) return;
  for (int ch = l.cx; ch < cg; ch += l.lc) {
    const float a = c0s[ch], d = c1s[ch];
    for (int p = l.py; p < hw; p += l.lp) {
      const size_t at = base + (size_t)p * c + ch;
      y[at] = from_f<Tout>(silu(to_f(x[at]) * a + d));
    }
  }
}

// --------------------------------------------------------------- K2 backward
// grid (groups, N), THREADS threads; dynamic shared memory (2·THREADS + 2·cg) floats.
template <typename T>
__global__ void __launch_bounds__(THREADS) gn_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ dz, T* __restrict__ dx,
    float* __restrict__ dgamma, float* __restrict__ dbeta, float* __restrict__ dbias,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ gamma, int sg, const float* __restrict__ beta, int sb,
    const float* __restrict__ bias, int sp, int hw, int c, int groups) {
  extern __shared__ float smem[];
  float* red = smem;
  const int g = blockIdx.x, n = blockIdx.y, cg = c / groups;
  float* sdy = red + 2 * THREADS;  // per channel: Σdy
  float* sdyx = sdy + cg;          // per channel: Σdy·x̂
  __shared__ float corr[2];
  const Lanes l = lanes(cg);
  const size_t base = (size_t)n * hw * c + (size_t)g * cg;
  const size_t row = (size_t)n * c + (size_t)g * cg;
  const float m = mean[n * groups + g], iv = inv[n * groups + g];

  // dy = dz·σ(y)·(1 + y(1 − σ(y))) at y = x̂·γ + β, x̂ = (x + bias − mean)·inv
  auto dy_at = [&](size_t at, float ga, float be, float b, float& xh) {
    xh = (to_f(x[at]) + b - m) * iv;
    const float yv = xh * ga + be;
    const float s = 1.0f / (1.0f + expf(-yv));
    return to_f(dz[at]) * (s * (1.0f + yv * (1.0f - s)));
  };

  for (int c0 = 0; c0 < cg; c0 += l.lc) {
    const int ch = c0 + l.cx;
    float a0 = 0.f, a1 = 0.f;
    if (l.active && ch < cg) {
      const int cc = g * cg + ch;
      const float ga = gamma[(size_t)n * sg + cc], be = beta[(size_t)n * sb + cc];
      const float b = bias ? bias[(size_t)n * sp + cc] : 0.f;
      for (int p = l.py; p < hw; p += l.lp) {
        float xh;
        const float dyv = dy_at(base + (size_t)p * c + ch, ga, be, b, xh);
        a0 += dyv;
        a1 += dyv * xh;
      }
    }
    channel_sums(l, c0, cg, a0, a1, red, sdy, sdyx);
  }
  if (threadIdx.x == 0) {
    float m1 = 0.f, m2 = 0.f;
    for (int i = 0; i < cg; ++i) {
      const float ga = gamma[(size_t)n * sg + g * cg + i];
      m1 += ga * sdy[i];
      m2 += ga * sdyx[i];
    }
    const float cnt = (float)hw * (float)cg;
    corr[0] = m1 / cnt;
    corr[1] = m2 / cnt;
  }
  for (int i = threadIdx.x; i < cg; i += THREADS) {
    dbeta[row + i] = sdy[i];
    dgamma[row + i] = sdyx[i];
  }
  __syncthreads();
  const float m1 = corr[0], m2 = corr[1];
  for (int c0 = 0; c0 < cg; c0 += l.lc) {
    const int ch = c0 + l.cx;
    float acc = 0.f;
    if (l.active && ch < cg) {
      const int cc = g * cg + ch;
      const float ga = gamma[(size_t)n * sg + cc], be = beta[(size_t)n * sb + cc];
      const float b = bias ? bias[(size_t)n * sp + cc] : 0.f;
      for (int p = l.py; p < hw; p += l.lp) {
        const size_t at = base + (size_t)p * c + ch;
        float xh;
        const float dyv = dy_at(at, ga, be, b, xh);
        const float du = iv * (dyv * ga - m1 - xh * m2);
        dx[at] = from_f<T>(du);
        acc += du;
      }
    }
    channel_sums(l, c0, cg, acc, 0.f, red, sdy, nullptr);
    if (threadIdx.x < l.lc && c0 + (int)threadIdx.x < cg)
      dbias[row + c0 + threadIdx.x] = sdy[c0 + threadIdx.x];
  }
}

// ------------------------------------------------------------- K3 attention
constexpr int AQ = 16;  // queries a block
constexpr int AK = 32;  // keys a tile

// grid (⌈T/AQ⌉, H, N), THREADS threads. (N, T, H, D) operands with unit
// stride along D, other strides in elements. NK = ⌈D/16⌉ rounded up to a
// power of two: a thread holds NK output columns of one query row.
template <typename T, int NK>
__global__ void __launch_bounds__(THREADS) attn_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int t, int d, long long q0s, long long q1s, long long q2s, long long k0s,
    long long k1s, long long k2s, long long v0s, long long v1s, long long v2s, long long o0s,
    long long o1s, long long o2s, float scale) {
  extern __shared__ float smem[];
  const int dp = d + 1;  // padded rows: the key rows of a warp fall in distinct banks
  float* qs = smem;                // AQ × dp
  float* kv = qs + AQ * dp;        // AK × dp: the key tile, then the value tile
  float* ps = kv + AK * dp;        // AQ × AK scores, then probabilities
  float* mrow = ps + AQ * AK;      // running max of each query row
  float* lrow = mrow + AQ;         // running sum
  float* arow = lrow + AQ;         // the rescale of this tile
  const int qt = blockIdx.x * AQ, hh = blockIdx.y, nn = blockIdx.z;
  const T* qb = q + nn * q0s + hh * q2s;
  const T* kb = k + nn * k0s + hh * k2s;
  const T* vb = v + nn * v0s + hh * v2s;
  for (int e = threadIdx.x; e < AQ * d; e += THREADS) {
    const int i = e / d, j = e - i * d;
    qs[i * dp + j] = qt + i < t ? to_f(qb[(qt + i) * q1s + j]) : 0.f;
  }
  if (threadIdx.x < AQ) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int oi = threadIdx.x / 16, dl = threadIdx.x % 16;  // output row and column lane
  float acc[NK];
#pragma unroll
  for (int j = 0; j < NK; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < t; k0 += AK) {
    __syncthreads();  // the previous tile's values are read
    for (int e = threadIdx.x; e < AK * d; e += THREADS) {
      const int i = e / d, j = e - i * d;
      kv[i * dp + j] = k0 + i < t ? to_f(kb[(k0 + i) * k1s + j]) : 0.f;
    }
    __syncthreads();
    {  // scores of rows warp and warp + 8 against key ``lane``
      const float* kr = kv + lane * dp;
      const float* q1 = qs + warp * dp;
      const float* q2 = qs + (warp + 8) * dp;
      float s1 = 0.f, s2 = 0.f;
      for (int j = 0; j < d; ++j) {
        const float kj = kr[j];
        s1 += q1[j] * kj;
        s2 += q2[j] * kj;
      }
      const bool valid = k0 + lane < t;
      ps[warp * AK + lane] = valid ? s1 * scale : -INFINITY;
      ps[(warp + 8) * AK + lane] = valid ? s2 * scale : -INFINITY;
    }
    __syncthreads();
    for (int i = warp; i < AQ; i += THREADS / 32) {  // online softmax, a warp a row
      const float s = ps[i * AK + lane];
      float mx = s;
      for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mold = mrow[i], mnew = fmaxf(mold, mx);  // mx is finite: key k0 < t
      const float p = expf(s - mnew);
      float sum = p;
      for (int off = 16; off; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      ps[i * AK + lane] = p;
      if (lane == 0) {
        const float a = expf(mold - mnew);
        mrow[i] = mnew;
        lrow[i] = lrow[i] * a + sum;
        arow[i] = a;
      }
    }
    for (int e = threadIdx.x; e < AK * d; e += THREADS) {  // the keys are read: values
      const int i = e / d, j = e - i * d;
      kv[i * dp + j] = k0 + i < t ? to_f(vb[(k0 + i) * v1s + j]) : 0.f;
    }
    __syncthreads();
    const float a = arow[oi];
#pragma unroll
    for (int j = 0; j < NK; ++j) acc[j] *= a;
    for (int kk = 0; kk < AK; ++kk) {
      const float p = ps[oi * AK + kk];
      const float* vr = kv + kk * dp + dl;
#pragma unroll
      for (int j = 0; j < NK; ++j)
        if (dl + 16 * j < d) acc[j] += p * vr[16 * j];
    }
  }
  if (qt + oi >= t) return;
  const float rl = 1.0f / lrow[oi];
  T* ob = o + nn * o0s + (qt + oi) * o1s + hh * o2s;
#pragma unroll
  for (int j = 0; j < NK; ++j)
    if (dl + 16 * j < d) ob[dl + 16 * j] = from_f<T>(acc[j] * rl);
}

// ------------------------------------------------------------- K4 conv
constexpr int CBM = 64, CBN = 64, CBK = 16;

// out[m, co] = Σ_k A[m, k]·W[co, k] + bias[co] (+ skip[m, co]) over the NHWC
// pixels m of (N, H, W): k < 9·ca runs over the 3×3 taps of ``a`` (zero
// outside the image), then k < 9·ca + cp over the channels of ``proj`` at
// the same pixel. W: (C_out, 9·ca + cp), K-major. grid (⌈M/64⌉, ⌈C_out/64⌉),
// THREADS threads, each 4×4 outputs.
template <typename T, typename TOut>
__global__ void __launch_bounds__(THREADS) conv_kernel(
    const T* __restrict__ a, int ca, const T* __restrict__ proj, int cp,
    const T* __restrict__ w, const float* __restrict__ bias, const T* __restrict__ skip,
    TOut* __restrict__ out, int n, int h, int wd, int cout) {
  __shared__ __align__(16) float As[CBK][CBM + 4];
  __shared__ __align__(16) float Bs[CBK][CBN + 4];
  const int hw = h * wd, m_total = n * hw;
  const int kdim = 9 * ca + cp, taps = 9 * ca;
  const int m0 = blockIdx.x * CBM, n0 = blockIdx.y * CBN;
  const int lk = threadIdx.x % CBK, lr = threadIdx.x / CBK;  // load: k, and row r·16 + lr
  int img[4], py[4], px[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + lr + 16 * r;
    img[r] = m < m_total ? m / hw : -1;
    const int pix = m - (m / hw) * hw;
    py[r] = pix / wd;
    px[r] = pix - py[r] * wd;
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kdim; k0 += CBK) {
    const int kk = k0 + lk;
    int tap = -1, ci = 0, dy = 0, dx = 0;
    if (kk < taps) {
      tap = kk / ca;
      ci = kk - tap * ca;
      dy = tap / 3 - 1;
      dx = tap % 3 - 1;
    } else if (kk < kdim) {
      ci = kk - taps;
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float val = 0.f;
      if (img[r] >= 0 && kk < kdim) {
        if (tap >= 0) {
          const int yy = py[r] + dy, xx = px[r] + dx;
          if (yy >= 0 && yy < h && xx >= 0 && xx < wd)
            val = to_f(a[(((size_t)img[r] * h + yy) * wd + xx) * ca + ci]);
        } else {
          val = to_f(proj[(((size_t)img[r] * h + py[r]) * wd + px[r]) * cp + ci]);
        }
      }
      As[lk][lr + 16 * r] = val;
      const int co = n0 + lr + 16 * r;
      Bs[lk][lr + 16 * r] = co < cout && kk < kdim ? to_f(w[(size_t)co * kdim + kk]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < CBK; ++s) {
      const float4 av = *reinterpret_cast<const float4*>(&As[s][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[s][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += ar[i] * br[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= m_total) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = n0 + tx * 4 + j;
      if (co >= cout) continue;
      float val = acc[i][j] + bias[co];
      if (skip) val += to_f(skip[(size_t)m * cout + co]);
      out[(size_t)m * cout + co] = from_f<TOut>(val);
    }
  }
}

// ------------------------------------------------------------- host side
size_t gn_smem(int c, int groups) { return (2 * THREADS + 2 * (c / groups)) * sizeof(float); }

template <typename Tin, typename Tout>
cudaError_t gn_fwd(const void* x, void* y, float* mean, float* inv, const float* gamma, int sg,
                   const float* beta, int sb, const float* bias, int sp, int n, int hw, int c,
                   int groups, float eps, cudaStream_t stream) {
  const size_t smem = gn_smem(c, groups);
  auto kern = gn_fwd_kernel<Tin, Tout>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(groups, n), THREADS, smem, stream>>>(
      static_cast<const Tin*>(x), static_cast<Tout*>(y), mean, inv, gamma, sg, beta, sb, bias,
      sp, hw, c, groups, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t attention(const void* q, const void* k, const void* v, void* o, int n, int h, int t,
                      int d, const long long* s, float scale, cudaStream_t stream) {
  const size_t smem = ((size_t)(AQ + AK) * (d + 1) + AQ * AK + 3 * AQ) * sizeof(float);
  const dim3 grid((t + AQ - 1) / AQ, h, n);
  auto launch = [&](auto kern) {
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), t, d, s[0], s[1], s[2], s[3], s[4], s[5], s[6], s[7], s[8], s[9],
        s[10], s[11], scale);
    return cudaGetLastError();
  };
  if (d <= 64) return launch(attn_kernel<T, 4>);
  if (d <= 128) return launch(attn_kernel<T, 8>);
  if (d <= 256) return launch(attn_kernel<T, 16>);
  return launch(attn_kernel<T, 32>);
}

template <typename T, typename TOut>
cudaError_t conv(const T* a, int ca, const T* proj, int cp, const T* w, const float* bias,
                 const T* skip, TOut* out, int n, int h, int wd, int cout, cudaStream_t stream) {
  const int m = n * h * wd;
  conv_kernel<T, TOut><<<dim3((m + CBM - 1) / CBM, (cout + CBN - 1) / CBN), THREADS, 0, stream>>>(
      a, ca, proj, cp, w, bias, skip, out, n, h, wd, cout);
  return cudaGetLastError();
}

template <typename T>
cudaError_t resblock(const void* x_, const float* g1, const float* b1v, const float* pre2,
                     const float* g2, const float* b2v, const void* w1_, const float* b1,
                     const void* w2_, const float* b2, int has_proj, void* h0_, float* h1,
                     void* h2_, float* stats, void* out_, int n, int h, int wd, int cin, int cout,
                     int groups, float eps, int s_g1, int s_b1v, int s_pre2, int s_g2, int s_b2v,
                     cudaStream_t stream) {
  const T* x = static_cast<const T*>(x_);
  T* h0 = static_cast<T*>(h0_);
  T* h2 = static_cast<T*>(h2_);
  float* mean = stats;
  float* inv = stats + n * groups;
  cudaError_t e = gn_fwd<T, T>(x, h0, mean, inv, g1, s_g1, b1v, s_b1v, nullptr, 0, n, h * wd,
                               cin, groups, eps, stream);
  if (e != cudaSuccess) return e;
  e = conv<T, float>(h0, cin, nullptr, 0, static_cast<const T*>(w1_), b1, nullptr, h1, n, h, wd,
                     cout, stream);
  if (e != cudaSuccess) return e;
  e = gn_fwd<float, T>(h1, h2, mean, inv, g2, s_g2, b2v, s_b2v, pre2, s_pre2, n, h * wd, cout,
                       groups, eps, stream);
  if (e != cudaSuccess) return e;
  return conv<T, T>(h2, cout, has_proj ? x : nullptr, has_proj ? cin : 0,
                    static_cast<const T*>(w2_), b2, has_proj ? nullptr : x,
                    static_cast<T*>(out_), n, h, wd, cout, stream);
}

}  // namespace

// dtype codes: 0 f32, 1 fp16. Each entry point returns a cudaError_t.
extern "C" {

int dmme_simt_gn_fwd(int dtype_in, int dtype_out, const void* x, void* y, float* mean,
                     float* inv, const float* gamma, int sg, const float* beta, int sb,
                     const float* bias, int sp, int n, int hw, int c, int groups, float eps,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_in == 0 && dtype_out == 0)
    return gn_fwd<float, float>(x, y, mean, inv, gamma, sg, beta, sb, bias, sp, n, hw, c, groups, eps, st);
  if (dtype_in == 1 && dtype_out == 1)
    return gn_fwd<__half, __half>(x, y, mean, inv, gamma, sg, beta, sb, bias, sp, n, hw, c, groups, eps, st);
  if (dtype_in == 0 && dtype_out == 1)
    return gn_fwd<float, __half>(x, y, mean, inv, gamma, sg, beta, sb, bias, sp, n, hw, c, groups, eps, st);
  return (int)cudaErrorInvalidValue;
}

int dmme_simt_gn_bwd(int dtype, const void* x, const void* dz, void* dx, float* dgamma,
                     float* dbeta, float* dbias, const float* mean, const float* inv,
                     const float* gamma, int sg, const float* beta, int sb, const float* bias,
                     int sp, int n, int hw, int c, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = gn_smem(c, groups);
  const dim3 grid(groups, n);
  if (dtype == 0) {
    auto kern = gn_bwd_kernel<float>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, st>>>(static_cast<const float*>(x), static_cast<const float*>(dz),
                                      static_cast<float*>(dx), dgamma, dbeta, dbias, mean, inv,
                                      gamma, sg, beta, sb, bias, sp, hw, c, groups);
  } else if (dtype == 1) {
    auto kern = gn_bwd_kernel<__half>;
    if (smem > 48 * 1024)
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    kern<<<grid, THREADS, smem, st>>>(static_cast<const __half*>(x),
                                      static_cast<const __half*>(dz), static_cast<__half*>(dx),
                                      dgamma, dbeta, dbias, mean, inv, gamma, sg, beta, sb, bias,
                                      sp, hw, c, groups);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int dmme_simt_attention(int dtype, const void* q, const void* k, const void* v, void* o, int n,
                        int h, int t, int d, long long q0s, long long q1s, long long q2s,
                        long long k0s, long long k1s, long long k2s, long long v0s,
                        long long v1s, long long v2s, long long o0s, long long o1s,
                        long long o2s, float scale, void* stream) {
  const long long s[12] = {q0s, q1s, q2s, k0s, k1s, k2s, v0s, v1s, v2s, o0s, o1s, o2s};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d < 1 || d > 512) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)attention<float>(q, k, v, o, n, h, t, d, s, scale, st);
  if (dtype == 1) return (int)attention<__half>(q, k, v, o, n, h, t, d, s, scale, st);
  return (int)cudaErrorInvalidValue;
}

int dmme_simt_resblock(int dtype, const void* x, const float* g1, const float* b1v,
                       const float* pre2, const float* g2, const float* b2v, const void* w1,
                       const float* b1, const void* w2, const float* b2, int has_proj, void* h0,
                       float* h1, void* h2, float* stats, void* out, int n, int h, int w,
                       int cin, int cout, int groups, float eps, int s_g1, int s_b1v,
                       int s_pre2, int s_g2, int s_b2v, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)resblock<float>(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, has_proj, h0, h1, h2,
                                stats, out, n, h, w, cin, cout, groups, eps, s_g1, s_b1v, s_pre2,
                                s_g2, s_b2v, st);
  if (dtype == 1)
    return (int)resblock<__half>(x, g1, b1v, pre2, g2, b2v, w1, b1, w2, b2, has_proj, h0, h1,
                                 h2, stats, out, n, h, w, cin, cout, groups, eps, s_g1, s_b1v,
                                 s_pre2, s_g2, s_b2v, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
