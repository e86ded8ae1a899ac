// Fused ResBlock forward for Hopper (sm_90a), bf16 activations.
//
// Replaces the TPU kernel dmme_tpu/ops/resblock.py:_resblock_kernel (reached
// through resblock_forward), which keeps a whole batch block resident in
// VMEM for
//   h0 = silu(GN1(x));  h1 = conv3x3(h0) + b1;  h2 = silu(GN2(h1 + pre2)*g2 + b2v)
//   out = conv3x3(h2) + b2 + (x | x.Wr + br)
// One 32x32x128 bf16 sample is 256 KB, more than the 227 KB of shared
// memory a block can hold, so that residency does not map. The block runs
// instead as four launches on one stream:
//   1. gn_stats   : GN1 statistics of x per (sample, group) -> per-(n, c)
//                   scale a1 and shift d1 (f32).
//   2. conv3x3    : conv1 as an implicit GEMM, M = N*H*W pixels, K = 9*C_in,
//                   N = C_out. The tile loader reads the 9 taps of the
//                   unpadded input in place, applies silu(x*a1 + d1) and
//                   rounds to bf16, so h0 never reaches device memory; a tap
//                   outside the image reads 0 (the TPU kernel pads h0 after
//                   the SiLU). + b1 in the epilogue; h1 is written in f32.
//   3. gn_stats   : GN2 statistics of h1 + pre2 (pre-bias folded into the
//                   channel sums), a separate pass instead of atomics so the
//                   result is the same on every run.
//   4. conv3x3    : conv2 with silu(h1*a2 + d2) in the loader and b2 plus the
//                   skip in the epilogue: the identity in f32, or the 1x1
//                   projection, which continues the same accumulation as a
//                   GEMM over C_in.
// Products take bf16 operands on the tensor cores (nvcuda::wmma 16x16x16)
// with f32 accumulation, as the TPU kernel's 9 shifted matmuls do.
//
// Bound: operations. At the UNet's shapes a ResBlock does 2*M*C_out*
// (9*C_in + 9*C_out [+ C_in]) operations on a few MB, well above the ~295
// operations per byte of the H100's bf16 tensor cores. This first version
// is a plain tiled kernel (64x64 output tiles, 32-deep K steps, no
// pipelining), far from that bound; wgmma and TMA are the way there.
// At 4x4 and 8x8 the output is only 8-32 tiles, fewer than the card's SMs,
// and each tile walks up to 144 serial K steps. There a conv splits its K
// steps over blockIdx.z: each slice writes its f32 partial tile, and one
// more launch sums the slices in a fixed order and applies the epilogue,
// so the result does not depend on scheduling.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int STATS_THREADS = 256;
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int CONV_THREADS = 128;
constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ inline void from_f32(float& d, float v) { d = v; }
__device__ inline void from_f32(bf16& d, float v) { d = __float2bfloat16(v); }

// Per (sample, group): mean and inverse std of u = src + bias, as
// E[u^2] - E[u]^2 from per-channel sums with the bias folded in, and the
// per-channel coefficients a = inv*gamma, d = beta + (bias - mean)*inv*gamma
// so that GN(u)*gamma + beta = src*a + d. Requires 256 % (C/G) == 0.
// bias, gamma and beta are (N, C) rows apart by their own stride: C for a
// per-sample vector, 0 for one shared by the batch.
template <typename T>
__global__ void __launch_bounds__(STATS_THREADS)
gn_stats_kernel(const T* __restrict__ src, const float* __restrict__ bias, int s_bias,
                const float* __restrict__ gamma, int s_gamma,
                const float* __restrict__ beta, int s_beta,
                float* __restrict__ a_out, float* __restrict__ d_out,
                float* __restrict__ mean_out, float* __restrict__ inv_out,
                int HW, int C, int G, float eps) {
  __shared__ float sh_s[STATS_THREADS], sh_q[STATS_THREADS];
  __shared__ float ch_u[STATS_THREADS], ch_uq[STATS_THREADS];
  __shared__ float sh_mean, sh_inv;
  const int g = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int cg = C / G;
  const int c = g * cg + tid % cg;
  const T* base = src + (size_t)n * HW * C + c;
  float s = 0.f, q = 0.f;
  for (int p = tid / cg; p < HW; p += STATS_THREADS / cg) {
    const float v = to_f32(base[(size_t)p * C]);
    s += v;
    q += v * v;
  }
  sh_s[tid] = s;
  sh_q[tid] = q;
  __syncthreads();
  const float b = (tid < cg && bias) ? bias[n * s_bias + c] : 0.f;
  if (tid < cg) {
    float cs = 0.f, cq = 0.f;
    for (int j = tid; j < STATS_THREADS; j += cg) {
      cs += sh_s[j];
      cq += sh_q[j];
    }
    ch_u[tid] = cs + HW * b;
    ch_uq[tid] = cq + 2.f * b * cs + HW * b * b;
  }
  __syncthreads();
  if (tid == 0) {
    float gs = 0.f, gq = 0.f;
    for (int j = 0; j < cg; ++j) {
      gs += ch_u[j];
      gq += ch_uq[j];
    }
    const float cnt = (float)HW * (float)cg;
    const float mean = gs / cnt;
    const float inv = rsqrtf(gq / cnt - mean * mean + eps);
    sh_mean = mean;
    sh_inv = inv;
    mean_out[n * G + g] = mean;
    inv_out[n * G + g] = inv;
  }
  __syncthreads();
  if (tid < cg) {
    const float gm = gamma[n * s_gamma + c];
    a_out[n * C + c] = sh_inv * gm;
    d_out[n * C + c] = beta[n * s_beta + c] + (b - sh_mean) * sh_inv * gm;
  }
}

// 16 consecutive channels of one pixel as f32
__device__ inline void load16(const bf16* p, float* v) {
  const uint4 r0 = reinterpret_cast<const uint4*>(p)[0];
  const uint4 r1 = reinterpret_cast<const uint4*>(p)[1];
  const bf16* h0 = reinterpret_cast<const bf16*>(&r0);
  const bf16* h1 = reinterpret_cast<const bf16*>(&r1);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = __bfloat162float(h0[i]);
    v[8 + i] = __bfloat162float(h1[i]);
  }
}
__device__ inline void load16(const float* p, float* v) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 r = reinterpret_cast<const float4*>(p)[i];
    v[4 * i] = r.x;
    v[4 * i + 1] = r.y;
    v[4 * i + 2] = r.z;
    v[4 * i + 3] = r.w;
  }
}

// out = acc + bias [+ x] for one row's 32 columns, x added in f32 (RESID)
template <typename TOut, bool RESID>
__device__ inline void epilogue_row(const float* acc, const float* __restrict__ bias,
                                    const bf16* __restrict__ x, int C0,
                                    TOut* __restrict__ out, int m, int co0, int Cout) {
  for (int i = 0; i < 32; ++i) {
    const int co = co0 + i;
    float r = acc[i] + bias[co];
    if (RESID) r += __bfloat162float(x[(size_t)m * C0 + co]);
    from_f32(out[(size_t)m * Cout + co], r);
  }
}

// Implicit-GEMM 3x3 convolution (stride 1, zero padding 1) over NHWC `src`
// with C1 channels, the tile loader applying silu(src*na + nd) per (n, c).
// PROJ continues the accumulation with the 1x1 GEMM x.Wr over C0 channels;
// RESID adds x (C0 == Cout) in f32 in the epilogue. out = acc + bias [+ x].
// With gridDim.z > 1, slice z takes K steps [z*per, (z+1)*per) and writes
// its raw f32 tile to partial[z] instead; splitk_reduce_kernel finishes.
template <typename TIn, typename TOut, bool PROJ, bool RESID>
__global__ void __launch_bounds__(CONV_THREADS)
conv3x3_kernel(const TIn* __restrict__ src, const float* __restrict__ na,
               const float* __restrict__ nd, const bf16* __restrict__ w9,
               const bf16* __restrict__ x, const bf16* __restrict__ wr,
               const float* __restrict__ bias, TOut* __restrict__ out,
               float* __restrict__ partial, int per,
               int Nb, int H, int W, int C1, int C0, int Cout) {
  __shared__ __align__(128) bf16 sA[BM * LDA];
  __shared__ __align__(128) bf16 sB[BK * LDB];
  __shared__ __align__(128) float sC[BM * LDC];

  const int tid = threadIdx.x, warp = tid / 32;
  const int M = Nb * H * W;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  // A loader: row arow (a pixel), 16 channels from acol; B loader: row brow, 16 cols
  const int arow = tid >> 1, acol = (tid & 1) * 16;
  const int brow = tid >> 2, bcol = (tid & 3) * 16;
  const int m = m0 + arow;
  const bool mvalid = m < M;
  const int img = mvalid ? m / (H * W) : 0;
  const int py = mvalid ? (m / W) % H : 0;
  const int px = mvalid ? m % W : 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  auto mma_tile = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], sA + (wm + 16 * i) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], sB + kk * LDB + wn + 16 * j, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  };
  auto load_b = [&](const bf16* wrow) {
    const uint4* s = reinterpret_cast<const uint4*>(wrow);
    uint4* d = reinterpret_cast<uint4*>(sB + brow * LDB + bcol);
    d[0] = s[0];
    d[1] = s[1];
  };

  // K steps: 9 taps x C1/BK channel chunks, then (PROJ) C0/BK chunks of x.Wr
  const int csteps = C1 / BK, conv_steps = 9 * csteps;
  const int total = conv_steps + (PROJ ? C0 / BK : 0);
  const int s_end = min(total, (int)(blockIdx.z + 1) * per);
  for (int s = blockIdx.z * per; s < s_end; ++s) {
    if (s < conv_steps) {
      const int tap = s / csteps, c0 = (s - tap * csteps) * BK;
      const int yy = py + tap / 3 - 1, xx = px + tap % 3 - 1;
      float v[16];
      if (mvalid && yy >= 0 && yy < H && xx >= 0 && xx < W) {
        const int c = c0 + acol;
        load16(src + ((size_t)(img * H + yy) * W + xx) * C1 + c, v);
        const float* a = na + (size_t)img * C1 + c;
        const float* d = nd + (size_t)img * C1 + c;
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const float y = v[i] * a[i] + d[i];
          v[i] = y / (1.f + expf(-y));
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) v[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 16; ++i) sA[arow * LDA + acol + i] = __float2bfloat16(v[i]);
      load_b(w9 + ((size_t)tap * C1 + c0 + brow) * Cout + n0 + bcol);
    } else {
      const int c0 = (s - conv_steps) * BK;
      if (mvalid) {
        const uint4* xs = reinterpret_cast<const uint4*>(x + (size_t)m * C0 + c0 + acol);
        uint4* d = reinterpret_cast<uint4*>(sA + arow * LDA + acol);
        d[0] = xs[0];
        d[1] = xs[1];
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) sA[arow * LDA + acol + i] = __float2bfloat16(0.f);
      }
      load_b(wr + (size_t)(c0 + brow) * Cout + n0 + bcol);
    }
    __syncthreads();
    mma_tile();
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(sC + (wm + 16 * i) * LDC + wn + 16 * j, acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
  const int orow = tid >> 1, ocol = (tid & 1) * 32;
  const int om = m0 + orow;
  if (om >= M) return;
  const float* acc_row = sC + orow * LDC + ocol;
  if (gridDim.z == 1) {
    epilogue_row<TOut, RESID>(acc_row, bias, x, C0, out, om, n0 + ocol, Cout);
  } else {
    float* p = partial + ((size_t)blockIdx.z * M + om) * Cout + n0 + ocol;
    for (int i = 0; i < 32; ++i) p[i] = acc_row[i];
  }
}

// Sums the split-K slices of conv3x3_kernel in slice order, then the same
// epilogue. One thread per output element, so neighbouring threads read
// neighbouring floats of each slice.
template <typename TOut, bool RESID>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                     const float* __restrict__ bias, const bf16* __restrict__ x, int C0,
                     TOut* __restrict__ out, int M, int Cout) {
  const int total = M * Cout;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int co = idx % Cout;
  float acc = 0.f;
  for (int z = 0; z < splits; ++z) acc += partial[(size_t)z * total + idx];
  float r = acc + bias[co];
  if (RESID) r += __bfloat162float(x[(size_t)(idx / Cout) * C0 + co]);
  from_f32(out[idx], r);
}

// One conv3x3_kernel launch over `splits` K slices, then the reduction if split.
template <typename TIn, typename TOut, bool PROJ, bool RESID>
void conv3x3(cudaStream_t s, int splits, const TIn* src, const float* na, const float* nd,
             const bf16* w9, const bf16* x, const bf16* wr, const float* bias, TOut* out,
             float* partial, int Nb, int H, int W, int C1, int C0, int Cout) {
  const int M = Nb * H * W;
  const int total = 9 * (C1 / BK) + (PROJ ? C0 / BK : 0);
  const int per = (total + splits - 1) / splits;
  const dim3 grid((M + BM - 1) / BM, Cout / BN, splits);
  conv3x3_kernel<TIn, TOut, PROJ, RESID><<<grid, CONV_THREADS, 0, s>>>(
      src, na, nd, w9, x, wr, bias, out, partial, per, Nb, H, W, C1, C0, Cout);
  if (splits > 1) {
    splitk_reduce_kernel<TOut, RESID><<<(M * Cout + 255) / 256, 256, 0, s>>>(
        partial, splits, bias, x, C0, out, M, Cout);
  }
}

}  // namespace

// x: (N, H, W, Cin) bf16; g1, b1v: (N, Cin) f32; pre2, g2, b2v: (N, Cout) f32,
// rows sg1, sb1, sp2, sg2, sb2 floats apart (0: one row for the whole batch);
// w1: (9*Cin, Cout) bf16; b1: (Cout) f32; w2: (9*Cout, Cout) bf16;
// b2: (Cout) f32, the projection's bias already added when wr is given;
// wr: (Cin, Cout) bf16 or null (identity skip, Cin == Cout).
// Scratch: h1 (N*H*W*Cout) f32; coef (2*N*Cin + 2*N*Cout) f32; stats (4*N*G) f32;
// partial (max(splits1, splits2)*N*H*W*Cout) f32, unused when both are 1.
// out: (N, H, W, Cout) bf16. Four launches, plus one per conv that is split.
extern "C" int dmme_resblock_fwd(const void* x, const float* g1, const float* b1v,
                                 const float* pre2, const float* g2, const float* b2v,
                                 const void* w1, const float* b1, const void* w2,
                                 const float* b2, const void* wr, float* h1, float* coef,
                                 float* stats, float* partial, void* out, int N, int H,
                                 int W, int Cin, int Cout, int G, int splits1, int splits2,
                                 int sg1, int sb1, int sp2, int sg2, int sb2, float eps,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int HW = H * W;
  const bf16* xb = static_cast<const bf16*>(x);
  float* a1 = coef;
  float* d1 = a1 + N * Cin;
  float* a2 = d1 + N * Cin;
  float* d2 = a2 + N * Cout;
  const dim3 stats_grid(G, N);
  const bf16* w1b = static_cast<const bf16*>(w1);
  const bf16* w2b = static_cast<const bf16*>(w2);
  const bf16* wrb = static_cast<const bf16*>(wr);
  bf16* outb = static_cast<bf16*>(out);

  gn_stats_kernel<bf16><<<stats_grid, STATS_THREADS, 0, s>>>(
      xb, nullptr, 0, g1, sg1, b1v, sb1, a1, d1, stats, stats + N * G, HW, Cin,
      G, eps);
  conv3x3<bf16, float, false, false>(s, splits1, xb, a1, d1, w1b, nullptr, nullptr, b1, h1,
                                     partial, N, H, W, Cin, 0, Cout);
  gn_stats_kernel<float><<<stats_grid, STATS_THREADS, 0, s>>>(
      h1, pre2, sp2, g2, sg2, b2v, sb2, a2, d2, stats + 2 * N * G,
      stats + 3 * N * G, HW, Cout, G, eps);
  if (wrb) {
    conv3x3<float, bf16, true, false>(s, splits2, h1, a2, d2, w2b, xb, wrb, b2, outb,
                                      partial, N, H, W, Cout, Cin, Cout);
  } else {
    conv3x3<float, bf16, false, true>(s, splits2, h1, a2, d2, w2b, xb, nullptr, b2, outb,
                                      partial, N, H, W, Cout, Cin, Cout);
  }
  return (int)cudaGetLastError();
}
