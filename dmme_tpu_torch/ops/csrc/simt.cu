// K1 and K2 at the widths group_norm.cu does not take, on the CUDA cores.
//
// The TPU kernels (dmme_tpu/ops/group_norm.py:_fwd_kernel and _bwd_kernel)
// are written for any activation dtype and any C % G == 0. The Hopper
// kernels in group_norm.cu take bf16, fp16 and f32 at C % 8 == 0 and
// C <= 2048: their threads own 16-byte vectors of 8 channels.
// ops/group_norm.py:kernel_takes sends every other width here, decided from
// the shape before any launch. This file holds the same two functions for
// f32, fp16 and bf16 (the element type a template parameter, every sum in
// f32), in plain CUDA C++:
//
//   gn_fwd_kernel   K1: y = silu(GN(x + bias)·γ + β) and the (N, G) mean and
//                   inverse std, a block per (group, sample);
//   gn_bwd_kernel   K2: dx, and the (N, C) dγ, dβ, dbias sums, a block per
//                   (group, sample).
//
// Bound on an H100: bytes. The design is the simplest that is right: a
// GroupNorm group stays in one block (the block loops over its pixels twice,
// the second pass mostly from L2), sums are taken per thread, then across
// threads in a fixed order (no atomics: repeated runs agree bit for bit).
// Speed is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

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
cudaError_t gn_bwd(const void* x, const void* dz, void* dx, float* dgamma, float* dbeta,
                   float* dbias, const float* mean, const float* inv, const float* gamma, int sg,
                   const float* beta, int sb, const float* bias, int sp, int n, int hw, int c,
                   int groups, cudaStream_t stream) {
  const size_t smem = gn_smem(c, groups);
  auto kern = gn_bwd_kernel<T>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(groups, n), THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), static_cast<T*>(dx), dgamma, dbeta,
      dbias, mean, inv, gamma, sg, beta, sb, bias, sp, hw, c, groups);
  return cudaGetLastError();
}

}  // namespace

// dtype codes (ops/__init__.py:DTYPE_CODES): 0 f32, 1 fp16, 2 bf16. Each
// entry point returns a cudaError_t.
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
  if (dtype_in == 2 && dtype_out == 2)
    return gn_fwd<__nv_bfloat16, __nv_bfloat16>(x, y, mean, inv, gamma, sg, beta, sb, bias, sp, n,
                                                hw, c, groups, eps, st);
  return (int)cudaErrorInvalidValue;
}

int dmme_simt_gn_bwd(int dtype, const void* x, const void* dz, void* dx, float* dgamma,
                     float* dbeta, float* dbias, const float* mean, const float* inv,
                     const float* gamma, int sg, const float* beta, int sb, const float* bias,
                     int sp, int n, int hw, int c, int groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return gn_bwd<float>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, gamma, sg, beta, sb, bias,
                         sp, n, hw, c, groups, st);
  if (dtype == 1)
    return gn_bwd<__half>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, gamma, sg, beta, sb, bias,
                          sp, n, hw, c, groups, st);
  if (dtype == 2)
    return gn_bwd<__nv_bfloat16>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, gamma, sg, beta, sb,
                                 bias, sp, n, hw, c, groups, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
