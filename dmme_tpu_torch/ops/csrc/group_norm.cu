// GroupNorm(+pre-bias, +per-sample affine)+SiLU for Hopper (sm_90a): the
// forward (K1) and the backward (K2), bf16, fp16 or f32 activations (the
// element type a template parameter), f32 statistics and sums.
//
// K1 replaces the TPU kernel dmme_tpu/ops/group_norm.py:_fwd_kernel
// (reached through _fwd_pallas), K2 replaces _bwd_kernel (through
// _bwd_pallas). Both hold whole samples in VMEM there; the arithmetic is
// theirs:
//   K1: u = x + bias; mean, var = E[u], E[u^2] - E[u]^2 per (sample, group),
//       from per-channel sums with the bias folded in (sum(u) = sum(x) +
//       HW*b, sum(u^2) = sum(x^2) + 2b*sum(x) + HW*b^2); y = silu(x*a + d)
//       with a = inv*gamma, d = beta + (b - mean)*inv*gamma; the (N, G) mean
//       and inverse std are written for K2.
//   K2: xh = (x + b - mean)*inv, y = xh*gamma + beta, dy = dz*s*(1 + y(1-s))
//       with s = sigmoid(y); per channel dbeta = sum(dy), dgamma =
//       sum(dy*xh); per group m1, m2 = sum_c(dbeta*gamma), sum_c(dgamma*
//       gamma) over HW*C/G; dx = inv*(dy*gamma - m1 - xh*m2) and per channel
//       dbias = sum(dx) (of the f32 dx, before its rounding to x's type).
//
// Bound on the card: bytes. A few tens of f32 operations per element, far
// below the ~295 operations per byte where the H100 stops being
// memory-bound, so the least time is one read of x (and dz) and one write
// of y (dx). The design moves each byte once:
//   - a block owns a contiguous slab of one sample's pixels with all C
//     channels. NHWC makes the slab one byte range, which thread 0 brings
//     into shared memory with 1-D TMA bulk copies (cp.async.bulk) in chunks
//     of <= 32 KB a tensor, one mbarrier each, so the statistics start on
//     the first chunk while the others land. Threads map to 8 channels, in
//     every type: one 16-byte vector of bf16 or fp16, two of f32; every load
//     and store is a whole 16-byte vector of a contiguous row, and any
//     C % 8 == 0 with C % G == 0 works (C/G = 3 included), since groups are
//     summed from per-channel sums. Only the vector's unpack and pack and
//     the slab's bytes depend on the type, so the three types sum in the
//     same order;
//   - the slab stays in shared memory between the statistics and the
//     apply (K2: x and dz between its two passes), so DRAM is read once;
//   - a sample larger than a block's slab is split over a thread-block
//     cluster along its pixels, of up to 8 blocks (the portable size; at
//     f32 K2's 32x32x256 sites, where 8 cannot hold a sample, a cluster of
//     16 measured slower than two passes on an H100: PERF.md). Each block's
//     per-channel partial sums go to its shared memory; after a cluster
//     barrier every block reads all of them through distributed shared
//     memory in rank order, so all ranks hold the same totals, and rank 0
//     writes the per-sample outputs;
//   - a sample that no cluster of 8 can hold (the 256x256 layers of the
//     LSUN widths; f32 K2 at 32x32x256) takes two passes over global
//     memory: per-(sample, chunk) f32 channel partials, a per-sample launch
//     that sums them in chunk order, then the apply (K2: dx and its
//     partials, then their sum);
//   - the group sums run a warp a group, and the per-sample rows (gamma,
//     beta, bias; K2's saved statistics) are staged in shared memory by all
//     threads while the bulk copies are in flight, so no thread walks a
//     chain of global loads;
//   - no float atomics anywhere: every sum has a fixed order (a thread's
//     pixels in order, then the threads of a channel in order, then the
//     ranks or chunks in order, then a group's channels over the lanes of a
//     warp and a fixed butterfly), so a repeated call gives the same bytes.
// Measured on an H100 (PERF.md): the per-element arithmetic is not
// what bounds the large sites (stripped of it a call is only slightly
// faster); the slabs' load, the block and cluster barriers and the stores
// run in lockstep waves, and a call there takes 2-3.5x its byte bound.
// The plan (blocks a sample, pixels a block, chunk size, threads, shared
// memory, one or two passes) is ops/group_norm.py:gn_plan.

#include <math.h>

#include <type_traits>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int VEC = 8;          // channels a thread: a 16-byte vector of bf16 or fp16
constexpr int MAX_CHUNKS = 16;  // bulk copies (and mbarriers) a block
constexpr int MAX_CLUSTER = 8;

// Per-sample f32 rows `s*` floats apart (0: one row serves the batch)
struct Vecs {
  const float* gamma;
  const float* beta;
  const float* bias;  // null: no pre-bias
  int sg, sb, sp;
};

// A thread's 8 channels of E: one 16-byte vector of bf16 or fp16, two of f32
template <typename E>
struct V8 {
  uint4 q[sizeof(E) / 2];
};

// by value: the 16-byte loads happen once, into registers
template <typename E>
__device__ __forceinline__ void unpack8(const V8<E>& v, float (&f)[VEC]) {
  if constexpr (std::is_same_v<E, float>) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      f[4 * j] = __uint_as_float(v.q[j].x);
      f[4 * j + 1] = __uint_as_float(v.q[j].y);
      f[4 * j + 2] = __uint_as_float(v.q[j].z);
      f[4 * j + 3] = __uint_as_float(v.q[j].w);
    }
  } else {
    const uint32_t w[4] = {v.q[0].x, v.q[0].y, v.q[0].z, v.q[0].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 t;
      if constexpr (std::is_same_v<E, __half>)
        t = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      else
        t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
}
// to nearest, even; fp16 keeps its subnormals (down to 2^-24)
template <typename E>
__device__ __forceinline__ V8<E> pack8(const float (&f)[VEC]) {
  V8<E> v;
  if constexpr (std::is_same_v<E, float>) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      v.q[j] = make_uint4(__float_as_uint(f[4 * j]), __float_as_uint(f[4 * j + 1]),
                          __float_as_uint(f[4 * j + 2]), __float_as_uint(f[4 * j + 3]));
  } else {
    v.q[0] = make_uint4(pack2<E>(f[0], f[1]), pack2<E>(f[2], f[3]), pack2<E>(f[4], f[5]),
                        pack2<E>(f[6], f[7]));
  }
  return v;
}
// A vector from global memory through the read-only path, and one stored
// past L1 (each byte is written once)
template <typename E>
__device__ __forceinline__ V8<E> ldg8(const V8<E>* p) {
  V8<E> v;
#pragma unroll
  for (int j = 0; j < (int)(sizeof(E) / 2); ++j) v.q[j] = __ldg(p->q + j);
  return v;
}
template <typename E>
__device__ __forceinline__ void stcg8(V8<E>* p, const V8<E>& v) {
#pragma unroll
  for (int j = 0; j < (int)(sizeof(E) / 2); ++j) __stcg(p->q + j, v.q[j]);
}
// two special-function operations (exp2, reciprocal) and no division
__device__ __forceinline__ float sigmoid(float y) { return __fdividef(1.f, 1.f + __expf(-y)); }

// A thread's place in a block's [pixel][C/8 vector] tile: vector column v
// (channels 8v .. 8v+7) at pixels row, row + rows, ...; threads past
// rows*V take no pixels.
struct Lanes {
  int v, row, rows;
  bool live;
};
__device__ __forceinline__ Lanes lanes(int C) {
  const int V = C / VEC, rows = blockDim.x / V;
  return {(int)threadIdx.x % V, (int)threadIdx.x / V, rows, (int)threadIdx.x < rows * V};
}

constexpr unsigned FULL = 0xffffffffu;

// Per-channel sums of Q per-thread accumulators: red holds Q x rows x C
// floats; out[q*C + c] = the rows' values summed in row order. Ends
// synchronised.
template <int Q>
__device__ __forceinline__ void block_channel_sums(const float (&acc)[Q][VEC], const Lanes& L,
                                                   float* red, float* out, int C) {
  const int span = L.rows * C;
  if (L.live) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      float4* dst = reinterpret_cast<float4*>(red + q * span + L.row * C + VEC * L.v);
      dst[0] = make_float4(acc[q][0], acc[q][1], acc[q][2], acc[q][3]);
      dst[1] = make_float4(acc[q][4], acc[q][5], acc[q][6], acc[q][7]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q * C; i += blockDim.x) {
    const int q = i / C;
    const float* col = red + q * span + (i - q * C);
    float s = 0.f;
    for (int r = 0; r < L.rows; ++r) s += col[r * C];
    out[i] = s;
  }
  __syncthreads();
}

// Sum over a warp in a fixed butterfly order; lane 0's result is the one
// used, the same on every run
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// The shared-memory layout of a one-pass block on `esize`-byte elements;
// the same arithmetic as ops/group_norm.py:_smem_bytes. Offsets in bytes
// from the base: the slab (x, and dz for K2, each `tensor` bytes), the row sums,
// the channel partials and totals, and chan's 7 per-channel rows: [0, 2C)
// coefficients, [2C, 3C) and [3C, 4C) the groups' mean and inverse std,
// [4C, 7C) gamma, beta, bias; then one mbarrier a chunk.
struct Layout {
  int tensor, red, part, tot, chan, bars, bytes;
  __host__ __device__ Layout(bool bwd, int pixels, int C, int threads, int esize) {
    tensor = ((pixels * C * esize + 127) / 128) * 128;
    red = (bwd ? 2 : 1) * tensor;
    part = red + 2 * threads * VEC * 4;  // 2 x rows x C floats, rows*C <= threads*8
    tot = part + 3 * C * 4;              // fwd: 2C sums; bwd: 2C pass 1 + C pass 2
    chan = tot + 2 * C * 4;
    bars = chan + 7 * C * 4;
    bytes = bars + MAX_CHUNKS * 8 + 128;  // + slack
  }
};

// The dynamic shared memory, addressed from the array itself so that the
// compiler keeps to shared-memory instructions (LDS/STS)
__device__ __forceinline__ unsigned char* block_smem() {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  return smem_raw;
}

// Thread 0: bring `np` pixels of NSRC tensors (C channels of E a pixel,
// src[i] to dst[i], `tensor` bytes apart in shared memory) into shared
// memory in chunks of `chunk` pixels, one mbarrier a chunk. The caller
// synchronises before any wait.
template <typename E, int NSRC>
__device__ __forceinline__ void load_slab(unsigned char* dst, int tensor,
                                          const E* const (&src)[NSRC], int np, int chunk,
                                          int C, uint64_t* bars) {
  if (threadIdx.x != 0) return;
  const int nchunks = (np + chunk - 1) / chunk;
  for (int j = 0; j < nchunks; ++j) mbar_init(&bars[j], 1);
  fence_barrier_init();
  for (int j = 0; j < nchunks; ++j) {
    const int px = min(chunk, np - j * chunk);
    const uint32_t bytes = (uint32_t)px * C * sizeof(E);
    mbar_arrive_expect_tx(&bars[j], NSRC * bytes);
    const size_t off = (size_t)j * chunk * C;
#pragma unroll
    for (int i = 0; i < NSRC; ++i)
      bulk_load(reinterpret_cast<E*>(dst + i * tensor) + off, src[i] + off, bytes, &bars[j]);
  }
}

// Sample n's gamma, beta and bias (0 without one) into rows[0..3C), all
// threads at once, while the bulk copies are in flight
__device__ __forceinline__ void stage_rows(float* rows, const Vecs& vv, int n, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    rows[c] = vv.gamma[n * vv.sg + c];
    rows[C + c] = vv.beta[n * vv.sb + c];
    rows[2 * C + c] = vv.bias ? vv.bias[n * vv.sp + c] : 0.f;
  }
}

// Per-channel totals of a sample: the `count` partials of each block of the
// cluster (at `part` in its shared memory), summed in rank order
__device__ __forceinline__ void cluster_totals(const float* part, float* tot, int count) {
  const uint32_t blocks = gridDim.x;
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    float v[MAX_CLUSTER];
#pragma unroll
    for (uint32_t r = 0; r < MAX_CLUSTER; ++r)
      if (r < blocks) v[r] = ld_cluster(part + i, r);
    float s = 0.f;
#pragma unroll
    for (uint32_t r = 0; r < MAX_CLUSTER; ++r)
      if (r < blocks) s += v[r];
    tot[i] = s;
  }
}

// Group statistics from per-channel sums (tot[0..C): sum x, tot[C..2C):
// sum x^2) with the pre-bias folded in, and the per-channel coefficients:
// chan[0..C) = a, chan[C..2C) = d, chan[2C + g] = mean, chan[3C + g] = inv.
// gam, bet, bia: the sample's rows (bia null: no pre-bias). Writes the
// sample's mean and inv rows when they are not null.
__device__ __forceinline__ void fwd_coefficients(const float* tot, float* chan, const float* gam,
                                                 const float* bet, const float* bia, int HW,
                                                 int C, int G, float eps, float* mean,
                                                 float* inv) {
  const int cg = C / G, lane = threadIdx.x % 32;
  float* gm = chan + 2 * C;
  float* gi = chan + 3 * C;
  // a warp a group: lanes take its channels, then a fixed butterfly
  for (int g = threadIdx.x / 32; g < G; g += blockDim.x / 32) {
    float gs = 0.f, gq = 0.f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      const float b = bia ? bia[c] : 0.f;
      const float s = tot[c], q = tot[C + c];
      gs += s + HW * b;
      gq += q + 2.f * b * s + HW * b * b;
    }
    gs = warp_sum(gs);
    gq = warp_sum(gq);
    if (lane == 0) {
      const float cnt = (float)HW * (float)cg;
      const float m = gs / cnt;
      const float iv = rsqrtf(gq / cnt - m * m + eps);
      gm[g] = m;
      gi[g] = iv;
      if (mean) {
        mean[g] = m;
        inv[g] = iv;
      }
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const int g = c / cg;
    const float b = bia ? bia[c] : 0.f;
    const float ga = gam[c] * gi[g];
    chan[c] = ga;
    chan[C + c] = bet[c] + (b - gm[g]) * ga;
  }
  __syncthreads();
}

// y = silu(x*a + d) over `np` pixels of `src` (shared or global) into dst
template <typename E>
__device__ __forceinline__ void apply_fwd(const E* src, E* dst, const float* chan,
                                          const Lanes& L, int np, int C) {
  if (!L.live) return;
  float a[VEC], d[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    a[i] = chan[VEC * L.v + i];
    d[i] = chan[C + VEC * L.v + i];
  }
  const int V = C / VEC;
#pragma unroll 2
  for (int p = L.row; p < np; p += L.rows) {
    float f[VEC];
    unpack8(reinterpret_cast<const V8<E>*>(src)[p * V + L.v], f);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float y = fmaf(f[i], a[i], d[i]);
      f[i] = y * sigmoid(y);
    }
    stcg8(reinterpret_cast<V8<E>*>(dst) + (size_t)p * V + L.v, pack8<E>(f));
  }
}

// A K2 thread's per-channel constants: x-hat = x*iv + sh (sh = (bias -
// mean)*iv), y = x-hat*g + b; after pass 1, dx = dy*gi - x-hat*m2i - m1i
// (gi = gamma*iv, m1i = m1*iv, m2i = m2*iv)
struct BwdCoef {
  float iv[VEC], sh[VEC], g[VEC], b[VEC];
};
// from the sample's rows: gam, bet, bia (null: none) by channel, gm, gi by group
__device__ __forceinline__ void bwd_coef(BwdCoef& k, const Lanes& L, const float* gam,
                                         const float* bet, const float* bia, const float* gm,
                                         const float* gi, int cg) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int c = VEC * L.v + i, g = c / cg;
    k.iv[i] = gi[g];
    k.sh[i] = ((bia ? bia[c] : 0.f) - gm[g]) * gi[g];
    k.g[i] = gam[c];
    k.b[i] = bet[c];
  }
}
// x-hat and dy of element i of a vector
__device__ __forceinline__ void xhat_dy(const BwdCoef& k, int i, float x, float dz, float& xh,
                                        float& dy) {
  xh = fmaf(x, k.iv[i], k.sh[i]);
  const float y = fmaf(xh, k.g[i], k.b[i]);
  const float s = sigmoid(y);
  dy = dz * (s * fmaf(y, 1.f - s, 1.f));
}
// pass 1 of K2 on one vector: per-channel sum(dy), sum(dy*xh)
template <typename E>
__device__ __forceinline__ void bwd_pass1(const BwdCoef& k, const V8<E>& xv, const V8<E>& dv,
                                          float (&acc)[2][VEC]) {
  float x[VEC], dz[VEC];
  unpack8(xv, x);
  unpack8(dv, dz);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float xh, dy;
    xhat_dy(k, i, x[i], dz[i], xh, dy);
    acc[0][i] += dy;
    acc[1][i] = fmaf(dy, xh, acc[1][i]);
  }
}
// The pass-2 constants from the per-channel m1, m2 (chan[0..C), chan[C..2C))
struct BwdCoef2 {
  float gi[VEC], m1i[VEC], m2i[VEC];
};
__device__ __forceinline__ void bwd_coef2(BwdCoef2& k2, const BwdCoef& k, const Lanes& L,
                                          const float* chan, int C) {
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    k2.gi[i] = k.g[i] * k.iv[i];
    k2.m1i[i] = chan[VEC * L.v + i] * k.iv[i];
    k2.m2i[i] = chan[C + VEC * L.v + i] * k.iv[i];
  }
}
// pass 2 of K2 on one vector: dx, and its per-channel sum
template <typename E>
__device__ __forceinline__ V8<E> bwd_pass2(const BwdCoef& k, const BwdCoef2& k2, const V8<E>& xv,
                                           const V8<E>& dv, float (&acc)[1][VEC]) {
  float x[VEC], dz[VEC];
  unpack8(xv, x);
  unpack8(dv, dz);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    float xh, dy;
    xhat_dy(k, i, x[i], dz[i], xh, dy);
    const float du = fmaf(dy, k2.gi[i], -fmaf(xh, k2.m2i[i], k2.m1i[i]));
    acc[0][i] += du;
    x[i] = du;
  }
  return pack8<E>(x);
}

// Per-group m1, m2 from the per-channel totals (tot[0..C) = dbeta,
// tot[C..2C) = dgamma) and the sample's gamma row, spread to channels:
// chan[0..C) = m1, chan[C..2C) = m2
__device__ __forceinline__ void bwd_group_means(const float* tot, float* chan, const float* gam,
                                                int HW, int C, int G) {
  const int cg = C / G, lane = threadIdx.x % 32;
  const float cnt = (float)HW * (float)cg;
  // a warp a group, as in fwd_coefficients; lane 0's sums go to every channel
  for (int g = threadIdx.x / 32; g < G; g += blockDim.x / 32) {
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      s1 += tot[c] * gam[c];
      s2 += tot[C + c] * gam[c];
    }
    s1 = __shfl_sync(FULL, warp_sum(s1), 0) / cnt;
    s2 = __shfl_sync(FULL, warp_sum(s2), 0) / cnt;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      chan[c] = s1;
      chan[C + c] = s2;
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------- one pass
// grid (blocks, N), cluster (blocks, 1, 1): block r of sample n holds
// pixels [r*pixels, min(HW, (r+1)*pixels)) in shared memory. With one block
// a sample the launch is a plain one, and the cluster barriers and
// distributed loads act on the block's own implicit one-block cluster.
template <typename E>
__global__ void __launch_bounds__(512)
gn_fwd_cluster_kernel(const E* __restrict__ x, E* __restrict__ y, float* __restrict__ mean,
                      float* __restrict__ inv, const Vecs vv, int HW, int C, int G, int pixels,
                      int chunk, float eps) {
  const Layout lay(false, pixels, C, blockDim.x, sizeof(E));
  unsigned char* sm = block_smem();
  const E* slab = reinterpret_cast<const E*>(sm);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  float* part = reinterpret_cast<float*>(sm + lay.part);
  float* tot = reinterpret_cast<float*>(sm + lay.tot);
  float* chan = reinterpret_cast<float*>(sm + lay.chan);
  float* rows = chan + 4 * C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.bars);
  const int rank = blockIdx.x, n = blockIdx.y;
  const int p0 = rank * pixels, np = min(HW - p0, pixels);
  const size_t base = ((size_t)n * HW + p0) * C;
  {
    const E* const src[1] = {x + base};
    load_slab<E, 1>(sm, lay.tensor, src, np, chunk, C, bars);
  }
  stage_rows(rows, vv, n, C);
  __syncthreads();
  const Lanes L = lanes(C);
  const int V = C / VEC;
  float acc[2][VEC] = {};
  if (L.live) {
    int ready = 0;
#pragma unroll 2
    for (int p = L.row; p < np; p += L.rows) {
      while (ready <= p / chunk) mbar_wait(&bars[ready++], 0);
      float f[VEC];
      unpack8(reinterpret_cast<const V8<E>*>(slab)[p * V + L.v], f);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        acc[0][i] += f[i];
        acc[1][i] = fmaf(f[i], f[i], acc[1][i]);
      }
    }
  }
  block_channel_sums<2>(acc, L, red, part, C);
  cluster_sync();  // every rank's partials are in its shared memory
  cluster_totals(part, tot, 2 * C);
  cluster_arrive();  // this block is done reading the others' partials
  __syncthreads();
  fwd_coefficients(tot, chan, rows, rows + C, vv.bias ? rows + 2 * C : nullptr, HW, C, G, eps,
                   rank == 0 ? mean + n * G : nullptr, inv + n * G);
  apply_fwd(slab, y + base, chan, L, np, C);
  cluster_wait();  // no block leaves while another may still read its partials
}

template <typename E>
__global__ void __launch_bounds__(512)
gn_bwd_cluster_kernel(const E* __restrict__ x, const E* __restrict__ dz, E* __restrict__ dx,
                      float* __restrict__ dgamma, float* __restrict__ dbeta,
                      float* __restrict__ dbias, const float* __restrict__ mean,
                      const float* __restrict__ inv, const Vecs vv, int HW, int C, int G,
                      int pixels, int chunk) {
  const Layout lay(true, pixels, C, blockDim.x, sizeof(E));
  unsigned char* sm = block_smem();
  const V8<E>* sx = reinterpret_cast<const V8<E>*>(sm);
  const V8<E>* sdz = reinterpret_cast<const V8<E>*>(sm + lay.tensor);
  float* red = reinterpret_cast<float*>(sm + lay.red);
  float* part = reinterpret_cast<float*>(sm + lay.part);  // 2C pass 1, then C pass 2
  float* part2 = part + 2 * C;
  float* tot = reinterpret_cast<float*>(sm + lay.tot);
  float* chan = reinterpret_cast<float*>(sm + lay.chan);
  float* rows = chan + 4 * C;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sm + lay.bars);
  const int rank = blockIdx.x, n = blockIdx.y;
  const int p0 = rank * pixels, np = min(HW - p0, pixels);
  const size_t base = ((size_t)n * HW + p0) * C;
  {
    const E* const src[2] = {x + base, dz + base};
    load_slab<E, 2>(sm, lay.tensor, src, np, chunk, C, bars);
  }
  stage_rows(rows, vv, n, C);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    chan[2 * C + g] = mean[n * G + g];
    chan[3 * C + g] = inv[n * G + g];
  }
  __syncthreads();
  const Lanes L = lanes(C);
  const int V = C / VEC;
  BwdCoef k;
  if (L.live)
    bwd_coef(k, L, rows, rows + C, vv.bias ? rows + 2 * C : nullptr, chan + 2 * C, chan + 3 * C,
             C / G);
  float acc[2][VEC] = {};
  if (L.live) {
    int ready = 0;
#pragma unroll 2
    for (int p = L.row; p < np; p += L.rows) {
      while (ready <= p / chunk) mbar_wait(&bars[ready++], 0);
      bwd_pass1<E>(k, sx[p * V + L.v], sdz[p * V + L.v], acc);
    }
  }
  block_channel_sums<2>(acc, L, red, part, C);
  cluster_sync();
  cluster_totals(part, tot, 2 * C);
  __syncthreads();
  if (rank == 0) {
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      dbeta[(size_t)n * C + c] = tot[c];
      dgamma[(size_t)n * C + c] = tot[C + c];
    }
  }
  bwd_group_means(tot, chan, rows, HW, C, G);
  float acc2[1][VEC] = {};
  if (L.live) {
    BwdCoef2 k2;
    bwd_coef2(k2, k, L, chan, C);
    V8<E>* out = reinterpret_cast<V8<E>*>(dx + base);
#pragma unroll 2
    for (int p = L.row; p < np; p += L.rows)
      stcg8(out + (size_t)p * V + L.v,
            bwd_pass2<E>(k, k2, sx[p * V + L.v], sdz[p * V + L.v], acc2));
  }
  block_channel_sums<1>(acc2, L, red, part2, C);
  cluster_sync();  // pass-2 partials are in place; every rank is past pass 1's reads
  if (rank == 0) {
    cluster_totals(part2, tot, C);
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) dbias[(size_t)n * C + c] = tot[c];
  }
  cluster_sync();  // rank 0 has read every block's pass-2 partials
}

// ------------------------------------------------------------- two passes
// grid (blocks, N); block j of sample n takes pixels [j*pixels, ...) from
// global memory and writes its 2 x C channel partials at
// part[(n*blocks + j)*2C]
template <typename E, bool BWD>
__global__ void __launch_bounds__(256)
gn_partial_kernel(const E* __restrict__ x, const E* __restrict__ dz,
                  const float* __restrict__ mean, const float* __restrict__ inv, const Vecs vv,
                  float* __restrict__ part, int HW, int C, int G, int pixels) {
  __shared__ __align__(16) float red[2 * 256 * VEC];
  const int j = blockIdx.x, n = blockIdx.y;
  const int p0 = j * pixels, np = min(HW - p0, pixels);
  const size_t base = ((size_t)n * HW + p0) * C;
  const Lanes L = lanes(C);
  const int V = C / VEC;
  float acc[2][VEC] = {};
  if (L.live) {
    const V8<E>* xs = reinterpret_cast<const V8<E>*>(x + base);
    if constexpr (BWD) {
      BwdCoef k;
      bwd_coef(k, L, vv.gamma + n * vv.sg, vv.beta + n * vv.sb,
               vv.bias ? vv.bias + n * vv.sp : nullptr, mean + n * G, inv + n * G, C / G);
      const V8<E>* ds = reinterpret_cast<const V8<E>*>(dz + base);
      for (int p = L.row; p < np; p += L.rows)
        bwd_pass1<E>(k, ldg8(xs + (size_t)p * V + L.v), ldg8(ds + (size_t)p * V + L.v), acc);
    } else {
      for (int p = L.row; p < np; p += L.rows) {
        float f[VEC];
        unpack8(ldg8(xs + (size_t)p * V + L.v), f);
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          acc[0][i] += f[i];
          acc[1][i] = fmaf(f[i], f[i], acc[1][i]);
        }
      }
    }
  }
  block_channel_sums<2>(acc, L, red, part + ((size_t)n * gridDim.x + j) * 2 * C, C);
}

// grid N: the chunk partials of sample n summed in chunk order into
// shared memory (Q*C floats), then, by `mode`: 0 K1's statistics (mean,
// inv and the per-channel a, d into coef[n*2C]); 1 K2's dbeta, dgamma
// (where out0 is not null) and the per-channel m1, m2 into coef[n*2C]; 2
// the Q*C sums themselves into out0[n*Q*C] (K2's dbias, and the split
// entries' (N, 2C) channel sums). `HW` is the pixels the statistics are
// taken over: the whole sample's, also where the partials are a shard's.
__global__ void __launch_bounds__(256)
gn_finalize_kernel(const float* __restrict__ part, int chunks, int Q, int mode, const Vecs vv,
                   float* __restrict__ out0, float* __restrict__ out1, float* __restrict__ coef,
                   int HW, int C, int G, float eps) {
  extern __shared__ __align__(16) float fin[];  // tot (2C) | chan (4C)
  float* tot = fin;
  float* chan = fin + 2 * C;
  const int n = blockIdx.x, qc = Q * C;
  for (int i = threadIdx.x; i < qc; i += blockDim.x) {
    const float* col = part + (size_t)n * chunks * qc + i;
    float s = 0.f;
    for (int j = 0; j < chunks; ++j) s += col[(size_t)j * qc];
    tot[i] = s;
  }
  __syncthreads();
  const float* gam = vv.gamma + n * vv.sg;
  if (mode == 0) {
    fwd_coefficients(tot, chan, gam, vv.beta + n * vv.sb, vv.bias ? vv.bias + n * vv.sp : nullptr,
                     HW, C, G, eps, out0 + n * G, out1 + n * G);
  } else if (mode == 1) {
    if (out0) {
      for (int c = threadIdx.x; c < C; c += blockDim.x) {
        out0[(size_t)n * C + c] = tot[c];      // dbeta
        out1[(size_t)n * C + c] = tot[C + c];  // dgamma
      }
    }
    bwd_group_means(tot, chan, gam, HW, C, G);
  } else {
    for (int i = threadIdx.x; i < qc; i += blockDim.x) out0[(size_t)n * qc + i] = tot[i];
    return;
  }
  for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) coef[(size_t)n * 2 * C + i] = chan[i];
}

// grid (blocks, N): K1's apply from global memory with the coefficients of
// gn_finalize_kernel
template <typename E>
__global__ void __launch_bounds__(256)
gn_apply_kernel(const E* __restrict__ x, E* __restrict__ y, const float* __restrict__ coef,
                int HW, int C, int pixels) {
  const int j = blockIdx.x, n = blockIdx.y;
  const int p0 = j * pixels, np = min(HW - p0, pixels);
  const size_t base = ((size_t)n * HW + p0) * C;
  apply_fwd(x + base, y + base, coef + (size_t)n * 2 * C, lanes(C), np, C);
}

// grid (blocks, N): K2's pass 2 from global memory; dx and its chunk
// partials (C floats a chunk)
template <typename E>
__global__ void __launch_bounds__(256)
gn_dx_kernel(const E* __restrict__ x, const E* __restrict__ dz, E* __restrict__ dx,
             const float* __restrict__ mean, const float* __restrict__ inv, const Vecs vv,
             const float* __restrict__ coef, float* __restrict__ part, int HW, int C, int G,
             int pixels) {
  __shared__ __align__(16) float red[256 * VEC];
  const int j = blockIdx.x, n = blockIdx.y;
  const int p0 = j * pixels, np = min(HW - p0, pixels);
  const size_t base = ((size_t)n * HW + p0) * C;
  const Lanes L = lanes(C);
  const int V = C / VEC;
  float acc[1][VEC] = {};
  if (L.live) {
    BwdCoef k;
    bwd_coef(k, L, vv.gamma + n * vv.sg, vv.beta + n * vv.sb,
             vv.bias ? vv.bias + n * vv.sp : nullptr, mean + n * G, inv + n * G, C / G);
    BwdCoef2 k2;
    bwd_coef2(k2, k, L, coef + (size_t)n * 2 * C, C);
    const V8<E>* xs = reinterpret_cast<const V8<E>*>(x + base);
    const V8<E>* ds = reinterpret_cast<const V8<E>*>(dz + base);
    V8<E>* out = reinterpret_cast<V8<E>*>(dx + base);
    for (int p = L.row; p < np; p += L.rows) {
      const size_t e = (size_t)p * V + L.v;
      stcg8(out + e, bwd_pass2<E>(k, k2, ldg8(xs + e), ldg8(ds + e), acc));
    }
  }
  block_channel_sums<1>(acc, L, red, part + ((size_t)n * gridDim.x + j) * C, C);
}

// ------------------------------------------------------------------ host
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(Kernel kernel, int blocks, int N, int threads, int smem,
                           cudaStream_t s, Args... args) {
  static int limits[64];
  cudaError_t err = allow_smem(kernel, smem, limits);
  if (err != cudaSuccess) return err;
  if (blocks == 1) {  // a sample in one block: a plain launch, measured shorter on an H100
    kernel<<<dim3(1, N), threads, smem, s>>>(args...);
    return cudaSuccess;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, N, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename E>
int gn_fwd(const void* x, void* y, float* mean, float* inv, const Vecs& vv, int N, int HW,
           int C, int G, float eps, int blocks, int pixels, int chunk, int threads, int two_pass,
           float* part, float* coef, cudaStream_t s) {
  const E* xe = static_cast<const E*>(x);
  E* ye = static_cast<E*>(y);
  cudaError_t err;
  if (!two_pass) {
    const int smem = Layout(false, pixels, C, threads, sizeof(E)).bytes;
    err = launch_cluster(gn_fwd_cluster_kernel<E>, blocks, N, threads, smem, s, xe, ye, mean, inv,
                         vv, HW, C, G, pixels, chunk, eps);
  } else {
    const dim3 grid(blocks, N);
    gn_partial_kernel<E, false><<<grid, 256, 0, s>>>(xe, nullptr, nullptr, nullptr, vv, part, HW,
                                                      C, G, pixels);
    gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part, blocks, 2, 0, vv, mean, inv, coef, HW, C,
                                                 G, eps);
    gn_apply_kernel<E><<<grid, 256, 0, s>>>(xe, ye, coef, HW, C, pixels);
    err = cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename E>
int gn_bwd(const void* x, const void* dz, void* dx, float* dgamma, float* dbeta, float* dbias,
           const float* mean, const float* inv, const Vecs& vv, int N, int HW, int C, int G,
           int blocks, int pixels, int chunk, int threads, int two_pass, float* part,
           float* part2, float* coef, cudaStream_t s) {
  const E* xe = static_cast<const E*>(x);
  const E* de = static_cast<const E*>(dz);
  E* dxe = static_cast<E*>(dx);
  cudaError_t err;
  if (!two_pass) {
    const int smem = Layout(true, pixels, C, threads, sizeof(E)).bytes;
    err = launch_cluster(gn_bwd_cluster_kernel<E>, blocks, N, threads, smem, s, xe, de, dxe,
                         dgamma, dbeta, dbias, mean, inv, vv, HW, C, G, pixels, chunk);
  } else {
    const dim3 grid(blocks, N);
    gn_partial_kernel<E, true><<<grid, 256, 0, s>>>(xe, de, mean, inv, vv, part, HW, C, G,
                                                     pixels);
    gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part, blocks, 2, 1, vv, dbeta, dgamma, coef,
                                                 HW, C, G, 0.f);
    gn_dx_kernel<E><<<grid, 256, 0, s>>>(xe, de, dxe, mean, inv, vv, coef, part2, HW, C, G,
                                         pixels);
    gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part2, blocks, 1, 2, vv, dbias, nullptr,
                                                 nullptr, HW, C, G, 0.f);
    err = cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ------------------------------------------------- H-shards (split statistics)
// The spatial mesh axis gives a rank H/S rows of every sample, so a
// sample's statistics are the sum of the ranks' channel sums. Each half of
// K1 and K2 is then a launch sequence of its own around an all-reduce of
// (N, 2C) f32 sums, made between them in Python; the kernels are the two
// passes' above, with the same fixed summation order inside a rank:
//   fwd_sums:  the shard's sum(x), sum(x^2) per channel (partials, then a
//              chunk-order sum) -> (N, 2C); the pre-bias is folded in by
//              fwd_apply over the whole sample's pixel count, as K1 folds it
//   fwd_apply: from the group's (N, 2C) totals: mean, inv and the
//              coefficients, then y on the shard's rows
//   bwd_sums:  K2's pass-1 channel sums, sum(dy) and sum(dy*xh), over the
//              shard's rows -> (N, 2C), which are also the shard's dbeta
//              and dgamma partials
//   bwd_dx:    from the group's totals: the group means, then dx on the
//              shard and its dbias partial
// `pixels` a block's chunk of the shard (ops/group_norm.py:split_plan),
// `blocks` the chunks a sample.
template <typename E>
int gn_fwd_sums(const void* x, float* sums, float* part, int N, int HW, int C, int blocks,
                int pixels, cudaStream_t s) {
  const Vecs none{nullptr, nullptr, nullptr, 0, 0, 0};
  gn_partial_kernel<E, false><<<dim3(blocks, N), 256, 0, s>>>(
      static_cast<const E*>(x), nullptr, nullptr, nullptr, none, part, HW, C, 1, pixels);
  gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part, blocks, 2, 2, none, sums, nullptr, nullptr,
                                               HW, C, 1, 0.f);
  return (int)cudaGetLastError();
}

template <typename E>
int gn_fwd_apply(const void* x, void* y, float* mean, float* inv, const float* sums,
                 const Vecs& vv, int N, int HW, int total, int C, int G, float eps, int blocks,
                 int pixels, float* coef, cudaStream_t s) {
  gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(sums, 1, 2, 0, vv, mean, inv, coef, total, C, G,
                                               eps);
  gn_apply_kernel<E><<<dim3(blocks, N), 256, 0, s>>>(static_cast<const E*>(x), static_cast<E*>(y),
                                                      coef, HW, C, pixels);
  return (int)cudaGetLastError();
}

template <typename E>
int gn_bwd_sums(const void* x, const void* dz, const float* mean, const float* inv,
                const Vecs& vv, float* sums, float* part, int N, int HW, int C, int G, int blocks,
                int pixels, cudaStream_t s) {
  gn_partial_kernel<E, true><<<dim3(blocks, N), 256, 0, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(dz), mean, inv, vv, part, HW, C, G, pixels);
  gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part, blocks, 2, 2, vv, sums, nullptr, nullptr, HW,
                                               C, G, 0.f);
  return (int)cudaGetLastError();
}

template <typename E>
int gn_bwd_dx(const void* x, const void* dz, void* dx, float* dbias, const float* mean,
              const float* inv, const float* sums, const Vecs& vv, int N, int HW, int total, int C,
              int G, int blocks, int pixels, float* part2, float* coef, cudaStream_t s) {
  gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(sums, 1, 2, 1, vv, nullptr, nullptr, coef, total,
                                               C, G, 0.f);
  gn_dx_kernel<E><<<dim3(blocks, N), 256, 0, s>>>(
      static_cast<const E*>(x), static_cast<const E*>(dz), static_cast<E*>(dx), mean, inv, vv,
      coef, part2, HW, C, G, pixels);
  gn_finalize_kernel<<<N, 256, 6 * C * 4, s>>>(part2, blocks, 1, 2, vv, dbias, nullptr, nullptr,
                                               HW, C, G, 0.f);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype codes (ops/__init__.py:DTYPE_CODES): 0 f32, 1 fp16, 2 bf16.
//
// The plan's fields (ops/group_norm.py:gn_plan): `blocks` along a sample's
// pixels, `pixels` a block (the last may take fewer), `chunk` pixels a bulk
// copy, `threads` a block; two_pass == 0: one cluster of `blocks` (at most
// 8) per sample, each holding its pixels in shared memory; two_pass == 1:
// part holds N*blocks*2*C f32 and coef N*2*C f32 scratch (both null, and
// not read, in one pass). x, y: (N, HW, C) in the dtype, 16-byte aligned,
// C % 8 == 0, C % G == 0, C <= 8*threads; mean, inv: (N, G) f32 out.
// Returns a cudaError_t.
extern "C" int dmme_gn_silu_fwd(int dtype, const void* x, void* y, float* mean, float* inv,
                                const float* gamma, int sg, const float* beta, int sb,
                                const float* bias, int sp, int N, int HW, int C, int G,
                                float eps, int blocks, int pixels, int chunk, int threads,
                                int two_pass, float* part, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vecs vv{gamma, beta, bias, sg, sb, sp};
  switch (dtype) {
    case 0:
      return gn_fwd<float>(x, y, mean, inv, vv, N, HW, C, G, eps, blocks, pixels, chunk,
                           threads, two_pass, part, coef, s);
    case 1:
      return gn_fwd<__half>(x, y, mean, inv, vv, N, HW, C, G, eps, blocks, pixels, chunk,
                            threads, two_pass, part, coef, s);
    case 2:
      return gn_fwd<bf16>(x, y, mean, inv, vv, N, HW, C, G, eps, blocks, pixels, chunk,
                          threads, two_pass, part, coef, s);
  }
  return (int)cudaErrorInvalidValue;
}

// K2: x, dz, dx (N, HW, C) in the dtype; mean, inv (N, G) f32 from K1;
// dgamma, dbeta, dbias (N, C) f32 out. Two passes: part holds N*blocks*2*C
// f32, part2 N*blocks*C and coef N*2*C (all null in one pass).
extern "C" int dmme_gn_silu_bwd(int dtype, const void* x, const void* dz, void* dx,
                                float* dgamma, float* dbeta, float* dbias, const float* mean,
                                const float* inv, const float* gamma, int sg, const float* beta,
                                int sb, const float* bias, int sp, int N, int HW, int C, int G,
                                int blocks, int pixels, int chunk, int threads, int two_pass,
                                float* part, float* part2, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vecs vv{gamma, beta, bias, sg, sb, sp};
  switch (dtype) {
    case 0:
      return gn_bwd<float>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, vv, N, HW, C, G, blocks,
                           pixels, chunk, threads, two_pass, part, part2, coef, s);
    case 1:
      return gn_bwd<__half>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, vv, N, HW, C, G, blocks,
                            pixels, chunk, threads, two_pass, part, part2, coef, s);
    case 2:
      return gn_bwd<bf16>(x, dz, dx, dgamma, dbeta, dbias, mean, inv, vv, N, HW, C, G, blocks,
                          pixels, chunk, threads, two_pass, part, part2, coef, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The split entries (H-shards of the spatial mesh axis; see gn_fwd_sums
// above). x, y, dz, dx: the shard's (N, HW, C) in the dtype, 16-byte
// aligned, C % 8 == 0, C <= 2048, C % G == 0; `total` the whole sample's
// pixels (HW times the group's size); sums (N, 2C) f32; part N*blocks*2*C,
// part2 N*blocks*C and coef N*2*C f32 scratch. Each returns a cudaError_t.
extern "C" int dmme_gn_silu_fwd_sums(int dtype, const void* x, float* sums, float* part, int N,
                                     int HW, int C, int blocks, int pixels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return gn_fwd_sums<float>(x, sums, part, N, HW, C, blocks, pixels, s);
    case 1: return gn_fwd_sums<__half>(x, sums, part, N, HW, C, blocks, pixels, s);
    case 2: return gn_fwd_sums<bf16>(x, sums, part, N, HW, C, blocks, pixels, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dmme_gn_silu_fwd_apply(int dtype, const void* x, void* y, float* mean, float* inv,
                                      const float* sums, const float* gamma, int sg,
                                      const float* beta, int sb, const float* bias, int sp, int N,
                                      int HW, int total, int C, int G, float eps, int blocks,
                                      int pixels, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vecs vv{gamma, beta, bias, sg, sb, sp};
  switch (dtype) {
    case 0:
      return gn_fwd_apply<float>(x, y, mean, inv, sums, vv, N, HW, total, C, G, eps, blocks,
                                 pixels, coef, s);
    case 1:
      return gn_fwd_apply<__half>(x, y, mean, inv, sums, vv, N, HW, total, C, G, eps, blocks,
                                  pixels, coef, s);
    case 2:
      return gn_fwd_apply<bf16>(x, y, mean, inv, sums, vv, N, HW, total, C, G, eps, blocks,
                                pixels, coef, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dmme_gn_silu_bwd_sums(int dtype, const void* x, const void* dz, const float* mean,
                                     const float* inv, const float* gamma, int sg,
                                     const float* beta, int sb, const float* bias, int sp,
                                     float* sums, float* part, int N, int HW, int C, int G,
                                     int blocks, int pixels, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vecs vv{gamma, beta, bias, sg, sb, sp};
  switch (dtype) {
    case 0:
      return gn_bwd_sums<float>(x, dz, mean, inv, vv, sums, part, N, HW, C, G, blocks, pixels, s);
    case 1:
      return gn_bwd_sums<__half>(x, dz, mean, inv, vv, sums, part, N, HW, C, G, blocks, pixels, s);
    case 2:
      return gn_bwd_sums<bf16>(x, dz, mean, inv, vv, sums, part, N, HW, C, G, blocks, pixels, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" int dmme_gn_silu_bwd_dx(int dtype, const void* x, const void* dz, void* dx,
                                   float* dbias, const float* mean, const float* inv,
                                   const float* sums, const float* gamma, int sg,
                                   const float* beta, int sb, const float* bias, int sp, int N,
                                   int HW, int total, int C, int G, int blocks, int pixels,
                                   float* part2, float* coef, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Vecs vv{gamma, beta, bias, sg, sb, sp};
  switch (dtype) {
    case 0:
      return gn_bwd_dx<float>(x, dz, dx, dbias, mean, inv, sums, vv, N, HW, total, C, G, blocks,
                              pixels, part2, coef, s);
    case 1:
      return gn_bwd_dx<__half>(x, dz, dx, dbias, mean, inv, sums, vv, N, HW, total, C, G, blocks,
                               pixels, part2, coef, s);
    case 2:
      return gn_bwd_dx<bf16>(x, dz, dx, dbias, mean, inv, sums, vv, N, HW, total, C, G, blocks,
                             pixels, part2, coef, s);
  }
  return (int)cudaErrorInvalidValue;
}
