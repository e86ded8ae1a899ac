// Fused ResBlock forward for Hopper (sm_90a): bf16, fp16 and f32 activations.
//
// Replaces the TPU kernel dmme_tpu/ops/resblock.py:_resblock_kernel (reached
// through resblock_forward), which keeps a whole batch block resident in
// VMEM for
//   h0 = silu(GN1(x));  h1 = conv3x3(h0) + b1;  h2 = silu(GN2(h1 + pre2)*g2 + b2v)
//   out = conv3x3(h2) + b2 + (x | x.Wr + br)
// One 32x32x128 bf16 sample is 256 KB, more than the 227 KB of shared
// memory a block can hold, so that residency does not map. The block runs
// instead as four launches on one stream:
//   1. gn_silu  : per (sample, group), the group held in shared memory: its
//                 f32 statistics, then h0 = E(silu(x*a + d)) written once
//                 (NHWC; E the activations' type). The TPU kernel rounds h0
//                 to the compute dtype before the conv, as here.
//   2. conv     : conv1 as an implicit GEMM over h0, M = N*H*W pixels,
//                 K = 9*C_in, N = C_out; + b1 in the epilogue; h1 in f32.
//   3. gn_silu  : GN2 of h1 + pre2 (the pre-bias folded into the channel
//                 sums), h2 = E(silu(.)) written once. Where conv1 is
//                 split over K, this pass sums its f32 slices (in slice
//                 order, then + b1) as it reads them: no separate sum.
//   4. conv     : conv2 over h2, + b2 and the skip in the epilogue: the
//                 identity added in f32, or the 1x1 projection, which
//                 continues the same accumulation over unshifted x tiles.
// Separate statistics passes (not atomics) keep the result the same on
// every run.
//
// The conv kernel (conv_wgmma_kernel) is warp-specialised. One producer
// thread keeps a ring of STAGES shared-memory stages filled by TMA under
// mbarriers; per 64-deep K step a stage holds
//   A: BM pixels x 64 channels (16-bit; 32 in f32) of one tap, a 4-D box of the
//      NHWC operand at coordinates shifted by the tap. TMA's zero fill
//      outside the image is exactly the TPU kernel's zero padding after the
//      SiLU;
//   B: 128 output channels x the same K of the packed weights,
//      (C_out, 9*C_in [+ C_in]) K-major.
// Both land in the 128-byte swizzle, which is the layout wgmma reads. One or
// two consumer warpgroups (BM = 64 or 128) run wgmma m64n128 with f32
// accumulators in registers and keep one K step in flight while the next
// waits. The epilogue stays in registers: bias, the skip, two-element
// stores. Where the output tiles are fewer than the SMs, the K steps are
// split over blockIdx.z: each slice writes its f32 partial tile, and the
// slices are summed in a fixed order, so the result does not depend on
// scheduling: conv1's by the GN2 pass as it reads them, conv2's by one more
// launch that also applies the epilogue. The tile, the boxes and the split
// are planned in ops/resblock.py:conv_plan.
//
// Shapes: any C_in and C_out that are multiples of 8, any H x W. A channel
// count that is not a multiple of the K step ends in a partial K step:
// the activation box reads zeros past C, so the weights in those K columns
// (the next tap's, or zeros past K) multiply zeros. An output-channel tile
// past C_out reads zero weights and is not stored. An M tile is one TMA box
// of (bn images, bh rows, bw columns): in raster order (whole rows or whole
// images) where the shape allows, else a spatial tile that may reach past
// the image, whose pixels outside it read zeros and are not stored.
//
// fp16 runs the same code (the element type E a template parameter): the
// GN passes write fp16, the TMA maps say FLOAT16 and the wgmmas .f16.
//
// f32 runs on the tensor cores as 3xTF32: x = hi + lo with hi = tf32(x) and
// lo = tf32(x - hi) (hopper::tf32_split), each product hi*hi + hi*lo +
// lo*hi accumulated in f32, about 2^-21 relative error a product where one
// tf32 product keeps 2^-11. The split costs nothing in the main loop: the
// GN passes write h0 and h2 as a hi plane and a lo plane of f32 (tf32 bits),
// the GN1 pass also writes x's planes where the 1x1 projection reads x, and
// the wrapper packs the weights as W_hi and W_lo once per weight state.
// wgmma m64n128k8 .tf32 takes both operands K-major from shared memory, as
// the NHWC activations and the packed weights already are; a K step is 32
// channels (128 bytes a row, the same swizzle and descriptor steps as 64
// 16-bit channels), and a stage holds the hi and lo planes of A and of B:
// 48 KB at 64 pixels (4 stages), 64 KB at 128 (3 stages). Each K step
// issues three wgmmas per 8 channels, the small products first.
//
// Bound: operations. At the UNet's shapes a ResBlock does 2*M*C_out*
// (9*C_in + 9*C_out [+ C_in]) operations on a few MB, well above the ~295
// operations per byte of the H100's 16-bit tensor cores; in f32, three
// tf32 products each at 495 TFLOP/s.

#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr int GN_THREADS = 256;
constexpr int BN = 128;

template <typename E>
constexpr bool is_f32 = std::is_same_v<E, float>;
// channels a K step: one 128-byte swizzle row of E
template <typename E>
constexpr int BK = 128 / (int)sizeof(E);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<bf16>(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack2<__half>(a, b);
}

// Per (sample, group): mean and inverse std of u = src + bias, as
// E[u^2] - E[u]^2 from per-channel sums with the bias folded in; then
// dst = E(silu(src*a + d)) with a = inv*gamma, d = beta + (bias - mean)*
// inv*gamma, so that GN(u)*gamma + beta = src*a + d. For E = f32, dst and
// dst_lo take the tf32 halves of silu(.), and where x_hi is given the
// halves of src itself go to x_hi and x_lo (GN1: the projection's x).
// HOLD: the group stays in shared memory between the two steps (HW x C/G
// floats); else (a group larger than shared memory) the second step reads
// src again. The sums go thread by thread (channel tid % cg, pixels tid / cg
// + k * step, the first step * cg threads taking part), then per channel in
// thread order, then over the group's channels in order. Requires C/G <=
// GN_THREADS. bias, gamma and beta are (N, C) rows apart by their own
// stride: C for a per-sample vector, 0 for one shared by the batch. SLICES:
// src holds `slices` f32 split-K slices `slice` floats apart, summed in
// order, then + src_bias[c].
template <typename T, typename E, bool SLICES, bool HOLD>
__global__ void __launch_bounds__(GN_THREADS)
gn_silu_kernel(const T* __restrict__ src, int slices, size_t slice,
               const float* __restrict__ src_bias, const float* __restrict__ bias, int s_bias,
               const float* __restrict__ gamma, int s_gamma, const float* __restrict__ beta,
               int s_beta, E* __restrict__ dst, float* __restrict__ dst_lo,
               float* __restrict__ x_hi, float* __restrict__ x_lo, int HW, int C, int G,
               float eps) {
  extern __shared__ float held[];
  __shared__ float sh_s[GN_THREADS], sh_q[GN_THREADS];
  __shared__ float ch_u[GN_THREADS], ch_uq[GN_THREADS];
  __shared__ float sh_mean, sh_inv;
  const int g = blockIdx.x, n = blockIdx.y, tid = threadIdx.x;
  const int cg = C / G, step = GN_THREADS / cg, active = step * cg;
  const int c = g * cg + tid % cg;
  const size_t base = (size_t)n * HW * C + c;
  auto value = [&](int p) {
    const size_t e = base + (size_t)p * C;
    float v = to_f32(src[e]);
    if constexpr (SLICES) {
      for (int z = 1; z < slices; ++z) v += to_f32(src[z * slice + e]);
      v += src_bias[c];
    }
    return v;
  };
  float s = 0.f, q = 0.f;
  // this thread's pixels p = tid/cg + k*step sit at held[p*cg + tid%cg]
  if (tid < active) {
    for (int p = tid / cg, i = tid; p < HW; p += step, i += active) {
      const float v = value(p);
      if constexpr (HOLD) held[i] = v;
      s += v;
      q += v * v;
    }
  }
  sh_s[tid] = s;
  sh_q[tid] = q;
  __syncthreads();
  const float b = bias ? bias[n * s_bias + c] : 0.f;
  if (tid < cg) {
    float cs = 0.f, cq = 0.f;
    for (int j = tid; j < active; j += cg) {
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
    sh_mean = mean;
    sh_inv = rsqrtf(gq / cnt - mean * mean + eps);
  }
  __syncthreads();
  const float gm = gamma[n * s_gamma + c];
  const float a = sh_inv * gm;
  const float d = beta[n * s_beta + c] + (b - sh_mean) * sh_inv * gm;
  if (tid >= active) return;
  for (int p = tid / cg, i = tid; p < HW; p += step, i += active) {
    float v;
    if constexpr (HOLD)
      v = held[i];
    else
      v = value(p);
    const float y = v * a + d;
    const float z = y / (1.f + expf(-y));
    const size_t e = base + (size_t)p * C;
    if constexpr (is_f32<E>) {
      float hi, lo;
      tf32_split(z, hi, lo);
      dst[e] = hi;
      dst_lo[e] = lo;
      if (x_hi) {
        tf32_split(v, hi, lo);
        x_hi[e] = hi;
        x_lo[e] = lo;
      }
    } else if constexpr (std::is_same_v<E, __half>) {
      dst[e] = __float2half_rn(z);
    } else {
      dst[e] = __float2bfloat16(z);
    }
  }
}

struct ConvArgs {
  int N, H, W, M, Cout;
  int bn, bh, bw;  // the M tile's TMA box: images, rows, columns
  int C1;          // channels of the conv input
  int csteps;      // K-step chunks of channels per tap of the conv input (the last may be partial)
  int conv_steps;  // 9 * csteps
  int total;       // K steps: conv_steps, plus ceil(C0 / BK) of the 1x1 projection
  int per;         // K steps per split slice
  const float* bias;
  const void* x;  // the block input in E (identity skip)
  int C0;         // its channels (the projection's K)
  void* out;
  float* partial;  // splits x M x Cout f32 when split
};

// A stage: A (BM pixels x one 128-byte row) and B (BN output channels x one
// row), each a hi and a lo plane in f32 (tf32 halves)
template <int NWG, typename E>
struct ConvSmem {
  static constexpr int PLANES = is_f32<E> ? 2 : 1;
  static constexpr int A_PLANE = 64 * NWG * 128, B_PLANE = BN * 128;
  static constexpr int A = PLANES * A_PLANE, B = PLANES * B_PLANE;
  static constexpr int STAGE = A + B;
  static constexpr int STAGES = PLANES == 2 && NWG == 2 ? 3 : 4;
  // alignment slack, the ring, full and empty barriers
  static constexpr int BYTES = 1024 + STAGES * STAGE + 2 * STAGES * 8;
};

// One (BM x 128) output tile over the K steps [z*per, (z+1)*per) of slice
// z = blockIdx.z. Warpgroups 0..NWG-1 consume (64 rows each), warpgroup NWG
// produces. tm_h: the conv input (N, H, W, C1) in E, box (BK, bw, bh, bn);
// tm_x: the block input, same box (projection steps); tm_w: the packed
// weights (Cout, K) in E, box (BK, 128). For E = f32 these are the hi
// planes, and tm_hl, tm_xl, tm_wl the lo planes (unused otherwise).
// out = acc + bias [+ x] (RESID).
template <int NWG, typename E, typename TOut, bool RESID>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
conv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_h,
                  const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_w,
                  const __grid_constant__ CUtensorMap tm_hl,
                  const __grid_constant__ CUtensorMap tm_xl,
                  const __grid_constant__ CUtensorMap tm_wl, const ConvArgs args) {
  using S = ConvSmem<NWG, E>;
  constexpr int STAGES = S::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // TMA's 128-byte swizzle wants 1024-byte aligned tiles
  unsigned char* smem =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + STAGES * S::STAGE);
  uint64_t* empty = full + STAGES;
  const int tid = threadIdx.x, wg = tid / 128;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the tile's box: images from img0, rows from y0, columns from x0
  const int tiles_x = (args.W + args.bw - 1) / args.bw, tiles_y = (args.H + args.bh - 1) / args.bh;
  const int ix = blockIdx.x % tiles_x, iy = (blockIdx.x / tiles_x) % tiles_y;
  const int img0 = blockIdx.x / (tiles_x * tiles_y) * args.bn;
  const int y0 = iy * args.bh, x0 = ix * args.bw;
  const int n0 = blockIdx.y * BN;
  const int s_begin = blockIdx.z * args.per;
  const int s_end = min(args.total, s_begin + args.per);

  if (wg == NWG) {
    // producer: one thread keeps the ring full
    if (tid == NWG * 128) {
      tma_prefetch_map(&tm_h);
      tma_prefetch_map(&tm_w);
      int stage = 0;
      uint32_t phase = 0;
      for (int s = s_begin; s < s_end; ++s) {
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* a = smem + stage * S::STAGE;
        mbar_arrive_expect_tx(&full[stage], S::STAGE);
        // the step's activation map, coordinates and first column of the packed weights
        const CUtensorMap *act = &tm_h, *act_lo = &tm_hl;
        int c, xx = x0, yy = y0, k;
        if (s < args.conv_steps) {
          const int tap = s / args.csteps;
          c = (s - tap * args.csteps) * BK<E>;
          xx += tap % 3 - 1;
          yy += tap / 3 - 1;
          k = tap * args.C1 + c;
        } else {
          act = &tm_x;
          act_lo = &tm_xl;
          c = (s - args.conv_steps) * BK<E>;
          k = 9 * args.C1 + c;
        }
        tma_load_4d(a, act, &full[stage], c, xx, yy, img0);
        tma_load_2d(a + S::A, &tm_w, &full[stage], k, n0);
        if constexpr (S::PLANES == 2) {
          tma_load_4d(a + S::A_PLANE, act_lo, &full[stage], c, xx, yy, img0);
          tma_load_2d(a + S::A + S::B_PLANE, &tm_wl, &full[stage], k, n0);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64*wg, 64*wg + 64) of the tile
  const int warp = (tid % 128) / 32, lane = tid % 32;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  fence_regs(acc);
  int stage = 0, prev = -1;
  uint32_t phase = 0;
  for (int s = s_begin; s < s_end; ++s) {
    mbar_wait(&full[stage], phase);
    const unsigned char* tile = smem + stage * S::STAGE;
    const uint64_t da = sw128_desc(tile + wg * 64 * 128), db = sw128_desc(tile + S::A);
    wgmma_fence();
    if constexpr (S::PLANES == 2) {  // 3xTF32, 8 channels (32 bytes) a wgmma
      const uint64_t dal = sw128_desc(tile + S::A_PLANE + wg * 64 * 128);
      const uint64_t dbl = sw128_desc(tile + S::A + S::B_PLANE);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_ss_tf32(acc, dal + 2 * kk, db + 2 * kk);
        wgmma_ss_tf32(acc, da + 2 * kk, dbl + 2 * kk);
        wgmma_ss_tf32(acc, da + 2 * kk, db + 2 * kk);
      }
    } else {  // 16 channels (32 bytes) a wgmma
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_ss<E>(acc, da + 2 * kk, db + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's products are done: release its stage
    if (prev >= 0) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[prev]);
    }
    prev = stage;
    if (++stage == STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j + 2h + e]: row 16*warp + lane/4 + 8h, column 8j + 2*(lane%4) + e;
  // tile row r is pixel (img0 + r / (bh*bw), y0 + r / bw % bh, x0 + r % bw)
  const int row = wg * 64 + warp * 16 + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
  TOut* out = static_cast<TOut*>(args.out);
  const E* x = static_cast<const E*>(args.x);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row + 8 * h;
    const int img = img0 + r / (args.bh * args.bw), y = y0 + r / args.bw % args.bh,
              xc = x0 + r % args.bw;
    if (img >= args.N || y >= args.H || xc >= args.W) continue;
    const int m = (img * args.H + y) * args.W + xc;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int co = col + 8 * j;
      if (co >= args.Cout) continue;
      const float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (gridDim.z > 1) {
        store2(args.partial + ((size_t)blockIdx.z * args.M + m) * args.Cout + co, v0, v1);
      } else {
        float r0 = v0 + args.bias[co], r1 = v1 + args.bias[co + 1];
        if (RESID) {
          const float2 xv = load2(x + (size_t)m * args.C0 + co);
          r0 += xv.x;
          r1 += xv.y;
        }
        store2(out + (size_t)m * args.Cout + co, r0, r1);
      }
    }
  }
}

// Sums conv2's split-K slices in slice order, then the same epilogue. Four
// consecutive outputs a thread.
template <typename E, bool RESID>
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float* __restrict__ partial, int splits,
                     const float* __restrict__ bias, const E* __restrict__ x, int C0,
                     E* __restrict__ out, int M, int Cout) {
  const size_t total = (size_t)M * Cout;
  const size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (e >= total) return;
  const int co = e % Cout;
  const size_t m = e / Cout;
  float4 acc = *reinterpret_cast<const float4*>(partial + e);
  for (int z = 1; z < splits; ++z) {
    const float4 p = *reinterpret_cast<const float4*>(partial + z * total + e);
    acc.x += p.x;
    acc.y += p.y;
    acc.z += p.z;
    acc.w += p.w;
  }
  float r[4] = {acc.x + bias[co], acc.y + bias[co + 1], acc.z + bias[co + 2],
                acc.w + bias[co + 3]};
  if (RESID) {
#pragma unroll
    for (int i = 0; i < 4; ++i) r[i] += to_f32(x[m * C0 + co + i]);
  }
  store2(out + e, r[0], r[1]);
  store2(out + e + 2, r[2], r[3]);
}

// ------------------------------------------------------------------ host

// NHWC activations in E with C channels, read in boxes of BK<E> channels x
// bw x bh x bn pixels; taps outside the image read zeros
template <typename E>
bool act_map(CUtensorMap* map, const void* ptr, int N, int H, int W, int C, int bw, int bh,
             int bn) {
  constexpr cuuint64_t B = sizeof(E);
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)C * B, (cuuint64_t)W * C * B,
                                 (cuuint64_t)H * W * C * B};
  const cuuint32_t box[4] = {(cuuint32_t)BK<E>, (cuuint32_t)bw, (cuuint32_t)bh, (cuuint32_t)bn};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, tma_type<E>(), 4, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// packed weights (Cout, K) in E, read in boxes of BK<E> K x 128 output channels
template <typename E>
bool weight_map(CUtensorMap* map, const void* ptr, int Cout, int K) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)Cout};
  const cuuint64_t strides[1] = {(cuuint64_t)K * sizeof(E)};
  const cuuint32_t box[2] = {(cuuint32_t)BK<E>, (cuuint32_t)BN};
  const cuuint32_t unit[2] = {1, 1};
  return encode_tiled()(map, tma_type<E>(), 2, const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the group held in shared memory up to this many bytes, beside the
// kernel's 8 KB of static shared memory
constexpr size_t GN_HOLD_MAX = 200 * 1024;

// src holds `slices` slices (slice_bias added after their sum) when SLICES
template <typename T, typename E, bool SLICES>
cudaError_t gn_silu(cudaStream_t s, const T* src, int slices, const float* slice_bias,
                    const float* bias, int s_bias, const float* gamma, int s_gamma,
                    const float* beta, int s_beta, E* dst, float* dst_lo, float* x_hi,
                    float* x_lo, int N, int HW, int C, int G, float eps) {
  const dim3 grid(G, N);
  const size_t slice = (size_t)N * HW * C;
  const size_t held = (size_t)HW * (C / G) * sizeof(float);
  if (held > GN_HOLD_MAX) {
    gn_silu_kernel<T, E, SLICES, false><<<grid, GN_THREADS, 0, s>>>(
        src, slices, slice, slice_bias, bias, s_bias, gamma, s_gamma, beta, s_beta, dst, dst_lo,
        x_hi, x_lo, HW, C, G, eps);
    return cudaSuccess;
  }
  static int limits[64];
  const cudaError_t err = allow_smem(gn_silu_kernel<T, E, SLICES, true>, (int)held, limits);
  if (err != cudaSuccess) return err;
  gn_silu_kernel<T, E, SLICES, true><<<grid, GN_THREADS, held, s>>>(
      src, slices, slice, slice_bias, bias, s_bias, gamma, s_gamma, beta, s_beta, dst, dst_lo,
      x_hi, x_lo, HW, C, G, eps);
  return cudaSuccess;
}

// the tensor maps of one conv: input, block input, weights; their lo planes
struct ConvMaps {
  CUtensorMap h, x, w, hl, xl, wl;
};

// One conv launch over `splits` K slices
template <int NWG, typename E, typename TOut, bool RESID>
cudaError_t conv(cudaStream_t s, const ConvMaps& t, const ConvArgs& a, int splits) {
  using S = ConvSmem<NWG, E>;
  static int limits[64];
  const cudaError_t err = allow_smem(conv_wgmma_kernel<NWG, E, TOut, RESID>, S::BYTES, limits);
  if (err != cudaSuccess) return err;
  const int m_tiles = (a.N + a.bn - 1) / a.bn * ((a.H + a.bh - 1) / a.bh) *
                      ((a.W + a.bw - 1) / a.bw);
  const dim3 grid(m_tiles, (a.Cout + BN - 1) / BN, splits);
  conv_wgmma_kernel<NWG, E, TOut, RESID><<<grid, 128 * (NWG + 1), S::BYTES, s>>>(
      t.h, t.x, t.w, t.hl, t.xl, t.wl, a);
  return cudaSuccess;
}

// conv2: the conv, then, where split, the launch that sums its slices and
// applies the epilogue
template <typename E, bool RESID>
cudaError_t conv2(int bm, cudaStream_t s, const ConvMaps& t, const ConvArgs& a, int splits) {
  const cudaError_t err = bm == 128 ? conv<2, E, E, RESID>(s, t, a, splits)
                                    : conv<1, E, E, RESID>(s, t, a, splits);
  if (err != cudaSuccess || splits == 1) return err;
  splitk_reduce_kernel<E, RESID><<<(a.M * a.Cout / 4 + 255) / 256, 256, 0, s>>>(
      a.partial, splits, a.bias, static_cast<const E*>(a.x), a.C0, static_cast<E*>(a.out), a.M,
      a.Cout);
  return cudaSuccess;
}

// The four or five launches of one ResBlock in E. For E = f32, h and h_lo
// are the hi and lo planes of h0 and h2, x_hi and x_lo those of x (null
// without the projection), w1_lo and w2_lo the weights' lo planes; all
// null for 16-bit E.
template <typename E>
int resblock_fwd(const void* x, const float* g1, const float* b1v, const float* pre2,
                 const float* g2, const float* b2v, const void* w1, const void* w1_lo,
                 const float* b1, const void* w2, const void* w2_lo, const float* b2,
                 int has_proj, void* h, float* h_lo, float* x_hi, float* x_lo, float* h1,
                 float* partial, void* out, int N, int H, int W, int Cin, int Cout, int G, int bm,
                 int box_n, int box_h, int box_w, int splits1, int per1, int splits2, int per2,
                 int sg1, int sb1, int sp2, int sg2, int sb2, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  if (is_f32<E> && !(h_lo && w1_lo && w2_lo && (!has_proj || (x_hi && x_lo))))
    return (int)cudaErrorInvalidValue;
  const int HW = H * W, M = N * HW;
  const E* xe = static_cast<const E*>(x);
  E* he = static_cast<E*>(h);
  // the projection reads x's planes in f32, x itself in 16 bits (without
  // the projection the map is not read: x stands in)
  const void* xa = is_f32<E> && has_proj ? static_cast<const void*>(x_hi) : x;
  ConvMaps t1, t2;
  const int k2 = 9 * Cout + (has_proj ? Cin : 0);
  bool ok = act_map<E>(&t1.h, h, N, H, W, Cin, box_w, box_h, box_n) &&
            act_map<E>(&t2.h, h, N, H, W, Cout, box_w, box_h, box_n) &&
            act_map<E>(&t2.x, xa, N, H, W, Cin, box_w, box_h, box_n) &&
            weight_map<E>(&t1.w, w1, Cout, 9 * Cin) && weight_map<E>(&t2.w, w2, Cout, k2);
  if constexpr (is_f32<E>) {
    ok = ok && act_map<E>(&t1.hl, h_lo, N, H, W, Cin, box_w, box_h, box_n) &&
         act_map<E>(&t2.hl, h_lo, N, H, W, Cout, box_w, box_h, box_n) &&
         act_map<E>(&t2.xl, has_proj ? x_lo : h_lo, N, H, W, Cin, box_w, box_h, box_n) &&
         weight_map<E>(&t1.wl, w1_lo, Cout, 9 * Cin) && weight_map<E>(&t2.wl, w2_lo, Cout, k2);
  } else {
    t1.hl = t1.h;
    t1.wl = t1.w;
    t2.hl = t2.h;
    t2.xl = t2.x;
    t2.wl = t2.w;
  }
  t1.x = t1.h;
  t1.xl = t1.hl;
  if (!ok) return (int)cudaErrorInvalidValue;

  cudaError_t err = gn_silu<E, E, false>(s, xe, 1, nullptr, nullptr, 0, g1, sg1, b1v, sb1, he,
                                         h_lo, has_proj ? x_hi : nullptr, x_lo, N, HW, Cin, G,
                                         eps);
  if (err != cudaSuccess) return (int)err;
  const int cs1 = (Cin + BK<E> - 1) / BK<E>, cs2 = (Cout + BK<E> - 1) / BK<E>;
  ConvArgs a1{N, H, W, M, Cout, box_n, box_h, box_w, Cin, cs1, 9 * cs1, 9 * cs1, per1, b1,
              nullptr, Cin, h1, partial};
  err = bm == 128 ? conv<2, E, float, false>(s, t1, a1, splits1)
                  : conv<1, E, float, false>(s, t1, a1, splits1);
  if (err != cudaSuccess) return (int)err;
  err = splits1 > 1
            ? gn_silu<float, E, true>(s, partial, splits1, b1, pre2, sp2, g2, sg2, b2v, sb2, he,
                                      h_lo, nullptr, nullptr, N, HW, Cout, G, eps)
            : gn_silu<float, E, false>(s, h1, 1, nullptr, pre2, sp2, g2, sg2, b2v, sb2, he, h_lo,
                                       nullptr, nullptr, N, HW, Cout, G, eps);
  if (err != cudaSuccess) return (int)err;
  ConvArgs a2{N, H, W, M, Cout, box_n, box_h, box_w, Cout, cs2, 9 * cs2,
              9 * cs2 + (has_proj ? cs1 : 0), per2, b2, x, Cin, out, partial};
  err = has_proj ? conv2<E, false>(bm, s, t2, a2, splits2)
                 : conv2<E, true>(bm, s, t2, a2, splits2);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// x: (N, H, W, Cin) in the activations' dtype: bf16 (dmme_resblock_fwd) or
// fp16 (dmme_resblock_fwd_f16); g1, b1v: (N, Cin) f32; pre2, g2, b2v:
// (N, Cout) f32, rows sg1, sb1, sp2, sg2, sb2 floats apart (0: one row for
// the whole batch); w1: (Cout, 9*Cin) in x's dtype, K ordered (dy, dx,
// c_in); b1: (Cout) f32; w2: (Cout, 9*Cout [+ Cin]), the projection's
// (Cout, Cin) appended when has_proj; b2: (Cout) f32, the projection's bias
// already added. The plan (ops/resblock.py:conv_plan): bm = 64 or 128
// output pixels a tile, the pixel box (box_n, box_h, box_w) of one tile (bm
// pixels), and per conv its split-K slices and K steps per slice.
// Scratch: h (N*H*W*max(Cin, Cout)) in x's dtype; h1 (N*H*W*Cout) f32, null
// when conv1 is split; partial (max(splits)*N*H*W*Cout) f32, null when both
// are 1. out: (N, H, W, Cout) in x's dtype. Four launches, plus one if conv2
// is split. Cin and Cout are multiples of 8, C/G <= 256. Returns a
// cudaError_t.
extern "C" int dmme_resblock_fwd(const void* x, const float* g1, const float* b1v,
                                 const float* pre2, const float* g2, const float* b2v,
                                 const void* w1, const float* b1, const void* w2,
                                 const float* b2, int has_proj, void* h, float* h1,
                                 float* partial, void* out, int N, int H, int W, int Cin,
                                 int Cout, int G, int bm, int box_n, int box_h, int box_w,
                                 int splits1, int per1, int splits2, int per2, int sg1, int sb1,
                                 int sp2, int sg2, int sb2, float eps, void* stream) {
  return resblock_fwd<bf16>(x, g1, b1v, pre2, g2, b2v, w1, nullptr, b1, w2, nullptr, b2,
                            has_proj, h, nullptr, nullptr, nullptr, h1, partial, out, N, H, W,
                            Cin, Cout, G, bm, box_n, box_h, box_w, splits1, per1, splits2, per2,
                            sg1, sb1, sp2, sg2, sb2, eps, stream);
}

extern "C" int dmme_resblock_fwd_f16(const void* x, const float* g1, const float* b1v,
                                     const float* pre2, const float* g2, const float* b2v,
                                     const void* w1, const float* b1, const void* w2,
                                     const float* b2, int has_proj, void* h, float* h1,
                                     float* partial, void* out, int N, int H, int W, int Cin,
                                     int Cout, int G, int bm, int box_n, int box_h, int box_w,
                                     int splits1, int per1, int splits2, int per2, int sg1,
                                     int sb1, int sp2, int sg2, int sb2, float eps,
                                     void* stream) {
  return resblock_fwd<__half>(x, g1, b1v, pre2, g2, b2v, w1, nullptr, b1, w2, nullptr, b2,
                              has_proj, h, nullptr, nullptr, nullptr, h1, partial, out, N, H, W,
                              Cin, Cout, G, bm, box_n, box_h, box_w, splits1, per1, splits2,
                              per2, sg1, sb1, sp2, sg2, sb2, eps, stream);
}

// f32: as above with x, h, out and the weights f32, and 3xTF32 operands: w1
// and w2 the weights' tf32 hi planes and w1_lo, w2_lo their lo planes
// (ops/resblock.py:tf32_split); h and h_lo (N*H*W*max(Cin, Cout) each) take
// the hi and lo planes of h0 and h2; x_hi and x_lo (N*H*W*Cin each) those
// of x where has_proj, else null.
extern "C" int dmme_resblock_fwd_f32(const void* x, const float* g1, const float* b1v,
                                     const float* pre2, const float* g2, const float* b2v,
                                     const void* w1, const void* w1_lo, const float* b1,
                                     const void* w2, const void* w2_lo, const float* b2,
                                     int has_proj, void* h, float* h_lo, float* x_hi,
                                     float* x_lo, float* h1, float* partial, void* out, int N,
                                     int H, int W, int Cin, int Cout, int G, int bm, int box_n,
                                     int box_h, int box_w, int splits1, int per1, int splits2,
                                     int per2, int sg1, int sb1, int sp2, int sg2, int sb2,
                                     float eps, void* stream) {
  return resblock_fwd<float>(x, g1, b1v, pre2, g2, b2v, w1, w1_lo, b1, w2, w2_lo, b2, has_proj,
                             h, h_lo, x_hi, x_lo, h1, partial, out, N, H, W, Cin, Cout, G, bm,
                             box_n, box_h, box_w, splits1, per1, splits2, per2, sg1, sb1, sp2,
                             sg2, sb2, eps, stream);
}
