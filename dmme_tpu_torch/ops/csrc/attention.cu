// Softmax attention forward for Hopper (sm_90a): bf16, fp16 and f32 in/out.
//
// Replaces the TPU kernel dmme_tpu/ops/attention.py:_attn_kernel (reached
// through _attention_pallas), which holds one whole (T x T) score tile per
// batch*head in VMEM. Here a block of one or two warpgroups (4 warps each)
// takes 64 queries a warpgroup of one (batch, head) and walks the keys in
// tiles with an online softmax, in the register layout of FlashAttention-3:
//   - S = Q K^T runs on wgmma with Q and the K tile read from shared memory
//     (K-major, 128-byte swizzle, D in 64-wide panels); S stays in registers;
//   - P = exp2(S*scale*log2(e) - m), one FMA into exp2, is rounded to the
//     16-bit type (the TPU kernel casts P to V's dtype) and repacked in
//     registers as the A operand of O += P V, a wgmma that reads the V tile
//     MN-major from shared memory, so neither S nor P touches shared memory;
//     the f32 output accumulator (D/2 floats a thread) and the running row
//     max and sum live in registers too;
//   - thread 0 loads Q once and the K and V tiles through TMA into a
//     two-stage ring under mbarriers, one instruction a tile per tensor (a
//     5-D box holds all of D's panels), and refills a stage as soon as the
//     block is past it, so tile j+1 lands while tile j is multiplied; tokens
//     past T read zeros;
//   - each warpgroup's 16-bit output tile is staged in its rows of the Q
//     buffer, in the same swizzle, and written by TMA stores: whole lines,
//     not scattered pairs;
//   - where the blocks are few and the key loop long, the key tiles are split
//     over blockIdx.z (the plan is ops/attention.py:attention_plan): each
//     split writes its f32 partial O with its row max and sum, and
//     attn_combine_kernel merges the splits in a fixed order, so a repeated
//     call gives the same bytes.
// Head dims: any multiple of 16 up to 256, and 512. A head dim that is not
// a multiple of 64 runs the kernel of the next of 64, 128, 192, 256 (DP):
// Q, K and V are then read by 4-D boxes of one 64-wide panel each over the
// true D, whose zero fill pads the last panel (zero columns add nothing to
// QK^T), and the TMA stores clip the padded output columns. D = 512 splits
// the output columns over two blocks (blockIdx.y = bh*2 + half): each
// contracts QK^T over all 512 and multiplies P by its 256 columns of V, so S
// and O stay within the D = 256 kernel's registers. The softmax scale is
// the caller's (the full-dim C^-0.5 of the UNet) in every case.
// Key tiles are 64 keys for D <= 128 and 32 for D > 128. A block is 64
// queries (one warpgroup) or, where the blocks fill the card (the plan
// picks), 128 (two warpgroups sharing each K and V tile, which halves the
// tiles fetched per query). An SM holds as many blocks as its shared memory
// allows, up to 16 warps: at D = 128 two 128-query blocks (97 KB each, 128
// registers a thread); at D = 256 two 64-query blocks (99 KB each), 8 warps,
// 2 a quadrant, so up to 255 registers (170 used). A producer warp would put
// 3 warps on a quadrant and cap registers at 168, which spills at D = 256.
//
// fp16 runs the same kernel (the element type E a template parameter): the
// TMA maps say FLOAT16, the wgmmas .f16, and P is rounded to fp16, V's
// dtype, as the TPU kernel rounds it.
//
// f32 (attn_tf32_kernel) runs on the tensor cores as 3xTF32: each operand
// x is split in registers into hi = tf32(x) and lo = tf32(x - hi), and each
// product is hi*hi + hi*lo + lo*hi, accumulated in f32, which keeps about
// 2^-21 of relative error per product where one tf32 product keeps 2^-11.
// tf32 wgmma takes only K-major shared operands, and V (contiguous along D)
// is MN-major for P V, so this kernel uses mma.sync m16n8k8: a block of 4
// warps takes 64 queries (16 a warp) and holds one f32 copy of the Q tile
// and a two-stage ring of K and V tiles in shared memory, loaded by
// cp.async (zeros past T and past the head dim), rows padded so that the
// fragment loads of a warp fall in distinct banks. Each thread loads its
// fragments and splits them itself. q, k and v are read in place either
// row-major (unit stride along D) or token-major (unit stride along T, the
// channel-major output an f32 convolution may give the qkv projection),
// the latter into transposed tiles (TRANS). P stays f32 (V's dtype) and
// goes from the score accumulator to the A fragment of P V without a
// shuffle: key 8i + 2t + e of the score fragment is taken as column t + 4e
// of the A fragment, and V's B fragment is read at the same keys. Keys a
// tile: 32; 16 token-major at D = 256 and 8 at D = 512 (shared memory). The
// online softmax, the key split and its merge are the 16-bit kernel's.
//
// Bound: at the UNet's shapes (T <= 256, D <= 256) the work is ~4*T*D
// operations per query against ~8*D bytes of q/k/v/o per token (2 bytes a
// value), far below the ~295 operations per byte where the 16-bit tensor
// cores become the limit, so the least time is that of the bytes: q, k and
// v read once, o written once. In f32 the three tf32 products a product
// make it operations (3 * 4*T*D per query at 495 TFLOP/s).
//
// q, k and v are addressed by (batch, token, head) strides with a unit
// stride along D, so the strided views of a packed qkv projection are read
// in place: their tensor maps carry the strides.

#include <math.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;
using namespace hopper;

namespace {

constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long sn, st, sh;
};
// the same with the head dim's stride: 1 (row-major) or, with a unit stride
// along the tokens, another
struct Strides4 {
  long long sn, st, sh, sd;
};

// D: head dim of Q and K (a multiple of 64); DV: the columns of V and O a
// block takes (D, or 256 of D = 512); NWG: warpgroups a block, 64 queries
// each, 16 a warp
template <int D, int DV, int NWG>
struct Tile {
  static constexpr int BQ = 64 * NWG, THREADS = 128 * NWG;
  static constexpr int BKV = D > 128 ? 32 : 64;  // keys a tile
  static constexpr int STAGES = 2;               // of (K, V)
  static constexpr int PANELS = D / 64;  // 64-wide column panels of the swizzle
  static constexpr int VPANELS = DV / 64;
  static constexpr int Q_PANEL = BQ * 128, KV_PANEL = BKV * 128;  // bytes
  static constexpr int Q_BYTES = PANELS * Q_PANEL, KV_BYTES = PANELS * KV_PANEL;
  static constexpr int V_BYTES = VPANELS * KV_PANEL;
  static constexpr int STAGE_BYTES = KV_BYTES + V_BYTES;
  // alignment slack, Q, the ring, barriers (Q, one per stage)
  static constexpr int SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + (1 + STAGES) * 8;
  // blocks an SM holds: as many as 228 KB of shared memory allow, up to 16 warps
  static constexpr int FIT = 233472 / (SMEM + 1024);
  static constexpr int BLOCKS = FIT < 4 / NWG ? FIT : 4 / NWG;
};

// E: __nv_bfloat16 or __half. tm_q, tm_k, tm_v: 5-D maps of (64 values, H,
// T, D/64 panels, N), boxes of one head's BQ (Q) or BKV (K, V) tokens with
// all panels (V: VPANELS), which land as [panel][token][64 values]; tm_o:
// the output, boxes of 64 tokens of one panel. With `pad` (a head dim that
// is not a multiple of 64) all four are 4-D maps of (D values, H, T, N) over
// the true head dim, with boxes of one 64-wide panel, loaded and stored
// panel by panel. `halves`: output column blocks a (batch, head), 2 for
// D = 512.
template <typename E, int D, int DV, int NWG>
__global__ void __launch_bounds__(Tile<D, DV, NWG>::THREADS, (Tile<D, DV, NWG>::BLOCKS))
attn_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_o,
                float* __restrict__ o_part, float2* __restrict__ ml_part, int H, int T,
                int kv_per_split, int pad, int halves, float scale_log2) {
  using TL = Tile<D, DV, NWG>;
  constexpr int BQ = TL::BQ, BKV = TL::BKV, STAGES = TL::STAGES;
  constexpr int NS = BKV / 8;  // score fragments (16 x 8) a warp
  constexpr int NO = DV / 8;   // output fragments (16 x 8) a warp
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ =
      reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                       ~uintptr_t(1023));
  unsigned char* sK = sQ + TL::Q_BYTES;            // [stage][panel][BKV tokens x 128 B]
  unsigned char* sV = sK + STAGES * TL::KV_BYTES;  // the same, VPANELS panels
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + STAGES * TL::V_BYTES);
  uint64_t* full = q_full + 1;  // [STAGES]

  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid / 128, warp = (tid / 32) % 4;  // warpgroup, warp in it
  const int q0 = blockIdx.x * BQ, bh = blockIdx.y / halves, n = bh / H, h = bh % H;
  const int v0 = (blockIdx.y % halves) * TL::VPANELS;  // first panel of V and O
  unsigned char* qa = sQ + wg * 64 * 128;  // this warpgroup's rows of each Q panel
  const int kv_tiles = (T + BKV - 1) / BKV;
  const int j0 = blockIdx.z * kv_per_split, j1 = min(kv_tiles, j0 + kv_per_split);
  // `panels` panels from `first` of one (batch, head)'s tokens from t0
  auto load = [&](unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int t0, int first,
                  int panels, int panel_bytes) {
    if (pad) {
      for (int p = 0; p < panels; ++p)
        tma_load_4d(dst + p * panel_bytes, map, bar, 64 * (first + p), h, t0, n);
    } else {
      tma_load_5d(dst, map, bar, 0, h, t0, first, n);
    }
  };
  auto load_kv = [&](int stage, int j) {  // K and V of key tile j
    mbar_arrive_expect_tx(&full[stage], TL::STAGE_BYTES);
    load(sK + stage * TL::KV_BYTES, &tm_k, &full[stage], j * BKV, 0, TL::PANELS, TL::KV_PANEL);
    load(sV + stage * TL::V_BYTES, &tm_v, &full[stage], j * BKV, v0, TL::VPANELS, TL::KV_PANEL);
  };
  if (tid == 0) {
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&q_full[i], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(q_full, TL::Q_BYTES);
    load(sQ, &tm_q, q_full, q0, 0, TL::PANELS, TL::Q_PANEL);
    for (int j = j0; j < min(j1, j0 + STAGES); ++j) load_kv(j - j0, j);
  }
  __syncthreads();

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  // this thread's two rows: lane / 4 and lane / 4 + 8 of its warp's 16 queries
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(q_full, 0);

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) % STAGES;
    mbar_wait(&full[stage], ((j - j0) / STAGES) & 1);
    const unsigned char* tK = sK + stage * TL::KV_BYTES;
    const unsigned char* tV = sV + stage * TL::V_BYTES;

    // s[4i + 2r + e]: row lane/4 + 8r, key j*BKV + 8i + 2*(lane%4) + e
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      const int panel = kd / 4, col = (kd % 4) * 32;  // 16 values = 32 bytes into the panel
      wgmma_ss<E>(s, sw128_desc(qa + panel * TL::Q_PANEL + col),
               sw128_desc(tK + panel * TL::KV_PANEL + col));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    const int kv0 = j * BKV;
    if (kv0 + BKV > T) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + i * 8 + 2 * (lane & 3) + (e & 1) >= T) s[4 * i + e] = -INFINITY;
    }
    // online softmax; the four lanes of a quad share a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);  // 0 on the first tile
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
    uint32_t p[NS / 2][4];  // P in E as A fragments, one per 16 keys
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p0 = exp2f(fmaf(s[4 * i], scale_log2, -ms0));
      const float p1 = exp2f(fmaf(s[4 * i + 1], scale_log2, -ms0));
      const float p2 = exp2f(fmaf(s[4 * i + 2], scale_log2, -ms1));
      const float p3 = exp2f(fmaf(s[4 * i + 3], scale_log2, -ms1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      p[i / 2][(i & 1) * 2] = pack2<E>(p0, p1);
      p[i / 2][(i & 1) * 2 + 1] = pack2<E>(p2, p3);
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk)  // 16 keys = two 8-row groups, 2048 bytes, a step
      wgmma_rs<E>(o, p[kk], sw128_desc_mn(tV + kk * 2048, TL::KV_PANEL));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    __syncthreads();  // the block is past this stage: refill it
    if (tid == 0 && j + STAGES < j1) load_kv(stage, j + STAGES);
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  if (gridDim.z == 1) {
    // the warpgroup's Q rows are no longer read: stage O there, 16-byte
    // chunk k of row r at chunk k ^ (r % 8), as TMA's swizzle reads it
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int row = warp * 16 + (lane >> 2);  // and row + 8, the same swizzle
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      unsigned char* at =
          qa + (i / 8) * TL::Q_PANEL + row * 128 + (((i % 8) ^ (row & 7)) << 4) + 4 * (lane & 3);
      *reinterpret_cast<uint32_t*>(at) = pack2<E>(o[4 * i] * i0, o[4 * i + 1] * i0);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) = pack2<E>(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
    }
    fence_proxy_async();
    __syncthreads();
    if (tid == 0) {  // rows past T, and with `pad` columns past D, are not written
      for (int w = 0; w < NWG; ++w)
        for (int p = 0; p < TL::VPANELS; ++p) {
          const unsigned char* src = sQ + w * 64 * 128 + p * TL::Q_PANEL;
          if (pad)
            tma_store_4d(&tm_o, src, 64 * (v0 + p), h, q0 + 64 * w, n);
          else
            tma_store_5d(&tm_o, src, 0, h, q0 + 64 * w, v0 + p, n);
        }
      tma_store_commit_and_wait();
    }
  } else {
    const int r0 = q0 + wg * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    const int c = 2 * (lane & 3);
    // (key splits run with halves == 1: rows of DV = the head dim padded to 64)
    const size_t base = ((size_t)blockIdx.z * gridDim.y + bh) * T;  // this split's rows
    float* ob = o_part + base * DV;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      if (r0 < T)
        *reinterpret_cast<float2*>(ob + (size_t)r0 * DV + i * 8 + c) =
            make_float2(o[4 * i], o[4 * i + 1]);
      if (r1 < T)
        *reinterpret_cast<float2*>(ob + (size_t)r1 * DV + i * 8 + c) =
            make_float2(o[4 * i + 2], o[4 * i + 3]);
    }
    if ((lane & 3) == 0) {
      if (r0 < T) ml_part[base + r0] = make_float2(m0 * scale_log2, l0);
      if (r1 < T) ml_part[base + r1] = make_float2(m1 * scale_log2, l1);
    }
  }
}

// ------------------------------------------------------------------ f32
// 16 bytes global -> shared, asynchronously; `bytes` = 0 writes 16 zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// x as two tf32 register values, hi + lo (hopper::tf32_split)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  float h, l;
  tf32_split(x, h, l);
  hi = __float_as_uint(h);
  lo = __float_as_uint(l);
}
// (d0..d3) += A (16 x 8) * B (8 x 8), tf32, mma.sync. With g = lane/4 and
// t = lane%4: a = rows g, g+8, g, g+8 at columns t, t, t+4, t+4; b = rows
// t, t+4 at column g; d = row g at columns 2t, 2t+1, then row g+8.
__device__ __forceinline__ void mma_tf32(float& d0, float& d1, float& d2, float& d3,
                                         const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D: head dim of Q and K (a multiple of 64); DV: the columns of V and O a
// block takes (D, or 256 of D = 512). TRANS: the operands are contiguous
// along the tokens (the channel-major layout an f32 convolution may hand the
// qkv projection) and the tiles are held transposed, [dim][token]; else
// row-major, [token][dim]. Rows are padded so that the fragment loads of a
// warp (g = lane/4, t = lane%4) fall in distinct banks: row-major Q and K
// are read as float2 at columns (2t, 2t+1) of rows g (a half-warp's banks
// 8g + 2t: pad 8), row-major V at rows 2t, column g (8t + g: pad 4);
// transposed tiles at rows t, column g (8t + g: pad 8, or 24t + g), and V^T
// as float2 at columns (2t, 2t+1) of rows g (pad 8).
template <int D, int DV, bool TRANS>
struct TileF32 {
  static constexpr int BQ = 64, THREADS = 128;  // 4 warps, 16 queries each
  static constexpr int BKV = D > 256 ? 8 : TRANS && D > 192 ? 16 : 32;  // keys a tile
  static constexpr int LQ = TRANS ? BQ + 8 : D + 8;  // row strides (floats)
  static constexpr int LK = TRANS ? BKV + 8 : D + 8;
  static constexpr int LV = TRANS ? BKV + 8 : DV + 4;
  static constexpr int Q_FLOATS = (TRANS ? D : BQ) * LQ;
  static constexpr int K_FLOATS = (TRANS ? D : BKV) * LK;
  static constexpr int V_FLOATS = (TRANS ? DV : BKV) * LV;
  static constexpr int STAGE_FLOATS = K_FLOATS + V_FLOATS;
  static constexpr int SMEM = 4 * (Q_FLOATS + 2 * STAGE_FLOATS);  // Q and two stages
  static constexpr int FIT = 233472 / (SMEM + 1024);
  static constexpr int BLOCKS = FIT < 4 ? FIT : 4;
};

// (N, T, H, dim) f32 q, k, v read through their strides: row-major (unit
// stride along the head dim) or, TRANS, unit stride along the tokens, rows
// 16-byte aligned either way; out (N, T, H, dim) row-major. Grid (ceil(T/64),
// N*H*halves, splits) as the 16-bit kernel's, with its o_part/ml_part for
// splits.
template <int D, int DV, bool TRANS>
__global__ void __launch_bounds__(TileF32<D, DV, TRANS>::THREADS, (TileF32<D, DV, TRANS>::BLOCKS))
attn_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ o_part,
                 float2* __restrict__ ml_part, Strides4 qs, Strides4 ks, Strides4 vs, Strides os,
                 int H, int T, int dim, int kv_per_split, int halves, float scale_log2) {
  using TL = TileF32<D, DV, TRANS>;
  constexpr int BKV = TL::BKV, LQ = TL::LQ, LK = TL::LK, LV = TL::LV;
  constexpr int NS = BKV / 8;  // score fragments (16 x 8) a warp
  constexpr int NO = DV / 8;   // output fragments (16 x 8) a warp
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;
  float* sKV = smem + TL::Q_FLOATS;  // [stage][K tile, then V tile]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TL::BQ, bh = blockIdx.y / halves, n = bh / H, h = bh % H;
  const int c0 = (blockIdx.y % halves) * DV;  // first column of V and O
  const float* qb = q + n * qs.sn + h * qs.sh;
  const float* kb = k + n * ks.sn + h * ks.sh;
  const float* vb = v + n * vs.sn + h * vs.sh;
  const int kv_tiles = (T + BKV - 1) / BKV;
  const int j0 = blockIdx.z * kv_per_split, j1 = min(kv_tiles, j0 + kv_per_split);

  // tokens [r0, r0 + ROWS) and dims [col, col + COLS) of one (batch, head)'s
  // operand into shared memory, rows `ld` floats apart, 16 bytes a copy along
  // the unit stride; zeros past T and past dim (T a multiple of 4 when TRANS,
  // dim a multiple of 16)
  auto copy = [&](float* dst, const float* src, const Strides4& s, int r0, auto rows, int col,
                  auto cols, int ld) {
    constexpr int ROWS = decltype(rows)::value, COLS = decltype(cols)::value;
    constexpr int CHUNKS = (TRANS ? ROWS : COLS) / 4;  // copies along the unit stride
    for (int i = tid; i < (TRANS ? COLS : ROWS) * CHUNKS; i += TL::THREADS) {
      const int a = i / CHUNKS, b = (i - a * CHUNKS) * 4;
      const int r = TRANS ? b : a, c = TRANS ? a : b;
      const bool in = r0 + r < T && col + c < dim;
      const float* from = src + (long long)(r0 + r) * s.st + (long long)(col + c) * s.sd;
      cp_async16(dst + (TRANS ? c * ld + r : r * ld + c), in ? from : src, in ? 16 : 0);
    }
  };
  using Rq = std::integral_constant<int, TL::BQ>;
  using Rk = std::integral_constant<int, BKV>;
  using Cd = std::integral_constant<int, D>;
  using Cv = std::integral_constant<int, DV>;
  auto load_kv = [&](int stage, int j) {  // K and V of key tile j
    float* sk = sKV + stage * TL::STAGE_FLOATS;
    copy(sk, kb, ks, j * BKV, Rk(), 0, Cd(), LK);
    copy(sk + TL::K_FLOATS, vb, vs, j * BKV, Rk(), c0, Cv(), LV);
  };
  copy(sQ, qb, qs, q0, Rq(), 0, Cd(), LQ);
  load_kv(0, j0);
  cp_async_commit();

  float o[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;
  // this thread's two rows: g and g + 8 of its warp's 16 queries
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const int qr = warp * 16 + g;  // the first of them in the Q tile

  for (int j = j0; j < j1; ++j) {
    const int stage = (j - j0) & 1;
    if (j + 1 < j1) {  // tile j + 1 lands while tile j is multiplied
      load_kv(stage ^ 1, j + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sk = sKV + stage * TL::STAGE_FLOATS;
    const float* sv = sk + TL::K_FLOATS;

    // S = Q K^T; s[4i + 2r + e]: row g + 8r, key j*BKV + 8i + 2t + e. Row-major,
    // the k index t of a fragment is dim 2t of the 8 and t + 4 is dim 2t + 1
    // (a permutation of the sum), so each pair is one float2 load
    float s[BKV / 2];
#pragma unroll
    for (int i = 0; i < BKV / 2; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int kd = 0; kd < D / 8; ++kd) {
      float a[4];
      float bv[NS][2];
      if constexpr (TRANS) {
        const float* qa = sQ + (kd * 8 + t4) * LQ + qr;
        a[0] = qa[0];
        a[1] = qa[8];
        a[2] = qa[4 * LQ];
        a[3] = qa[4 * LQ + 8];
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float* kr = sk + (kd * 8 + t4) * LK + 8 * i + g;
          bv[i][0] = kr[0];
          bv[i][1] = kr[4 * LK];
        }
      } else {
        const float2 x0 = *reinterpret_cast<const float2*>(sQ + qr * LQ + kd * 8 + 2 * t4);
        const float2 x1 = *reinterpret_cast<const float2*>(sQ + (qr + 8) * LQ + kd * 8 + 2 * t4);
        a[0] = x0.x;
        a[1] = x1.x;
        a[2] = x0.y;
        a[3] = x1.y;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
          const float2 y =
              *reinterpret_cast<const float2*>(sk + (8 * i + g) * LK + kd * 8 + 2 * t4);
          bv[i][0] = y.x;
          bv[i][1] = y.y;
        }
      }
      uint32_t ah[4], al[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split(a[e], ah[e], al[e]);
      uint32_t bh[NS][2], bl[NS][2];
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        split(bv[i][0], bh[i][0], bl[i][0]);
        split(bv[i][1], bh[i][1], bl[i][1]);
      }
      // the small products first, each pass over independent fragments
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mma_tf32(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3], al, bh[i][0], bh[i][1]);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mma_tf32(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3], ah, bl[i][0], bl[i][1]);
#pragma unroll
      for (int i = 0; i < NS; ++i)
        mma_tf32(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3], ah, bh[i][0], bh[i][1]);
    }
    const int kv0 = j * BKV;
    if (kv0 + BKV > T) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kv0 + i * 8 + 2 * t4 + (e & 1) >= T) s[4 * i + e] = -INFINITY;
    }
    // online softmax; the four lanes of a quad share a row
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      mx0 = fmaxf(mx0, fmaxf(s[4 * i], s[4 * i + 1]));
      mx1 = fmaxf(mx1, fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(FULL, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(FULL, mx1, 2));
    const float alpha0 = exp2f((m0 - mx0) * scale_log2);  // 0 on the first tile
    const float alpha1 = exp2f((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float ms0 = m0 * scale_log2, ms1 = m1 * scale_log2;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {  // P in place of S, in f32 (V's dtype)
      s[4 * i] = exp2f(fmaf(s[4 * i], scale_log2, -ms0));
      s[4 * i + 1] = exp2f(fmaf(s[4 * i + 1], scale_log2, -ms0));
      s[4 * i + 2] = exp2f(fmaf(s[4 * i + 2], scale_log2, -ms1));
      s[4 * i + 3] = exp2f(fmaf(s[4 * i + 3], scale_log2, -ms1));
      rs0 += s[4 * i] + s[4 * i + 1];
      rs1 += s[4 * i + 2] + s[4 * i + 3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      o[4 * i] *= alpha0;
      o[4 * i + 1] *= alpha0;
      o[4 * i + 2] *= alpha1;
      o[4 * i + 3] *= alpha1;
    }
    // O += P V over 8 keys at a time: the A fragment's column t is key
    // 8i + 2t and column t + 4 key 8i + 2t + 1, where the score fragment
    // holds them; V's B fragment is read at those keys
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      uint32_t ph[4], pl[4];
      split(s[4 * i], ph[0], pl[0]);
      split(s[4 * i + 2], ph[1], pl[1]);
      split(s[4 * i + 1], ph[2], pl[2]);
      split(s[4 * i + 3], ph[3], pl[3]);
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        float v0, v1;
        if constexpr (TRANS) {
          const float2 y =
              *reinterpret_cast<const float2*>(sv + (8 * nt + g) * LV + 8 * i + 2 * t4);
          v0 = y.x;
          v1 = y.y;
        } else {
          const float* vr = sv + (8 * i + 2 * t4) * LV + 8 * nt + g;
          v0 = vr[0];
          v1 = vr[LV];
        }
        uint32_t vh0, vl0, vh1, vl1;
        split(v0, vh0, vl0);
        split(v1, vh1, vl1);
        mma_tf32(o[4 * nt], o[4 * nt + 1], o[4 * nt + 2], o[4 * nt + 3], pl, vh0, vh1);
        mma_tf32(o[4 * nt], o[4 * nt + 1], o[4 * nt + 2], o[4 * nt + 3], ph, vl0, vl1);
        mma_tf32(o[4 * nt], o[4 * nt + 1], o[4 * nt + 2], o[4 * nt + 3], ph, vh0, vh1);
      }
    }
    __syncthreads();  // the block is past this stage: the next prefetch may refill it
  }

  l0 += __shfl_xor_sync(FULL, l0, 1);
  l0 += __shfl_xor_sync(FULL, l0, 2);
  l1 += __shfl_xor_sync(FULL, l1, 1);
  l1 += __shfl_xor_sync(FULL, l1, 2);
  const int r0 = q0 + qr, r1 = r0 + 8;
  if (gridDim.z == 1) {
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    float* ob = out + n * os.sn + h * os.sh;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int col = c0 + 8 * i + 2 * t4;
      if (col >= dim) continue;
      if (r0 < T)
        *reinterpret_cast<float2*>(ob + (long long)r0 * os.st + col) =
            make_float2(o[4 * i] * i0, o[4 * i + 1] * i0);
      if (r1 < T)
        *reinterpret_cast<float2*>(ob + (long long)r1 * os.st + col) =
            make_float2(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
    }
  } else {  // (key splits run with halves == 1: rows of DV = D floats)
    const size_t base = ((size_t)blockIdx.z * gridDim.y + bh) * T;  // this split's rows
    float* ob = o_part + base * DV;
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int c = 8 * i + 2 * t4;
      if (r0 < T)
        *reinterpret_cast<float2*>(ob + (size_t)r0 * DV + c) = make_float2(o[4 * i], o[4 * i + 1]);
      if (r1 < T)
        *reinterpret_cast<float2*>(ob + (size_t)r1 * DV + c) =
            make_float2(o[4 * i + 2], o[4 * i + 3]);
    }
    if (t4 == 0) {
      if (r0 < T) ml_part[base + r0] = make_float2(m0 * scale_log2, l0);
      if (r1 < T) ml_part[base + r1] = make_float2(m1 * scale_log2, l1);
    }
  }
}

// Merges the key splits of one output row in split order: weights
// 2^(m_z - max m), O = sum_z w_z O_z / sum_z w_z l_z. D/4 threads a row of
// D (the head dim padded to 64); columns past `dim` are not written. The
// output in E (bf16, fp16 or f32).
template <int D, typename E>
__global__ void __launch_bounds__(256)
attn_combine_kernel(const float* __restrict__ o_part, const float2* __restrict__ ml_part,
                    E* __restrict__ out, int splits, int NH, int H, int T, int dim,
                    Strides os) {
  constexpr int TPR = D / 4, RPB = 256 / TPR;
  if (threadIdx.x >= RPB * TPR) return;  // D = 192: 5 rows of 48 threads, 16 idle
  const int row = blockIdx.x * RPB + threadIdx.x / TPR;
  if (row >= NH * T) return;
  const int c = (threadIdx.x % TPR) * 4;
  if (c >= dim) return;
  const size_t rows = (size_t)NH * T;
  float mmax = -INFINITY;
  for (int z = 0; z < splits; ++z) mmax = fmaxf(mmax, ml_part[z * rows + row].x);
  float L = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int z = 0; z < splits; ++z) {
    const float2 ml = ml_part[z * rows + row];
    const float w = exp2f(ml.x - mmax);
    L += w * ml.y;
    const float4 p = *reinterpret_cast<const float4*>(o_part + (z * rows + row) * D + c);
    acc[0] += w * p.x;
    acc[1] += w * p.y;
    acc[2] += w * p.z;
    acc[3] += w * p.w;
  }
  const float inv = 1.f / L;
  const int bh = row / T, t = row % T, n = bh / H, h = bh % H;
  E* at = out + n * os.sn + t * os.st + h * os.sh + c;
  if constexpr (std::is_same_v<E, float>) {
    *reinterpret_cast<float4*>(at) =
        make_float4(acc[0] * inv, acc[1] * inv, acc[2] * inv, acc[3] * inv);
  } else {
    *reinterpret_cast<uint2*>(at) =
        make_uint2(pack2<E>(acc[0] * inv, acc[1] * inv), pack2<E>(acc[2] * inv, acc[3] * inv));
  }
}

// (N, T, H, D) E with strides s (elements, unit along D) as a 5-D map of
// (64 values, H, T, D/64 panels, N), in boxes of one (batch, head)'s `rows`
// tokens and `panels` panels; tokens past T read zeros and are not written
template <typename E>
bool qkv_map(CUtensorMap* map, const void* ptr, int N, int T, int H, int D, Strides s, int rows,
             int panels) {
  const cuuint64_t dims[5] = {64, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)D / 64, (cuuint64_t)N};
  constexpr cuuint64_t B = sizeof(E);
  const cuuint64_t strides[4] = {(cuuint64_t)s.sh * B, (cuuint64_t)s.st * B, 128,
                                 (cuuint64_t)s.sn * B};
  const cuuint32_t box[5] = {64, 1, (cuuint32_t)rows, (cuuint32_t)panels, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode_tiled()(map, tma_type<E>(), 5, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same tensor as a 4-D map of (D values, H, T, N) over the true head
// dim, in boxes of one 64-wide panel of one (batch, head)'s `rows` tokens;
// values past D read zeros and are not written
template <typename E>
bool qkv_map_padded(CUtensorMap* map, const void* ptr, int N, int T, int H, int D, Strides s,
                    int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)N};
  constexpr cuuint64_t B = sizeof(E);
  const cuuint64_t strides[3] = {(cuuint64_t)s.sh * B, (cuuint64_t)s.st * B,
                                 (cuuint64_t)s.sn * B};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, tma_type<E>(), 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// DP: the kernel's head dim (the true `dim` padded to 64, or 512)
template <typename E, int DP, int DV, int NWG>
int launch(const E* q, const E* k, const E* v, E* out, float* o_part, float2* ml_part, int N,
           int H, int T, int dim, int splits, int kv_per_split, Strides qs, Strides ks,
           Strides vs, Strides os, float scale, cudaStream_t stream) {
  using TL = Tile<DP, DV, NWG>;
  static int limits[64];
  const cudaError_t err = allow_smem(attn_fwd_kernel<E, DP, DV, NWG>, TL::SMEM, limits);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, to;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const int pad = dim != DP;
  const int halves = DP / DV;
  const bool ok =
      pad ? qkv_map_padded<E>(&tq, q, N, T, H, dim, qs, TL::BQ) &&
                qkv_map_padded<E>(&tk, k, N, T, H, dim, ks, TL::BKV) &&
                qkv_map_padded<E>(&tv, v, N, T, H, dim, vs, TL::BKV) &&
                qkv_map_padded<E>(&to, out, N, T, H, dim, os, 64)
          : qkv_map<E>(&tq, q, N, T, H, DP, qs, TL::BQ, TL::PANELS) &&
                qkv_map<E>(&tk, k, N, T, H, DP, ks, TL::BKV, TL::PANELS) &&
                qkv_map<E>(&tv, v, N, T, H, DP, vs, TL::BKV, TL::VPANELS) &&
                qkv_map<E>(&to, out, N, T, H, DP, os, 64, 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TL::BQ - 1) / TL::BQ, N * H * halves, splits);
  attn_fwd_kernel<E, DP, DV, NWG><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      tq, tk, tv, to, o_part, ml_part, H, T, kv_per_split, pad, halves,
      scale * 1.4426950408889634f);
  if (splits > 1) {
    constexpr int RPB = 256 / (DV / 4);
    attn_combine_kernel<DV, E><<<(N * H * T + RPB - 1) / RPB, 256, 0, stream>>>(
        o_part, ml_part, out, splits, N * H, H, T, dim, os);
  }
  return (int)cudaGetLastError();
}

template <int DP, int DV, bool TRANS>
int launch_f32(const float* q, const float* k, const float* v, float* out, float* o_part,
               float2* ml_part, int N, int H, int T, int dim, int splits, int kv_per_split,
               Strides4 qs, Strides4 ks, Strides4 vs, Strides os, float scale,
               cudaStream_t stream) {
  using TL = TileF32<DP, DV, TRANS>;
  static int limits[64];
  const cudaError_t err = allow_smem(attn_tf32_kernel<DP, DV, TRANS>, TL::SMEM, limits);
  if (err != cudaSuccess) return (int)err;
  const int halves = DP / DV;
  const dim3 grid((T + TL::BQ - 1) / TL::BQ, N * H * halves, splits);
  attn_tf32_kernel<DP, DV, TRANS><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      q, k, v, out, o_part, ml_part, qs, ks, vs, os, H, T, dim, kv_per_split, halves,
      scale * 1.4426950408889634f);
  if (splits > 1) {
    constexpr int RPB = 256 / (DV / 4);
    attn_combine_kernel<DV, float><<<(N * H * T + RPB - 1) / RPB, 256, 0, stream>>>(
        o_part, ml_part, out, splits, N * H, H, T, dim, os);
  }
  return (int)cudaGetLastError();
}

// The 16-bit entry points' dispatch on (dp, bq), E = __nv_bfloat16 or __half
template <typename E>
int attention_fwd(const void* q, const void* k, const void* v, void* out, void* o_part,
                  void* ml_part, int N, int H, int T, int D, int dp, int bq, int splits,
                  int kv_per_split, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                  void* stream) {
  const E *qq = static_cast<const E*>(q), *kk = static_cast<const E*>(k),
          *vv = static_cast<const E*>(v);
  E* oo = static_cast<E*>(out);
  float* op = static_cast<float*>(o_part);
  float2* ml = static_cast<float2*>(ml_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel_launch) {
    return kernel_launch(qq, kk, vv, oo, op, ml, N, H, T, D, splits, kv_per_split, qs, ks, vs,
                         os, scale, s);
  };
  if (D % 16 || D > dp || (dp == 512 && (D != 512 || splits > 1)))
    return (int)cudaErrorInvalidValue;
  if (dp == 64 && bq == 64) return run(launch<E, 64, 64, 1>);
  if (dp == 128 && bq == 64) return run(launch<E, 128, 128, 1>);
  if (dp == 128 && bq == 128) return run(launch<E, 128, 128, 2>);
  if (dp == 192 && bq == 64) return run(launch<E, 192, 192, 1>);
  if (dp == 256 && bq == 64) return run(launch<E, 256, 256, 1>);
  if (dp == 512 && bq == 64) return run(launch<E, 512, 256, 1>);
  return (int)cudaErrorInvalidValue;
}

// The f32 entry point's dispatch on (dp, trans)
int attention_fwd_f32(const float* q, const float* k, const float* v, float* out, float* o_part,
                      float2* ml_part, int N, int H, int T, int D, int dp, int splits,
                      int kv_per_split, int trans, Strides4 qs, Strides4 ks, Strides4 vs,
                      Strides os, float scale, cudaStream_t s) {
  auto run = [&](auto kernel_launch) {
    return kernel_launch(q, k, v, out, o_part, ml_part, N, H, T, D, splits, kv_per_split, qs, ks,
                         vs, os, scale, s);
  };
  if (D % 16 || D > dp || (dp == 512 && (D != 512 || splits > 1 || trans)) || (trans && T % 4))
    return (int)cudaErrorInvalidValue;
  if (trans) {
    if (dp == 64) return run(launch_f32<64, 64, true>);
    if (dp == 128) return run(launch_f32<128, 128, true>);
    if (dp == 192) return run(launch_f32<192, 192, true>);
    if (dp == 256) return run(launch_f32<256, 256, true>);
  } else {
    if (dp == 64) return run(launch_f32<64, 64, false>);
    if (dp == 128) return run(launch_f32<128, 128, false>);
    if (dp == 192) return run(launch_f32<192, 192, false>);
    if (dp == 256) return run(launch_f32<256, 256, false>);
    if (dp == 512) return run(launch_f32<512, 256, false>);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q, k, v: (N, T, H, D) with unit stride along D, 16-byte aligned, the other
// strides multiples of 16 bytes (TMA's); out: (N, T, H, D) in the same
// dtype: bf16 (dmme_attention_fwd) or fp16 (dmme_attention_fwd_f16). D a
// multiple of 16 up to 256, or 512; dp: D padded to the kernel's head dim
// (64, 128, 192, 256 or 512); bq queries a block: 64, or 128 at dp = 128.
// With splits > 1 (kv_per_split key tiles each; dp <= 256 only), o_part
// holds splits*N*H*T*dp floats and ml_part splits*N*H*T float pairs; both
// are null, and not read, when splits == 1. Returns a cudaError_t.
extern "C" int dmme_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* o_part, void* ml_part, int N, int H, int T, int D,
                                  int dp, int bq, int splits, int kv_per_split, long long q_sn,
                                  long long q_st, long long q_sh, long long k_sn, long long k_st,
                                  long long k_sh, long long v_sn, long long v_st, long long v_sh,
                                  long long o_sn, long long o_st, long long o_sh, float scale,
                                  void* stream) {
  return attention_fwd<bf16>(q, k, v, out, o_part, ml_part, N, H, T, D, dp, bq, splits,
                             kv_per_split, Strides{q_sn, q_st, q_sh}, Strides{k_sn, k_st, k_sh},
                             Strides{v_sn, v_st, v_sh}, Strides{o_sn, o_st, o_sh}, scale, stream);
}

extern "C" int dmme_attention_fwd_f16(const void* q, const void* k, const void* v, void* out,
                                      void* o_part, void* ml_part, int N, int H, int T, int D,
                                      int dp, int bq, int splits, int kv_per_split,
                                      long long q_sn, long long q_st, long long q_sh,
                                      long long k_sn, long long k_st, long long k_sh,
                                      long long v_sn, long long v_st, long long v_sh,
                                      long long o_sn, long long o_st, long long o_sh,
                                      float scale, void* stream) {
  return attention_fwd<__half>(q, k, v, out, o_part, ml_part, N, H, T, D, dp, bq, splits,
                               kv_per_split, Strides{q_sn, q_st, q_sh},
                               Strides{k_sn, k_st, k_sh}, Strides{v_sn, v_st, v_sh},
                               Strides{o_sn, o_st, o_sh}, scale, stream);
}

// f32: q, k, v with four strides each (batch, token, head, dim), either
// row-major (dim stride 1: trans = 0) or, trans = 1, with a unit stride
// along the tokens and T a multiple of 4 (dp <= 256); either way 16-byte
// aligned with the other strides multiples of 16 bytes (cp.async). out:
// (N, T, H, D) f32 row-major. 64 queries a block; the rest as above.
extern "C" int dmme_attention_fwd_f32(const void* q, const void* k, const void* v, void* out,
                                      void* o_part, void* ml_part, int N, int H, int T, int D,
                                      int dp, int splits, int kv_per_split, int trans,
                                      long long q_sn, long long q_st, long long q_sh,
                                      long long q_sd, long long k_sn, long long k_st,
                                      long long k_sh, long long k_sd, long long v_sn,
                                      long long v_st, long long v_sh, long long v_sd,
                                      long long o_sn, long long o_st, long long o_sh,
                                      float scale, void* stream) {
  return attention_fwd_f32(static_cast<const float*>(q), static_cast<const float*>(k),
                           static_cast<const float*>(v), static_cast<float*>(out),
                           static_cast<float*>(o_part), static_cast<float2*>(ml_part), N, H, T,
                           D, dp, splits, kv_per_split, trans, Strides4{q_sn, q_st, q_sh, q_sd},
                           Strides4{k_sn, k_st, k_sh, k_sd}, Strides4{v_sn, v_st, v_sh, v_sd},
                           Strides{o_sn, o_st, o_sh}, scale, static_cast<cudaStream_t>(stream));
}
