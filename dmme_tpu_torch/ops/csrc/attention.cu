// Softmax attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernel dmme_tpu/ops/attention.py:_attn_kernel (reached
// through _attention_pallas), which holds one whole (T x T) score tile per
// batch*head in VMEM. Here a block of one or two warpgroups (4 warps each)
// takes 64 queries a warpgroup of one (batch, head) and walks the keys in
// tiles with an online softmax, in the register layout of FlashAttention-3:
//   - S = Q K^T runs on wgmma with Q and the K tile read from shared memory
//     (K-major, 128-byte swizzle, D in 64-wide panels); S stays in registers;
//   - P = exp2(S*scale*log2(e) - m), one FMA into exp2, is rounded to bf16
//     (the TPU kernel casts P to V's dtype) and repacked in registers as the
//     A operand of O += P V, a wgmma that reads the V tile MN-major from
//     shared memory, so neither S nor P touches shared memory; the f32 output
//     accumulator (D/2 floats a thread) and the running row max and sum live
//     in registers too;
//   - thread 0 loads Q once and the K and V tiles through TMA into a
//     two-stage ring under mbarriers, one instruction a tile per tensor (a
//     5-D box holds all of D's panels), and refills a stage as soon as the
//     block is past it, so tile j+1 lands while tile j is multiplied; tokens
//     past T read zeros;
//   - each warpgroup's bf16 output tile is staged in its rows of the Q
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
// Bound: at the UNet's shapes (T <= 256, D <= 256) the work is ~4*T*D
// operations per query against ~8*D bytes of q/k/v/o per token, far below
// the ~295 operations per byte where the tensor cores become the limit, so
// the least time is that of the bytes: q, k and v read once, o written once.
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

// tm_q, tm_k, tm_v: 5-D maps of (64 values, H, T, D/64 panels, N), boxes of
// one head's BQ (Q) or BKV (K, V) tokens with all panels (V: VPANELS), which
// land as [panel][token][64 values]; tm_o: the output, boxes of 64 tokens of
// one panel. With `pad` (a head dim that is not a multiple of 64) all four
// are 4-D maps of (D values, H, T, N) over the true head dim, with boxes of
// one 64-wide panel, loaded and stored panel by panel. `halves`: output
// column blocks a (batch, head), 2 for D = 512.
template <int D, int DV, int NWG>
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
      wgmma_ss(s, sw128_desc(qa + panel * TL::Q_PANEL + col),
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
    uint32_t p[NS / 2][4];  // P as A fragments, one per 16 keys
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float p0 = exp2f(fmaf(s[4 * i], scale_log2, -ms0));
      const float p1 = exp2f(fmaf(s[4 * i + 1], scale_log2, -ms0));
      const float p2 = exp2f(fmaf(s[4 * i + 2], scale_log2, -ms1));
      const float p3 = exp2f(fmaf(s[4 * i + 3], scale_log2, -ms1));
      rs0 += p0 + p1;
      rs1 += p2 + p3;
      p[i / 2][(i & 1) * 2] = pack_bf16(p0, p1);
      p[i / 2][(i & 1) * 2 + 1] = pack_bf16(p2, p3);
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
      wgmma_rs(o, p[kk], sw128_desc_mn(tV + kk * 2048, TL::KV_PANEL));
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
      *reinterpret_cast<uint32_t*>(at) = pack_bf16(o[4 * i] * i0, o[4 * i + 1] * i0);
      *reinterpret_cast<uint32_t*>(at + 8 * 128) = pack_bf16(o[4 * i + 2] * i1, o[4 * i + 3] * i1);
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

// Merges the key splits of one output row in split order: weights
// 2^(m_z - max m), O = sum_z w_z O_z / sum_z w_z l_z. D/4 threads a row of
// D (the head dim padded to 64); columns past `dim` are not written.
template <int D>
__global__ void __launch_bounds__(256)
attn_combine_kernel(const float* __restrict__ o_part, const float2* __restrict__ ml_part,
                    bf16* __restrict__ out, int splits, int NH, int H, int T, int dim,
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
  uint2 packed;
  packed.x = pack_bf16(acc[0] * inv, acc[1] * inv);
  packed.y = pack_bf16(acc[2] * inv, acc[3] * inv);
  *reinterpret_cast<uint2*>(out + n * os.sn + t * os.st + h * os.sh + c) = packed;
}

// (N, T, H, D) bf16 with strides s (elements, unit along D) as a 5-D map of
// (64 values, H, T, D/64 panels, N), in boxes of one (batch, head)'s `rows`
// tokens and `panels` panels; tokens past T read zeros and are not written
bool qkv_map(CUtensorMap* map, const void* ptr, int N, int T, int H, int D, Strides s, int rows,
             int panels) {
  const cuuint64_t dims[5] = {64, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)D / 64, (cuuint64_t)N};
  const cuuint64_t strides[4] = {(cuuint64_t)s.sh * 2, (cuuint64_t)s.st * 2, 128,
                                 (cuuint64_t)s.sn * 2};
  const cuuint32_t box[5] = {64, 1, (cuuint32_t)rows, (cuuint32_t)panels, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The same tensor as a 4-D map of (D values, H, T, N) over the true head
// dim, in boxes of one 64-wide panel of one (batch, head)'s `rows` tokens;
// values past D read zeros and are not written
bool qkv_map_padded(CUtensorMap* map, const void* ptr, int N, int T, int H, int D, Strides s,
                    int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)T, (cuuint64_t)N};
  const cuuint64_t strides[3] = {(cuuint64_t)s.sh * 2, (cuuint64_t)s.st * 2,
                                 (cuuint64_t)s.sn * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// DP: the kernel's head dim (the true `dim` padded to 64, or 512)
template <int DP, int DV, int NWG>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* out, float* o_part,
           float2* ml_part, int N, int H, int T, int dim, int splits, int kv_per_split,
           Strides qs, Strides ks, Strides vs, Strides os, float scale, cudaStream_t stream) {
  using TL = Tile<DP, DV, NWG>;
  static int limits[64];
  const cudaError_t err = allow_smem(attn_fwd_kernel<DP, DV, NWG>, TL::SMEM, limits);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap tq, tk, tv, to;
  if (!encode_tiled()) return (int)cudaErrorNotSupported;
  const int pad = dim != DP;
  const int halves = DP / DV;
  const bool ok =
      pad ? qkv_map_padded(&tq, q, N, T, H, dim, qs, TL::BQ) &&
                qkv_map_padded(&tk, k, N, T, H, dim, ks, TL::BKV) &&
                qkv_map_padded(&tv, v, N, T, H, dim, vs, TL::BKV) &&
                qkv_map_padded(&to, out, N, T, H, dim, os, 64)
          : qkv_map(&tq, q, N, T, H, DP, qs, TL::BQ, TL::PANELS) &&
                qkv_map(&tk, k, N, T, H, DP, ks, TL::BKV, TL::PANELS) &&
                qkv_map(&tv, v, N, T, H, DP, vs, TL::BKV, TL::VPANELS) &&
                qkv_map(&to, out, N, T, H, DP, os, 64, 1);
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((T + TL::BQ - 1) / TL::BQ, N * H * halves, splits);
  attn_fwd_kernel<DP, DV, NWG><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      tq, tk, tv, to, o_part, ml_part, H, T, kv_per_split, pad, halves,
      scale * 1.4426950408889634f);
  if (splits > 1) {
    constexpr int RPB = 256 / (DV / 4);
    attn_combine_kernel<DV><<<(N * H * T + RPB - 1) / RPB, 256, 0, stream>>>(
        o_part, ml_part, out, splits, N * H, H, T, dim, os);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v: (N, T, H, D) bf16 with unit stride along D, 16-byte aligned, the
// other strides multiples of 8 (TMA's 16 bytes); out: (N, T, H, D) bf16.
// D a multiple of 16 up to 256, or 512; dp: D padded to the kernel's head
// dim (64, 128, 192, 256 or 512); bq queries a block: 64, or 128 at dp = 128.
// With splits > 1 (kv_per_split key tiles each; dp <= 256 only), o_part
// holds splits*N*H*T*dp floats and ml_part splits*N*H*T float pairs; both
// are null, and not read, when splits == 1. Returns a cudaError_t.
extern "C" int dmme_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  void* o_part, void* ml_part, int N, int H, int T, int D,
                                  int dp, int bq, int splits, int kv_per_split,
                                  long long q_sn, long long q_st, long long q_sh,
                                  long long k_sn, long long k_st, long long k_sh,
                                  long long v_sn, long long v_st, long long v_sh,
                                  long long o_sn, long long o_st, long long o_sh,
                                  float scale, void* stream) {
  const bf16 *qq = static_cast<const bf16*>(q), *kk = static_cast<const bf16*>(k),
             *vv = static_cast<const bf16*>(v);
  bf16* oo = static_cast<bf16*>(out);
  float* op = static_cast<float*>(o_part);
  float2* ml = static_cast<float2*>(ml_part);
  const Strides qs{q_sn, q_st, q_sh}, ks{k_sn, k_st, k_sh}, vs{v_sn, v_st, v_sh},
      os{o_sn, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel_launch) {
    return kernel_launch(qq, kk, vv, oo, op, ml, N, H, T, D, splits, kv_per_split, qs, ks, vs,
                         os, scale, s);
  };
  if (D % 16 || D > dp || (dp == 512 && (D != 512 || splits > 1)))
    return (int)cudaErrorInvalidValue;
  if (dp == 64 && bq == 64) return run(launch<64, 64, 1>);
  if (dp == 128 && bq == 64) return run(launch<128, 128, 1>);
  if (dp == 128 && bq == 128) return run(launch<128, 128, 2>);
  if (dp == 192 && bq == 64) return run(launch<192, 192, 1>);
  if (dp == 256 && bq == 64) return run(launch<256, 256, 1>);
  if (dp == 512 && bq == 64) return run(launch<512, 256, 1>);
  return (int)cudaErrorInvalidValue;
}
