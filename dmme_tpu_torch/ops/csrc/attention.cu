// Single-pass softmax attention forward for Hopper (sm_90a), bf16 in/out.
//
// Replaces the TPU kernel dmme_tpu/ops/attention.py:_attn_kernel (reached
// through _attention_pallas), which holds one whole (T x T) score tile per
// batch*head in VMEM. Here one block of 4 warps takes 64 queries of one
// (batch, head) and walks the keys in tiles of 64 with an online softmax:
// a running row max and row sum in f32 and an f32 output accumulator of
// width D <= 256 in shared memory, so no score tile wider than 64 keys ever
// exists. Scores and P.V run on the tensor cores through nvcuda::wmma
// (bf16 x bf16 -> f32, 16x16x16 fragments); P is rounded to bf16 before the
// P.V product, as the TPU kernel casts P to V's dtype.
//
// Bound: at the UNet's shapes (T <= 256, D <= 256) the work is ~4*T*D
// operations per query against ~8*D bytes of q/k/v/o per token, far below
// the ~295 operations per byte where the tensor cores become the limit, so
// the least time is that of the bytes. The design reads q once, k and v once
// per 64-query tile (4 times at T=256, mostly from L2) and writes o once.
//
// q, k and v are addressed by (batch, token, head) strides with a unit
// stride along D, so the strided views of a packed qkv projection are read
// in place.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BKV = 64;      // keys per tile
constexpr int NWARPS = 4;    // each warp owns 16 query rows
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BKV + 4; // f32 score row stride
constexpr int LDP = BKV + 8; // bf16 probability row stride

struct Strides {
  long long sn, st, sh;
};

__host__ __device__ inline size_t smem_bytes(int D) {
  const int ldh = D + 8, ldo = D + 4;
  return (size_t)(BQ + 2 * BKV) * ldh * sizeof(bf16)  // Q, K, V tiles
         + (size_t)BQ * LDS * sizeof(float)            // scores
         + (size_t)BQ * LDP * sizeof(bf16)             // probabilities
         + (size_t)BQ * ldo * sizeof(float)            // output accumulator
         + 2 * BQ * sizeof(float);                     // row max, row sum
}

__device__ inline void load_tile(bf16* dst, int ldh, const bf16* src, Strides s,
                                 int row0, int T, int D, int tid) {
  const int chunks = D / 8;
  for (int idx = tid; idx < BQ * chunks; idx += NTHREADS) {
    const int r = idx / chunks, c8 = (idx % chunks) * 8;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + (long long)t * s.st + c8);
    *reinterpret_cast<uint4*>(dst + r * ldh + c8) = val;
  }
}

__global__ void __launch_bounds__(NTHREADS)
attn_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out,
                int H, int T, int D, Strides qs, Strides ks, Strides vs,
                Strides os, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldh = D + 8, ldo = D + 4;
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * ldh;
  bf16* sV = sK + BKV * ldh;
  float* sS = reinterpret_cast<float*>(sV + BKV * ldh);
  bf16* sP = reinterpret_cast<bf16*>(sS + BQ * LDS);
  float* sO = reinterpret_cast<float*>(sP + BQ * LDP);
  float* sM = sO + BQ * ldo;
  float* sL = sM + BQ;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * BQ;
  const int bh = blockIdx.y, n = bh / H, h = bh % H;
  const bf16* qb = q + n * qs.sn + h * qs.sh;
  const bf16* kb = k + n * ks.sn + h * ks.sh;
  const bf16* vb = v + n * vs.sn + h * vs.sh;

  load_tile(sQ, ldh, qb, qs, q0, T, D, tid);
  for (int i = tid; i < BQ * ldo; i += NTHREADS) sO[i] = 0.f;
  for (int i = tid; i < BQ; i += NTHREADS) {
    sM[i] = -INFINITY;
    sL[i] = 0.f;
  }

  const int wrow = warp * 16;          // this warp's first query row
  const int r = wrow + lane / 2;       // the row this lane pair works on
  const int half = lane & 1;
  const int ntiles = (T + BKV - 1) / BKV;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int k0 = kt * BKV;
    __syncthreads();  // previous tile's P.V is done with sK/sV
    load_tile(sK, ldh, kb, ks, k0, T, D, tid);
    load_tile(sV, ldh, vb, vs, k0, T, D, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, sQ + wrow * ldh + kk, ldh);
        wmma::load_matrix_sync(b, sK + (j * 16) * ldh + kk, ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sS + wrow * LDS + j * 16, acc, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: each lane pair owns one row, 32 columns per lane
    const int c0 = half * (BKV / 2);
    float mx = -INFINITY;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float s = (k0 + c < T) ? sS[r * LDS + c] * scale : -INFINITY;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_old = sM[r];
    const float m_new = fmaxf(m_old, mx);
    float sum = 0.f;
    for (int c = c0; c < c0 + BKV / 2; ++c) {
      const float p = (k0 + c < T) ? expf(sS[r * LDS + c] * scale - m_new) : 0.f;
      sP[r * LDP + c] = __float2bfloat16(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    const float alpha = expf(m_old - m_new);
    const float l_old = sL[r];
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c) sO[r * ldo + c] *= alpha;
    __syncwarp();
    if (half == 0) {
      sM[r] = m_new;
      sL[r] = l_old * alpha + sum;
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int j = 0; j < D / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sO + wrow * ldo + j * 16, ldo, wmma::mem_row_major);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, sP + wrow * LDP + kk, LDP);
        wmma::load_matrix_sync(b, sV + kk * ldh + j * 16, ldh);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(sO + wrow * ldo + j * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int t = q0 + r;
  if (t < T) {
    const float inv_l = 1.f / sL[r];
    bf16* orow = out + n * os.sn + h * os.sh + (long long)t * os.st;
    for (int c = half * (D / 2); c < (half + 1) * (D / 2); ++c)
      orow[c] = __float2bfloat16(sO[r * ldo + c] * inv_l);
  }
}

}  // namespace

extern "C" int dmme_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                  int N, int H, int T, int D,
                                  long long q_sn, long long q_st, long long q_sh,
                                  long long k_sn, long long k_st, long long k_sh,
                                  long long v_sn, long long v_st, long long v_sh,
                                  long long o_sn, long long o_st, long long o_sh,
                                  float scale, void* stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      attn_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + BQ - 1) / BQ, N * H);
  attn_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out), H, T, D,
      Strides{q_sn, q_st, q_sh}, Strides{k_sn, k_st, k_sh}, Strides{v_sn, v_st, v_sh},
      Strides{o_sn, o_st, o_sh}, scale);
  return (int)cudaGetLastError();
}
