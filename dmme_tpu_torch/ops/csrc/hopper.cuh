// PTX wrappers for Hopper (sm_90a), shared by the kernels in this directory
// (attention.cu, resblock.cu, group_norm.cu): TMA tensor loads and stores,
// TMA bulk copies, mbarriers, thread-block-cluster barriers and distributed
// shared memory, warpgroup wgmma over 128-byte-swizzled shared memory in
// bf16, fp16 and tf32, and the split of an f32 value into two tf32 halves;
// on the host, the driver's tensor-map encoder and a once-per-kernel
// shared-memory limit.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// two floats -> bf16x2, `lo` in the low half (the lower column of a fragment)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// the same in the 16-bit type E (__nv_bfloat16 or __half)
template <typename E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same_v<E, __half>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}
// two consecutive values of E as floats
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and add `bytes` to the transactions the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Wait until the phase with this parity has completed. A wait longer than
// ~2^34 cycles (seconds) can only be a fault in the pipeline: trap, so the
// launch fails with an error instead of holding the device.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long start = clock64();
  while (true) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 34)) __trap();
  }
}

// --------------------------------------------------------------------- TMA
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}
// A 1-D bulk copy of `bytes` contiguous bytes (a multiple of 16, both ends
// 16-byte aligned) from global into this block's shared memory, completing
// on `bar` as a transaction of `bytes`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// shared -> global; the bulk group must be waited on before the shared
// memory is reused or the block exits
__device__ __forceinline__ void tma_store_5d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5, %6}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}
__device__ __forceinline__ void tma_store_commit_and_wait() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// orders this thread's shared-memory writes before later async-proxy (TMA,
// wgmma) reads of them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// ---------------------------------------------------------------- clusters
// A barrier over every thread of every block of the cluster: arrive
// (release: this thread's shared-memory writes become visible to the
// cluster) and wait (acquire), or both at once.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}
// The f32 at the same shared-memory offset as `p` in block `rank` of the
// cluster (distributed shared memory)
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(remote) : "memory");
  return v;
}

// ------------------------------------------------------------------- wgmma
// Descriptor of a K-major operand in the 128-byte swizzle that TMA writes:
// rows of 128 bytes (64 bf16 or fp16 values, or 32 tf32), 8-row atoms 1024
// bytes apart (SBO), the tile 1024-byte aligned. A step of 32 bytes along K
// (16 16-bit values, 8 tf32) adds 2 to the address field of the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// The same swizzle read MN-major (a B operand whose N is contiguous): rows
// of 64 N values are consecutive K, 8-row K groups 1024 bytes apart (SBO),
// and the next 64 N values `panel_bytes` further on (LBO).
__device__ __forceinline__ uint64_t sw128_desc_mn(const void* p, uint32_t panel_bytes) {
  const uint64_t addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4) | ((uint64_t)(panel_bytes >> 4) << 16) | (64ull << 32) |
         (1ull << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Orders the accumulator registers against the asynchronous wgmma: no
// access to them moves across this point.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (this warpgroup's 64 x N f32 fragment, N/2 floats a thread) += A (64 x 16)
// * B (16 x N) in the 16-bit type E (__nv_bfloat16 or __half).
// wgmma_ss: A and B K-major in shared memory, read through their
// descriptors. wgmma_rs: A from registers (four pairs of E a thread,
// mma.sync's m16k16 A layout in each warp), B MN-major in shared memory
// (transposed on read). The accumulator's size picks N. wgmma_ss_tf32: the
// same over 8-deep K in tf32 (f32 bits whose low 13 are zero), both
// operands K-major (tf32 takes no transpose), 32 bytes a K step as in the
// 16-bit types.
// Fragment layout: d[4j + 2h + e] is row 16*warp + lane/4 + 8h, column
// 8j + 2*(lane%4) + e.
#define HOPPER_REGS16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
#define HOPPER_REGS32 HOPPER_REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64 HOPPER_REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOPPER_REGS96 HOPPER_REGS64 ", %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
#define HOPPER_REGS128 HOPPER_REGS96 ", %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
#define HOPPER_ACC8(d, i)                                                                     \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define HOPPER_ACC16(d) HOPPER_ACC8(d, 0), HOPPER_ACC8(d, 8)
#define HOPPER_ACC32(d) HOPPER_ACC16(d), HOPPER_ACC8(d, 16), HOPPER_ACC8(d, 24)
#define HOPPER_ACC64(d) \
  HOPPER_ACC32(d), HOPPER_ACC8(d, 32), HOPPER_ACC8(d, 40), HOPPER_ACC8(d, 48), HOPPER_ACC8(d, 56)
#define HOPPER_ACC96(d) \
  HOPPER_ACC64(d), HOPPER_ACC8(d, 64), HOPPER_ACC8(d, 72), HOPPER_ACC8(d, 80), HOPPER_ACC8(d, 88)
#define HOPPER_ACC128(d)                                                                   \
  HOPPER_ACC96(d), HOPPER_ACC8(d, 96), HOPPER_ACC8(d, 104), HOPPER_ACC8(d, 112), \
      HOPPER_ACC8(d, 120)
// one wgmma that always accumulates: the predicate P (operand number) is set
// from the constant 1 the wrappers pass
#define HOPPER_WGMMA(SHAPE, TYPES, REGS, A, B, P, MODS)                                   \
  "{\n.reg .pred p;\nsetp.ne.b32 p, %" P ", 0;\nwgmma.mma_async.sync.aligned." SHAPE     \
  ".f32." TYPES " {" REGS "}, " A ", " B ", p, " MODS ";\n}\n"
#define HOPPER_WGMMA_SS(R, N, A, B, P)                                                     \
  template <typename E>                                                                    \
  __device__ __forceinline__ void wgmma_ss(float(&d)[R], uint64_t da, uint64_t db) {      \
    if constexpr (std::is_same_v<E, __half>)                                               \
      asm volatile(HOPPER_WGMMA("m64n" #N "k16", "f16.f16", HOPPER_REGS##R, A, B, P,       \
                                "1, 1, 0, 0")                                              \
                   : HOPPER_ACC##R(d)                                                      \
                   : "l"(da), "l"(db), "r"(1));                                            \
    else                                                                                   \
      asm volatile(HOPPER_WGMMA("m64n" #N "k16", "bf16.bf16", HOPPER_REGS##R, A, B, P,     \
                                "1, 1, 0, 0")                                              \
                   : HOPPER_ACC##R(d)                                                      \
                   : "l"(da), "l"(db), "r"(1));                                            \
  }
#define HOPPER_WGMMA_RS(R, N, A, B, P)                                                     \
  template <typename E>                                                                    \
  __device__ __forceinline__ void wgmma_rs(float(&d)[R], const uint32_t(&a)[4],           \
                                           uint64_t db) {                                  \
    if constexpr (std::is_same_v<E, __half>)                                               \
      asm volatile(HOPPER_WGMMA("m64n" #N "k16", "f16.f16", HOPPER_REGS##R, A, B, P,       \
                                "1, 1, 1")                                                 \
                   : HOPPER_ACC##R(d)                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));         \
    else                                                                                   \
      asm volatile(HOPPER_WGMMA("m64n" #N "k16", "bf16.bf16", HOPPER_REGS##R, A, B, P,     \
                                "1, 1, 1")                                                 \
                   : HOPPER_ACC##R(d)                                                      \
                   : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));         \
  }
HOPPER_WGMMA_SS(16, 32, "%16", "%17", "18")
HOPPER_WGMMA_SS(32, 64, "%32", "%33", "34")
HOPPER_WGMMA_SS(64, 128, "%64", "%65", "66")
HOPPER_WGMMA_RS(32, 64, "{%32, %33, %34, %35}", "%36", "37")
HOPPER_WGMMA_RS(64, 128, "{%64, %65, %66, %67}", "%68", "69")
HOPPER_WGMMA_RS(96, 192, "{%96, %97, %98, %99}", "%100", "101")
HOPPER_WGMMA_RS(128, 256, "{%128, %129, %130, %131}", "%132", "133")
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(HOPPER_WGMMA("m64n128k8", "tf32.tf32", HOPPER_REGS64, "%64", "%65", "66", "1, 1")
               : HOPPER_ACC64(d)
               : "l"(da), "l"(db), "r"(1));
}

// ------------------------------------------------------------------- tf32
// x rounded to tf32 (10 mantissa bits), to nearest with ties away from zero:
// the f32 bits with the low 13 cleared, as the tensor cores read them
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}
// x = hi + lo + O(2^-22 |x|): hi = tf32(x), lo = tf32(x - hi) (x - hi is
// exact in f32). A product x*y is then hi*hi + hi*lo + lo*hi to about
// 2^-21 relative: three tf32 products with f32 accumulation (3xTF32).
__device__ __forceinline__ void tf32_split(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - hi);
}

// ------------------------------------------------------------------- host
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// TMA's element type for E (__nv_bfloat16, __half or float)
template <typename E>
constexpr CUtensorMapDataType tma_type() {
  if constexpr (std::is_same_v<E, __half>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  else if constexpr (std::is_same_v<E, float>) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// cuTensorMapEncodeTiled from the driver, through the runtime: no -lcuda
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes` on the current
// device the first time a launch needs more than it has; `limits` (one slot
// per device, static in the caller) remembers what was set, so the
// attribute is set once per kernel, not on every launch.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, int (&limits)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || dev >= 64 || bytes <= limits[dev]) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) limits[dev] = bytes;
  return err;
}

}  // namespace hopper
