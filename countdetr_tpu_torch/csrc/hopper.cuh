// Hopper (sm_90a) building blocks shared by the attention kernels: TMA
// tile loads into shared memory (cp.async.bulk.tensor) completed on
// mbarriers, warpgroup matrix products (wgmma.mma_async) with their
// shared-memory descriptors, and the host-side tensor-map encoder, reached
// through cudaGetDriverEntryPoint so that nothing links libcuda.
//
// Shared-memory tiles are rows of D bf16 (2D bytes: 32, 64 or 128) written
// by TMA with the swizzle of the same width (32B, 64B, 128B), so one row is
// one swizzle span and 8 rows one swizzle atom. Tiles start on a 1024-byte
// boundary. The same tile serves wgmma two ways:
//  * K-major (rows are the N index, D the contraction): k-step ks starts
//    32 bytes into the row; SBO = 8 rows.
//  * MN-major, transposed B (rows are the contraction index, D the N
//    index): k-step ks starts 16 rows down; SBO = 8 rows. N = D is one
//    swizzle span; a wider B (N = k D) is k such tiles side by side, LBO
//    bytes apart.
//
// wgmma accumulator layout (m64nN, f32), thread t of the warpgroup, warp
// w = t / 32, g = (t % 32) / 4, c = t % 4: d[4j + e] holds row 16w + g +
// 8 (e / 2), column 8j + 2c + (e % 2). The register A operand of one k16
// step uses the same rows: a[0] = (g, 2c..2c+1), a[1] = (g+8, 2c..),
// a[2] = (g, 2c+8..), a[3] = (g+8, 2c+8..), two bf16 a word, so two n8
// blocks of an accumulator pack straight into one A step.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier ---

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to come.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait until the barrier's phase with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ----------------------------------------------------------------- TMA ---

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
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

// --------------------------------------------------------------- wgmma ---

// Swizzle of a row of D bf16, as the TMA map and the descriptor name it.
template <int D>
struct Swizzle {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  static constexpr int kRowBytes = 2 * D;
  static constexpr int kDescLayout = D == 64 ? 1 : D == 32 ? 2 : 3;  // 128B, 64B, 32B
  static constexpr CUtensorMapSwizzle kTma = D == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                             : D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
};

// Descriptor of a swizzled tile of rows of D bf16 starting at `addr`. LBO
// is the byte distance between the D-wide column blocks of an MN-major B
// wider than one swizzle span (N = k D); the other layouts do not read it
// (the default, 16 bytes, is what CUTLASS sets there).
template <int D>
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo_bytes = 16) {
  constexpr uint64_t sbo = 8 * Swizzle<D>::kRowBytes;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32)
         | (static_cast<uint64_t>(Swizzle<D>::kDescLayout) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across
// the asynchronous product's issue and wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define HOPPER_D8(d, i)                                                                  \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 16, shared, K-major) * B (16 x 64, shared,
// K-major rows of the N index). scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_D8(d, 0), HOPPER_D8(d, 8), HOPPER_D8(d, 16), HOPPER_D8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x 16, registers) * B (16 x N, shared, stored
// as rows of the contraction index: MN-major, the transposed-B form).
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HOPPER_D8(d, 0), HOPPER_D8(d, 8), HOPPER_D8(d, 16), HOPPER_D8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : HOPPER_D8(d, 0), HOPPER_D8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    static_assert(N == 16, "wgmma_rs: N must be 16, 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : HOPPER_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

#undef HOPPER_D8

// One SFU instruction: 2^x (approximate, flushes denormals; 2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Max and sum over the four threads (c = 0..3) that share an accumulator row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------- host ---

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status) !=
            cudaSuccess ||
        status != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// Tensor map of a row-major bf16 tensor with `rank` dimensions, innermost
// first (dims[0] elements contiguous), box `box` (box[0] = D), swizzled for
// D. Rows outside the tensor read as zero. Returns false on failure.
template <int D>
inline bool bf16_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                     const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Swizzle<D>::kTma,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
