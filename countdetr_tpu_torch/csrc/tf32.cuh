// 3xTF32 building blocks for the float32 attention kernels on Hopper's
// tensor cores (mha.cu, rcda.cu): the hi/lo split, the two shared-memory
// layouts a K-major tf32 operand takes, their wgmma descriptors, the tf32
// wgmma products and the TMA map of a float32 tensor.
//
// One TF32 product keeps 10 mantissa bits of each operand. A float32
// product x * y runs as three: x = hi + lo with hi = cvt.rna.tf32(x) and
// lo = cvt.rna.tf32(x - hi), then hi*lo + lo*hi and hi*hi accumulated in
// f32 into one accumulator, the small terms first; lo*lo (2^-22 of the
// product) is dropped. The products of tf32 values are exact in f32, so
// what is left is f32 accumulation error and the 2^-21-relative residue of
// the split.
//
// wgmma takes tf32 operands from shared memory only K-major (no transpose).
// Two layouts, both built from swizzle atoms of 8 rows on a 1024-byte
// boundary:
//  * Rows<D>: rows of D floats along K (q, k: K = the head dim), as TMA
//    lands them: one row is one swizzle span (64 B at D = 16, 128 B at 32);
//    D = 64 is two column blocks of 32 floats, each its own TMA box. A
//    k-step of 8 floats starts 32 bytes further along the row; SBO = 8 rows.
//  * Cols: N rows of K floats in column blocks of 32 (128B swizzle), the
//    layout the kernels write themselves: V^T in MHA's P V (V lands
//    [key][d], MN-major), a_row^T in RCDA's combine. SBO = 1024.
// A register A operand of one m64k8 step is, per warp, rows g and g + 8
// (g = lane / 4) at columns c and c + 4 (c = lane % 4): a[0] = (g, c),
// a[1] = (g + 8, c), a[2] = (g, c + 4), a[3] = (g + 8, c + 4). A score
// accumulator holds columns 2c and 2c + 1 of each n8 block instead, so MHA
// feeds P to P V in a permuted key order: in each group of 8 keys, A
// column c is key 2c and column c + 4 is key 2c + 1 (``key_slot``,
// ``split_a``), and writes V^T in the same order. A contraction does not
// see the order of its terms.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace tf32 {

using hopper::smem_u32;

// x rounded to 10 mantissa bits, ties away from zero: cvt.rna.tf32.f32 for
// finite x, as half an ulp added to the bits and the low 13 cleared (two
// instructions; cvt.rna compiles to four on sm_90, two of them for inf and
// NaN, which no operand of these kernels is)
__device__ __forceinline__ float rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ void split(float x, float& hi, float& lo) {
  hi = rna(x);
  lo = rna(x - hi);
}

// Position of key u of a group of 8 in the permuted order (see above).
__device__ __forceinline__ int key_slot(int u) {
  return (u & ~7) | ((u & 1) ? 4 + ((u & 7) >> 1) : (u & 7) >> 1);
}

// Makes this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma operand reads, TMA writes).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1..15) over `n` threads: a warpgroup's, without the block.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
// Arrival at barrier `id` without waiting (the other side bar_syncs).
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(sbo >> 4) << 32) | (static_cast<uint64_t>(layout) << 62);
}

template <int D>
struct Rows {
  static_assert(D == 16 || D == 32 || D == 64, "head dim must be 16, 32 or 64");
  static constexpr int kRowBytes = D == 16 ? 64 : 128;  // one swizzle span
  static constexpr int kBoxCols = kRowBytes / 4;        // floats a TMA box row
  static constexpr int kDescLayout = D == 16 ? 2 : 1;   // 64B, 128B
  static constexpr uint32_t kMask = D == 16 ? 3 : 7;
  static constexpr CUtensorMapSwizzle kTma =
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B;
  // byte offset of element (r, j) in a tile of R rows
  __device__ static __forceinline__ uint32_t offset(int R, int r, int j) {
    const uint32_t a = r * kRowBytes + (j % kBoxCols) * 4;
    return (j / kBoxCols) * R * kRowBytes + (a ^ (((a >> 7) & kMask) << 4));
  }
  // descriptor of k-step ks (floats 8 ks ..) of a tile of R rows
  __device__ static __forceinline__ uint64_t desc(uint32_t addr, int R, int ks) {
    const int byte = 32 * ks;
    return make_desc(addr + (byte / kRowBytes) * R * kRowBytes + byte % kRowBytes,
                     8 * kRowBytes, kDescLayout);
  }
};

struct Cols {
  __device__ static __forceinline__ uint32_t offset(int N, int n, int k) {
    const uint32_t a = n * 128 + (k % 32) * 4;
    return (k / 32) * N * 128 + (a ^ (((a >> 7) & 7) << 4));
  }
  __device__ static __forceinline__ uint64_t desc(uint32_t addr, int N, int ks) {
    return make_desc(addr + (ks / 4) * N * 128 + (ks % 4) * 32, 1024, 1);
  }
  // desc(addr, N, ks) - desc(addr, N, 0): the start address moves in its
  // low field, in 16-byte units
  __host__ __device__ static constexpr uint64_t step(int N, int ks) {
    return static_cast<uint64_t>(((ks / 4) * N * 128 + (ks % 4) * 32) >> 4);
  }
};

// Split the float4 at `off` of a Rows tile in place: hi stays, lo goes to
// the same offset of `lo_tile`.
__device__ __forceinline__ void split4_in_place(uint8_t* tile, uint8_t* lo_tile, uint32_t off) {
  float4 x = *reinterpret_cast<float4*>(tile + off), lo;
  split(x.x, x.x, lo.x);
  split(x.y, x.y, lo.y);
  split(x.z, x.z, lo.z);
  split(x.w, x.w, lo.w);
  *reinterpret_cast<float4*>(tile + off) = x;
  *reinterpret_cast<float4*>(lo_tile + off) = lo;
}

// Split a Rows tile of R rows in place, the float4s spread over `n`
// threads from thread `t`.
template <int D>
__device__ __forceinline__ void split_rows(uint8_t* tile, uint8_t* lo_tile, int R, int t, int n) {
  for (int i = t; i < R * D / 4; i += n)
    split4_in_place(tile, lo_tile, Rows<D>::offset(R, i / (D / 4), 4 * (i % (D / 4))));
}

#define TF32_D8(d, i)                                                                    \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]),            \
      "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 64, f32) (+)= A (64 x 8, shared, K-major) * B (8 x 64, shared,
// K-major rows of the N index), tf32. scale_d = 0 overwrites d.
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                           int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n}\n"
      : TF32_D8(d, 0), TF32_D8(d, 8), TF32_D8(d, 16), TF32_D8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N, f32) (+)= A (64 x 8, registers, tf32 bits) * B (8 x N, shared,
// K-major rows of the N index), tf32.
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : TF32_D8(d, 0), TF32_D8(d, 8), TF32_D8(d, 16), TF32_D8(d, 24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : TF32_D8(d, 0), TF32_D8(d, 8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  } else {
    static_assert(N == 16, "mma_rs: N must be 16, 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : TF32_D8(d, 0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
  }
}

#undef TF32_D8

// The A operands of k-steps 0..kSteps-1 from a score accumulator (m64n64,
// float[32] at the accumulator layout), split into hi and lo, columns in
// the permuted order of key_slot: a[0] = column 2c, a[2] = column 2c + 1.
template <int kSteps>
__device__ __forceinline__ void split_a(const float (&s)[32], uint32_t (&hi)[kSteps][4],
                                        uint32_t (&lo)[kSteps][4]) {
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const float x[4] = {s[4 * j], s[4 * j + 2], s[4 * j + 1], s[4 * j + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split(x[e], h, l);
      hi[j][e] = __float_as_uint(h);
      lo[j][e] = __float_as_uint(l);
    }
  }
}

// Tensor map of a row-major float32 tensor with `rank` dimensions,
// innermost first, box `box` (box[0] = Rows<D>::kBoxCols), swizzled as
// Rows<D>. Rows outside the tensor read as zero. Returns false on failure.
template <int D>
inline bool f32_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                    const cuuint32_t* box) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];
  cuuint64_t stride = 4;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, Rows<D>::kTma,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tf32
