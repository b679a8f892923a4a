// Helpers shared by the kernels: warp-level bf16 tensor-core products
// (sm_80+ mma.sync, ldmatrix) and staging of global data into shared
// memory (batched loads, cp.async).
//
// mma_bf16 computes C += A * B for one 16x8x16 tile: A row-major 16x16,
// B column-major 16x8, C 16x8 in float32. With g = lane / 4 and t = lane % 4
// a thread holds
//   A: a[0] = A[g][2t, 2t+1]     a[1] = A[g+8][2t, 2t+1]
//      a[2] = A[g][2t+8, 2t+9]   a[3] = A[g+8][2t+8, 2t+9]
//   B: b[0] = B[2t, 2t+1][g]     b[1] = B[2t+8, 2t+9][g]
//   C: c[0] = C[g][2t]  c[1] = C[g][2t+1]  c[2] = C[g+8][2t]  c[3] = C[g+8][2t+1]
// where each of a[] and b[] packs two bf16, the lower index in the low half.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even) in one word, lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Shared-memory row pitch in 32-bit words for bf16 operands read as
// fragments: at least `words`, and 4 mod 8, so the eight rows g = 0..7
// that a fragment load touches start in banks 0, 4, ..., 28 and the four
// t-offsets fill the rest: no bank conflicts.
__host__ __device__ inline int frag_pitch(int words) { return (words + 3) / 8 * 8 + 4; }

// Copy n items global -> shared, kBatch per thread at a time: every load of
// a batch is issued before the first store, so a thread waits for one
// memory latency per batch instead of one per item. load(i) returns item i
// (its value type is free), store(i, value) writes it; i runs over [0, n)
// with the block's threads interleaved.
template <int kBatch, int kThreadsPerBlock, typename Load, typename Store>
__device__ __forceinline__ void staged_copy(int n, Load load, Store store) {
  for (int base = threadIdx.x; base < n; base += kThreadsPerBlock * kBatch) {
    decltype(load(0)) regs[kBatch];
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = base + r * kThreadsPerBlock;
      if (i < n) regs[r] = load(i);
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int i = base + r * kThreadsPerBlock;
      if (i < n) store(i, regs[r]);
    }
  }
}

// 16-byte asynchronous copy global -> shared (cp.async, bypassing L1),
// grouped by commit and waited for by group count.
__device__ __forceinline__ void cp_async16(uint32_t smem_addr, const void* gptr) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest kPending groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Four 8x8 bf16 tiles from shared memory, transposed on delivery: lane i
// gives the address of row i % 8 of tile i / 8, and r[m] then holds
// tile m's elements (2t, g) and (2t+1, g): for a row-major k x n operand
// in shared memory, exactly the B fragment of mma_bf16.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t smem_addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr));
}
