// Helpers shared by the kernels: bf16 packing, and staging of global data
// into shared memory (batched loads, cp.async).

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

// Two floats rounded to bf16 (round to nearest even) in one word, lo first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

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

// 16- and 4-byte asynchronous copies global -> shared (cp.async; the
// 16-byte one bypasses L1), grouped by commit and waited for by group count.
__device__ __forceinline__ void cp_async16(uint32_t smem_addr, const void* gptr) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr), "l"(gptr));
}
__device__ __forceinline__ void cp_async4(uint32_t smem_addr, const void* gptr) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {  // all but the newest kPending groups
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}
