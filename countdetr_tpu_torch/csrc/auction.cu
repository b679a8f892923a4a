// Batched Jacobi forward auction for the stage-2 matcher, sm_90a.
//
// Replaces countdetr_tpu/ops/pallas/auction_kernel.py::auction_assign (body
// _auction_round_kernel) and computes exactly what it and
// countdetr_tpu/ops/matching.py::_auction compute: the same bids, the same
// first-index tie-breaks, the same eps-scaling phases, so the assignments
// are bit-identical to the plain version (ops/kernels/auction_kernel.py).
//
//   benefit (B, P, O) f32   value of object o for person p
//   active  (B, P)    u8    persons that must be assigned
//   eps     (B,)      f32   final bidding increment per image
//   out     (B, P)    i32   object per person (-1 only if max_iters was hit)
//   rounds  (B,)      i32   rounds run per image
//   bids    (B,)      i64   bids made per image over all rounds (rows read)
//
// Design. One thread block per image runs the whole round loop, so every
// image exits as soon as it is done; nothing is synchronised across blocks.
// Per-object state (best bid of the round as a 64-bit key, price, owner)
// and per-person state (assigned, active) live in shared memory: 16 bytes
// an object, 5 a person (~95 KB at O=5600, P=576). Benefit rows stay in
// device memory (L2-resident at the main path's 8x576x700: 12.9 MB) and are
// streamed: only the rows of unassigned active persons are read, one warp
// per row, lanes striding over O. A round is
//   1. bid: per bidding row, v1 and its first index q1, v2 = the max over
//      the other columns (v1 - 1 if there is none); the bid
//      prices[q1] + ((v1 - v2) + eps) goes into best[q1] by a 64-bit
//      shared atomicMax on (order-preserving bits of the bid, ~person), so
//      the highest bid wins and the lowest person index among equal bids,
//      whatever order the atomics land in;
//   2. after a barrier, each object with a bid takes its winner and price;
//      the winner's `assigned` is set and the previous owner's cleared
//      (the previous owner held no other object and did not bid);
//   3. done = no active person unassigned (__syncthreads_or); at the end
//      of an eps-scaling phase eps shrinks and the assignment restarts.
// Every bid of a round reads the prices of the start of the round (Jacobi).
// The f32 expressions are the plain version's, with explicit round-to-
// nearest intrinsics so the compiler can neither contract nor reorder them.
//
// Bound: the function reads its inputs once from HBM (12.9 MB at
// 8x576x700) and scans O columns per bid, one subtract and one compare
// each; chip_smoke.py takes the larger of the bytes over 3.35 TB/s and this
// run's scan operations over the f32 peak: the operations once there are
// more than 40*P bids, else the bytes. The rows that each round re-reads
// from L2 (4*O bytes a bidder) are this design's traffic, not the
// function's. In practice a round is serial within an image, so only B of
// the 132 SMs work and the time is rounds x (one row pass plus three
// barriers): latency, not bandwidth or arithmetic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kHalfNegInf = -5e29f;  // NEG_INF / 2 with NEG_INF = -1e30
constexpr float kScaleStart = 512.0f;
constexpr float kScaleTheta = 8.0f;

__device__ __forceinline__ uint32_t order_bits(float x) {
  const uint32_t u = __float_as_uint(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// (v1, q1) ordered by value, then by the lower index: a strict total order,
// so both lanes of a butterfly pair keep the same winner.
__device__ __forceinline__ bool beats(float va, int qa, float vb, int qb) {
  return va > vb || (va == vb && qa < qb);
}

__global__ void __launch_bounds__(kThreads)
auction_kernel(const float* __restrict__ benefit, const uint8_t* __restrict__ active,
               const float* __restrict__ eps, int32_t* __restrict__ out,
               int32_t* __restrict__ rounds_out, long long* __restrict__ bids_out, int P, int O,
               int max_iters, int scaling) {
  extern __shared__ unsigned long long smem[];
  __shared__ unsigned long long bid_count;
  unsigned long long* best = smem;                          // O
  float* prices = reinterpret_cast<float*>(best + O);       // O
  int* owner = reinterpret_cast<int*>(prices + O);          // O
  int* assigned = owner + O;                                // P
  uint8_t* act = reinterpret_cast<uint8_t*>(assigned + P);  // P

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* ben = benefit + static_cast<size_t>(b) * P * O;
  const float eps_fin = eps[b];
  const float eps_stop = __fmul_rn(eps_fin, 1.5f);
  float cur_eps = scaling ? __fmul_rn(eps_fin, kScaleStart) : eps_fin;

  if (tid == 0) bid_count = 0ull;
  for (int o = tid; o < O; o += kThreads) {
    best[o] = 0ull;
    prices[o] = 0.0f;
    owner[o] = -1;
  }
  int pending = 0;
  for (int p = tid; p < P; p += kThreads) {
    const uint8_t a = active[static_cast<size_t>(b) * P + p] != 0;
    act[p] = a;
    assigned[p] = a ? -1 : 0;
    pending |= a;
  }
  const bool none_active = !__syncthreads_or(pending);
  bool done = none_active;

  int it = 0;
  while (it < max_iters && !(done && cur_eps <= eps_stop)) {
    // 1. bids of the unassigned active persons, one warp per row
    for (int p = warp; p < P; p += kWarps) {
      if (!act[p] || assigned[p] >= 0) continue;  // warp-uniform
      const float* row = ben + static_cast<size_t>(p) * O;
      float v1 = -INFINITY, v2 = -INFINITY;
      int q1 = O;
      for (int o = lane; o < O; o += 32) {  // increasing o: first index kept
        const float val = __fsub_rn(__ldg(row + o), prices[o]);
        if (val > v1) {
          v2 = v1;
          v1 = val;
          q1 = o;
        } else if (val > v2) {
          v2 = val;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov1 = __shfl_xor_sync(0xffffffffu, v1, off);
        const float ov2 = __shfl_xor_sync(0xffffffffu, v2, off);
        const int oq1 = __shfl_xor_sync(0xffffffffu, q1, off);
        if (beats(ov1, oq1, v1, q1)) {
          v2 = fmaxf(ov2, v1);
          v1 = ov1;
          q1 = oq1;
        } else {
          v2 = fmaxf(v2, ov1);
        }
      }
      if (lane == 0) {
        if (!(v2 > kHalfNegInf)) v2 = __fsub_rn(v1, 1.0f);  // O == 1
        const float incr = __fadd_rn(__fsub_rn(v1, v2), cur_eps);
        const float bid = __fadd_rn(prices[q1], incr);
        const unsigned long long key =
            (static_cast<unsigned long long>(order_bits(bid)) << 32) |
            static_cast<unsigned long long>(0xffffffffu - static_cast<uint32_t>(p));
        atomicMax(&best[q1], key);
        atomicAdd(&bid_count, 1ull);
      }
    }
    __syncthreads();

    // 2. each object takes its highest bidder
    for (int o = tid; o < O; o += kThreads) {
      const unsigned long long key = best[o];
      if (key == 0ull) continue;
      best[o] = 0ull;
      const float bid = from_order_bits(static_cast<uint32_t>(key >> 32));
      if (!(bid > kHalfNegInf)) continue;
      const int p = static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
      const int old = owner[o];
      owner[o] = p;
      prices[o] = bid;
      assigned[p] = o;
      if (old >= 0) assigned[old] = -1;
    }
    __syncthreads();

    // 3. done, and the eps-scaling phase boundary
    int open = 0;
    for (int p = tid; p < P; p += kThreads) open |= act[p] && assigned[p] < 0;
    done = !__syncthreads_or(open);
    if (done && cur_eps > eps_stop) {  // block-uniform
      cur_eps = fmaxf(__fdiv_rn(cur_eps, kScaleTheta), eps_fin);
      for (int o = tid; o < O; o += kThreads) owner[o] = -1;
      for (int p = tid; p < P; p += kThreads) assigned[p] = act[p] ? -1 : 0;
      done = none_active;
      __syncthreads();
    }
    ++it;
  }

  for (int p = tid; p < P; p += kThreads) out[static_cast<size_t>(b) * P + p] = assigned[p];
  if (tid == 0) {
    rounds_out[b] = it;
    bids_out[b] = static_cast<long long>(bid_count);
  }
}

}  // namespace

extern "C" long long auction_smem_bytes(int P, int O) {
  return 16LL * O + 5LL * P;
}

extern "C" int auction_forward(const void* benefit, const void* active, const void* eps,
                               void* out, void* rounds, void* bids, int B, int P, int O,
                               int max_iters, int scaling, void* stream) {
  const long long smem = auction_smem_bytes(P, O);
  cudaError_t err = cudaFuncSetAttribute(
      auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<B, kThreads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(benefit), static_cast<const uint8_t*>(active),
      static_cast<const float*>(eps), static_cast<int32_t*>(out), static_cast<int32_t*>(rounds),
      static_cast<long long*>(bids), P, O, max_iters, scaling);
  return static_cast<int>(cudaGetLastError());
}
