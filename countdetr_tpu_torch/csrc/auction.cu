// Batched Jacobi forward auction for the stage-2 matcher, sm_90a: one
// thread-block cluster per image, the image's benefit rows resident in the
// cluster's distributed shared memory.
//
// Replaces countdetr_tpu/ops/pallas/auction_kernel.py::auction_assign (body
// _auction_round_kernel) and computes exactly what it and
// countdetr_tpu/ops/matching.py::_auction compute: the same bids, the same
// first-index tie-breaks, the same eps-scaling phases, so the assignments,
// round counts and bid counts are bit-identical to the plain version
// (ops/kernels/auction_kernel.py).
//
//   benefit (B, P, O) f32   value of object o for person p
//   active  (B, P)    u8    persons that must be assigned
//   eps     (B,)      f32   final bidding increment per image
//   out     (B, P)    i32   object per person (-1 only if max_iters was hit)
//   rounds  (B,)      i32   rounds run per image
//   bids    (B,)      i64   bids made per image over all rounds (zeroed by the caller)
//
// What bounds it on this card: the rounds are serial within an image (a
// sparse image in the T=700 tier runs to the 13248-round cap), so the time
// is rounds x (one row pass + the barriers of a round): latency, far from
// the bytes (the inputs read once) or the scan operations at the f32 peak.
// An earlier one-block design spent ~64 us a round: one SM per image, rows
// streamed from L2 by dependent scalar loads, three block barriers. This
// one spends ~5 us on 16 SMs (tools/auction_profile.py splits it by phase).
//
// Design. Image b runs on a cluster of C CTAs (C and the mode come from the
// wrapper's cluster_plan). CTA r holds
//   * persons [r*rp, (r+1)*rp) (rp = ceil(P/C)): their `assigned`, `active`
//     and, when `resident`, their benefit rows (pitch O4 = O rounded up to 4,
//     padding -inf), copied in once by cp.async at the start;
//   * a replica of all O prices, so a bid reads only local shared memory;
//   * the best bid of the round its own persons made for each of the O
//     objects (a 64-bit key), and an inbox where every CTA leaves its best
//     key for each object this CTA owns;
//   * objects r, r + C, r + 2C, ... (at most op = ceil(O/C); interleaved, so
//     the few contested objects of a sparse image spread over the CTAs):
//     their owner.
// A round:
//   1. bid: one half-warp per bidding row of the CTA (64 rows at once: at
//      C=16 a CTA's 36 rows take one pass, where whole warps took two),
//      lanes over O: float4 from shared memory (streamed: float4 __ldg when
//      O % 4 == 0, else scalar, loads issued four ahead), each lane in
//      increasing column order so it keeps the first index of its maximum
//      (branch-free min/max updates); a butterfly with a strict (value,
//      lower index) order gives v1, q1 and v2. The key
//      (order_bits(prices[q1] + ((v1 - v2) + eps)), ~person) goes by a
//      64-bit shared atomicMax into the CTA's own best[q1], so the highest
//      bid wins and the lowest person among equal bids. (The same
//      atomicMax into another CTA's shared memory, through map_shared_rank,
//      did not keep that order on this card: ties between CTAs went to the
//      wrong person.) After a block barrier the CTA sends each object's key
//      (where it has one) by a remote store into slot r of the owning
//      CTA's inbox for that object. A half-warp that bid writes the phase
//      number into slot r of every CTA's flag row;
//   2. cluster barrier; every CTA reads its flag row: did anyone bid?
//   3. award: each CTA settles its own objects: C lanes an object (C
//      rounded up to a power of 2) read the object's C inbox slots (local
//      shared memory), clear them and keep the largest key; then lane r
//      pushes the new price into CTA r's replica, and lane 0 sets the new
//      owner and writes `assigned` into the CTAs holding the winner and the
//      previous owner (the previous owner held no other object and did not
//      bid, so no person gets two writes);
//   4. cluster barrier.
// "Nobody bid" is the same as "every active person assigned after the last
// award", so the done test of round k rides on the bids of round k + 1 and
// costs no barrier of its own. When it finds the image done: stop if eps is
// final, else shrink eps, reset owners and assignments (local state only)
// and bid again at the same round number (the plain version shrinks at the
// end of round k and runs round k + 1 with the new eps: the same thing).
// Two cases need the test at once: an image with no active person (its
// rounds are a closed form of the eps schedule), and the iteration cap
// (one probe: if the last award completed a phase with eps above final,
// the plain version's reset shows as -1s).
// The f32 expressions are the plain version's, with explicit round-to-
// nearest intrinsics so the compiler can neither contract nor reorder them.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kRowLanes = 16;  // lanes that scan one bidding row: a half-warp
constexpr int kRowGroups = kThreads / kRowLanes;
constexpr int kMaxCluster = 16;
constexpr long long kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr float kHalfNegInf = -5e29f;   // NEG_INF / 2 with NEG_INF = -1e30
constexpr float kScaleStart = 512.0f;
constexpr float kScaleTheta = 8.0f;

enum Mode { kResident = 0, kStreamedVec = 1, kStreamedScalar = 2 };

// Shared memory of one CTA, in bytes: [rows (resident only)] prices [O4],
// best [O] (u64), inbox [op][C] (u64), owner [op], assigned [rp],
// flags [2][kMaxCluster], act [rp].
struct Layout {
  int O4, rp, op;
  long long rows, prices, best, inbox, owner, assigned, flags, act, total;
  __host__ __device__ Layout(int P, int O, int C, bool resident) {
    O4 = (O + 3) & ~3;
    rp = (P + C - 1) / C;
    op = (O + C - 1) / C;
    rows = 0;
    prices = resident ? 4LL * rp * O4 : 0;
    best = prices + 4LL * O4;  // O4 * 4 is a multiple of 16: best is 8-aligned
    inbox = best + 8LL * O;
    owner = inbox + 8LL * op * C;
    assigned = owner + 4LL * op;
    flags = assigned + 4LL * rp;
    act = flags + 4LL * 2 * kMaxCluster;
    total = act + rp;
  }
};

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

// One column of a lane's increasing scan, without branches: q1 moves only
// on a strict increase (the first index is kept), and a tie with v1 goes to
// v2 (max(v2, min(v1, val)) is the old v1 when val > v1, else max(v2, val)).
__device__ __forceinline__ void take(float val, int o, float& v1, float& v2, int& q1) {
  q1 = val > v1 ? o : q1;
  v2 = fmaxf(v2, fminf(v1, val));
  v1 = fmaxf(v1, val);
}

__device__ __forceinline__ void take4(float4 b, float4 pr, int o, float& v1, float& v2, int& q1) {
  take(__fsub_rn(b.x, pr.x), o, v1, v2, q1);
  take(__fsub_rn(b.y, pr.y), o + 1, v1, v2, q1);
  take(__fsub_rn(b.z, pr.z), o + 2, v1, v2, q1);
  take(__fsub_rn(b.w, pr.w), o + 3, v1, v2, q1);
}

template <int kMode>
__global__ void __launch_bounds__(kThreads, 1)
auction_cluster_kernel(const float* __restrict__ benefit, const uint8_t* __restrict__ active,
                       const float* __restrict__ eps, int32_t* __restrict__ out,
                       int32_t* __restrict__ rounds_out, long long* __restrict__ bids_out, int P,
                       int O, int max_iters, int scaling) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / C;
  const Layout lay(P, O, C, kMode == kResident);
  extern __shared__ __align__(16) uint8_t smem[];
  float* rows = reinterpret_cast<float*>(smem + lay.rows);
  float* prices = reinterpret_cast<float*>(smem + lay.prices);
  unsigned long long* best = reinterpret_cast<unsigned long long*>(smem + lay.best);
  unsigned long long* inbox = reinterpret_cast<unsigned long long*>(smem + lay.inbox);
  int* owner = reinterpret_cast<int*>(smem + lay.owner);
  int* assigned = reinterpret_cast<int*>(smem + lay.assigned);
  uint32_t* flags = reinterpret_cast<uint32_t*>(smem + lay.flags);
  uint8_t* act = smem + lay.act;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a bidding row is scanned by half-warp rg, its lanes rl = 0..15
  const int rg = tid / kRowLanes, rl = tid % kRowLanes;
  const unsigned half_mask = 0xffffu << (lane & 16);
  const int O4 = lay.O4, rp = lay.rp;
  const int p0 = rank * rp, np = max(0, min(P - p0, rp));  // this CTA's persons
  const int no = rank < O ? (O - rank + C - 1) / C : 0;  // this CTA's objects: rank + k C
  const float* ben = benefit + static_cast<size_t>(b) * P * O;
  const float eps_fin = eps[b];
  const float eps_stop = __fmul_rn(eps_fin, 1.5f);
  float cur_eps = scaling ? __fmul_rn(eps_fin, kScaleStart) : eps_fin;

  if (kMode == kResident) {
    const float* src = ben + static_cast<size_t>(p0) * O;
    const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(rows));
    if ((O & 3) == 0) {  // the CTA's rows are one contiguous, 16-byte aligned span
      for (int i = tid; i < np * O / 4; i += kThreads) cp_async16(dst + 16 * i, src + 4 * i);
    } else {
      for (int i = tid; i < np * O; i += kThreads)
        cp_async4(dst + 4 * ((i / O) * O4 + i % O), src + i);
      for (int i = tid; i < np * (O4 - O); i += kThreads)
        rows[(i / (O4 - O)) * O4 + O + i % (O4 - O)] = -INFINITY;
    }
  }
  for (int o = tid; o < O4; o += kThreads) prices[o] = 0.0f;
  for (int o = tid; o < O; o += kThreads) best[o] = 0ull;
  for (int o = tid; o < no; o += kThreads) owner[o] = -1;
  for (int i = tid; i < no * C; i += kThreads) inbox[i] = 0ull;
  for (int i = tid; i < 2 * kMaxCluster; i += kThreads) flags[i] = 0u;
  for (int i = tid; i < np; i += kThreads) {
    const uint8_t a = active[static_cast<size_t>(b) * P + p0 + i] != 0;
    act[i] = a;
    assigned[i] = a ? -1 : 0;
  }
  if (kMode == kResident) {
    cp_async_commit();
    cp_async_wait<0>();
  }
  cluster.sync();  // every CTA's state is initialised before any remote access

  // One phase of bids (probe: only say whether anyone would bid). Returns,
  // after a cluster barrier, whether any CTA of the image had a bidder.
  long long my_bids = 0;  // lane 0 of each half-warp: bids of its rows
  uint32_t seq = 0;
  auto bid_phase = [&](bool probe) -> bool {
    ++seq;
    bool bid_any = false;
    for (int i = rg; i < np; i += kRowGroups) {
      if (!act[i] || assigned[i] >= 0) continue;  // uniform in the half-warp
      bid_any = true;
      if (probe) break;
      float v1 = -INFINITY, v2 = -INFINITY;
      int q1 = O;
      if (kMode == kResident) {
        const float4* r4 = reinterpret_cast<const float4*>(rows + static_cast<size_t>(i) * O4);
        const float4* pr4 = reinterpret_cast<const float4*>(prices);
#pragma unroll 2
        for (int j = rl; j < O4 / 4; j += kRowLanes) take4(r4[j], pr4[j], 4 * j, v1, v2, q1);
      } else if (kMode == kStreamedVec) {
        const float4* r4 = reinterpret_cast<const float4*>(ben + static_cast<size_t>(p0 + i) * O);
        const float4* pr4 = reinterpret_cast<const float4*>(prices);
        const int n4 = O / 4;
        constexpr int S = kRowLanes;
        int j = rl;
        for (; j + 3 * S < n4; j += 4 * S) {  // four loads in flight, then in order
          const float4 a0 = __ldg(r4 + j), a1 = __ldg(r4 + j + S);
          const float4 a2 = __ldg(r4 + j + 2 * S), a3 = __ldg(r4 + j + 3 * S);
          take4(a0, pr4[j], 4 * j, v1, v2, q1);
          take4(a1, pr4[j + S], 4 * (j + S), v1, v2, q1);
          take4(a2, pr4[j + 2 * S], 4 * (j + 2 * S), v1, v2, q1);
          take4(a3, pr4[j + 3 * S], 4 * (j + 3 * S), v1, v2, q1);
        }
        for (; j < n4; j += S) take4(__ldg(r4 + j), pr4[j], 4 * j, v1, v2, q1);
      } else {
        const float* row = ben + static_cast<size_t>(p0 + i) * O;
        constexpr int S = kRowLanes;
        int o = rl;
        for (; o + 3 * S < O; o += 4 * S) {
          const float a0 = __ldg(row + o), a1 = __ldg(row + o + S);
          const float a2 = __ldg(row + o + 2 * S), a3 = __ldg(row + o + 3 * S);
          take(__fsub_rn(a0, prices[o]), o, v1, v2, q1);
          take(__fsub_rn(a1, prices[o + S]), o + S, v1, v2, q1);
          take(__fsub_rn(a2, prices[o + 2 * S]), o + 2 * S, v1, v2, q1);
          take(__fsub_rn(a3, prices[o + 3 * S]), o + 3 * S, v1, v2, q1);
        }
        for (; o < O; o += S) take(__fsub_rn(__ldg(row + o), prices[o]), o, v1, v2, q1);
      }
      for (int off = kRowLanes / 2; off > 0; off >>= 1) {
        const float ov1 = __shfl_xor_sync(half_mask, v1, off);
        const float ov2 = __shfl_xor_sync(half_mask, v2, off);
        const int oq1 = __shfl_xor_sync(half_mask, q1, off);
        if (beats(ov1, oq1, v1, q1)) {
          v2 = fmaxf(ov2, v1);
          v1 = ov1;
          q1 = oq1;
        } else {
          v2 = fmaxf(v2, ov1);
        }
      }
      if (rl == 0) {
        if (!(v2 > kHalfNegInf)) v2 = __fsub_rn(v1, 1.0f);  // O == 1
        const float incr = __fadd_rn(__fsub_rn(v1, v2), cur_eps);
        const float bid = __fadd_rn(prices[q1], incr);
        const unsigned long long key =
            (static_cast<unsigned long long>(order_bits(bid)) << 32) |
            static_cast<unsigned long long>(0xffffffffu - static_cast<uint32_t>(p0 + i));
        atomicMax(&best[q1], key);
        ++my_bids;
      }
    }
    if (!probe) {  // each object's best key of this CTA to its owner's inbox
      __syncthreads();
      for (int o = tid; o < O; o += kThreads) {
        const unsigned long long key = best[o];
        if (!key) continue;
        best[o] = 0ull;
        cluster.map_shared_rank(inbox, o % C)[(o / C) * C + rank] = key;
      }
    }
    // slot `rank` of every CTA's flag row (buffer seq % 2) says "bid in phase seq"
    if (bid_any && rl < C)
      *(cluster.map_shared_rank(flags, rl) + (seq & 1) * kMaxCluster + rank) = seq;
    cluster.sync();
    bool any = false;
    for (int r = 0; r < C; ++r) any |= flags[(seq & 1) * kMaxCluster + r] == seq;
    return any;
  };
  auto reset_phase = [&] {
    for (int o = tid; o < no; o += kThreads) owner[o] = -1;
    for (int i = tid; i < np; i += kThreads) assigned[i] = act[i] ? -1 : 0;
    __syncthreads();
  };

  int it = 0;
  bool first = true;
  while (true) {
    if (it >= max_iters) {
      // the cap: if the last award completed a phase with eps above final,
      // the plain version reset the assignment before it stopped
      if (it > 0 && cur_eps > eps_stop && !bid_phase(true)) reset_phase();
      break;
    }
    const bool any = bid_phase(false);
    const bool none_active = first && !any;
    first = false;
    if (!any) {  // every active person was assigned by the last award
      if (cur_eps <= eps_stop) break;
      if (none_active) {  // nobody ever bids: one round per eps step
        while (it < max_iters && cur_eps > eps_stop) {
          cur_eps = fmaxf(__fdiv_rn(cur_eps, kScaleTheta), eps_fin);
          ++it;
        }
        break;
      }
      cur_eps = fmaxf(__fdiv_rn(cur_eps, kScaleTheta), eps_fin);
      reset_phase();
      continue;  // bid again, same round
    }

    // award: this CTA's objects take their highest bidders; each group of
    // G lanes (C rounded up to a power of 2) takes one object, its lane
    // `sub` reading (and clearing) the key CTA `sub` sent to the inbox,
    // and writing the new price into CTA `sub`'s replica
    const int G = 1 << (32 - __clz(C - 1)), sub = lane % G;
    for (int kb = warp * (32 / G); kb < no; kb += kThreads / G) {  // warp-uniform
      const int k = kb + lane / G, o = rank + k * C;  // local slot, object
      unsigned long long key = 0ull;
      if (k < no && sub < C) {
        key = inbox[k * C + sub];
        if (key) inbox[k * C + sub] = 0ull;
      }
      for (int off = G / 2; off > 0; off >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
        key = other > key ? other : key;
      }
      if (k >= no || sub >= C || key == 0ull) continue;
      const float bid = from_order_bits(static_cast<uint32_t>(key >> 32));
      if (!(bid > kHalfNegInf)) continue;
      cluster.map_shared_rank(prices, sub)[o] = bid;
      if (sub != 0) continue;
      const int p = static_cast<int>(0xffffffffu - static_cast<uint32_t>(key));
      const int old = owner[k];
      owner[k] = p;
      cluster.map_shared_rank(assigned, p / rp)[p % rp] = o;
      if (old >= 0) cluster.map_shared_rank(assigned, old / rp)[old % rp] = -1;
    }
    cluster.sync();
    ++it;
  }

  for (int i = tid; i < np; i += kThreads) out[static_cast<size_t>(b) * P + p0 + i] = assigned[i];
  if (rl == 0 && my_bids) atomicAdd(reinterpret_cast<unsigned long long*>(bids_out + b),
                                      static_cast<unsigned long long>(my_bids));
  if (rank == 0 && tid == 0) rounds_out[b] = it;
  cluster.sync();  // no CTA leaves while another may still read its shared memory
}

template <int kMode>
cudaError_t configure(int P, int O, int C, cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int B, cudaStream_t stream) {
  const Layout lay(P, O, C, kMode == kResident);
  if (C < 1 || C > kMaxCluster || lay.total > kMaxSmem) return cudaErrorInvalidValue;
  auto kern = auction_cluster_kernel<kMode>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(lay.total));
  if (err != cudaSuccess) return err;
  if (C > 8) {  // 16 CTAs a cluster is beyond the portable 8
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(static_cast<unsigned>(B) * C);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = static_cast<size_t>(lay.total);
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = C;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

int mode_of(int resident, int O, const void* benefit) {
  if (resident) return kResident;
  return (O % 4 == 0 && reinterpret_cast<uintptr_t>(benefit) % 16 == 0) ? kStreamedVec
                                                                        : kStreamedScalar;
}

template <int kMode>
int max_clusters_m(int P, int O, int C, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kMode>(P, O, C, &cfg, &attr, 1, nullptr);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, auction_cluster_kernel<kMode>, &cfg));
}

template <int kMode>
int launch(const void* benefit, const void* active, const void* eps, void* out, void* rounds,
           void* bids, int B, int P, int O, int max_iters, int scaling, int C,
           cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t err = configure<kMode>(P, O, C, &cfg, &attr, B, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  int fits = 0;  // a cluster of C with this shared memory must be schedulable
  err = cudaOccupancyMaxActiveClusters(&fits, auction_cluster_kernel<kMode>, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (fits < 1) return static_cast<int>(cudaErrorLaunchOutOfResources);
  err = cudaLaunchKernelEx(&cfg, auction_cluster_kernel<kMode>,
                           static_cast<const float*>(benefit), static_cast<const uint8_t*>(active),
                           static_cast<const float*>(eps), static_cast<int32_t*>(out),
                           static_cast<int32_t*>(rounds), static_cast<long long*>(bids), P, O,
                           max_iters, scaling);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared-memory bytes one CTA needs for a cluster of C (resident: rows too).
extern "C" long long auction_smem_bytes(int P, int O, int C, int resident) {
  if (C < 1) return -1;
  return Layout(P, O, C, resident != 0).total;
}

// Clusters of C that can be resident on the card at once (0: none fits);
// returns the CUDA error of the query.
extern "C" int auction_max_active_clusters(int P, int O, int C, int resident, int* out) {
  *out = 0;
  if (resident) return max_clusters_m<kResident>(P, O, C, out);
  return max_clusters_m<kStreamedVec>(P, O, C, out);
}

// One cluster of C CTAs per image; `resident` keeps the rows in shared
// memory (cluster_plan decides both). Returns cudaGetLastError() after the
// launch; 0 means it was queued. `bids` must be zeroed by the caller.
extern "C" int auction_forward(const void* benefit, const void* active, const void* eps,
                               void* out, void* rounds, void* bids, int B, int P, int O,
                               int max_iters, int scaling, int C, int resident, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode_of(resident, O, benefit)) {
    case kResident:
      return launch<kResident>(benefit, active, eps, out, rounds, bids, B, P, O, max_iters,
                               scaling, C, s);
    case kStreamedVec:
      return launch<kStreamedVec>(benefit, active, eps, out, rounds, bids, B, P, O, max_iters,
                                  scaling, C, s);
    default:
      return launch<kStreamedScalar>(benefit, active, eps, out, rounds, bids, B, P, O,
                                     max_iters, scaling, C, s);
  }
}
