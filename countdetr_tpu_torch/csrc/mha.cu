// Multi-head attention forward for Hopper (sm_90a).
//
// Replaces: countdetr_tpu/ops/pallas/mha_kernel.py::fused_mha (body
// _mha_kernel), the Pallas kernel of the decoder's query self-attention.
//
// Computes, per batch b, head n and query l (q pre-scaled by d^-1/2):
//   s[l, t] = q[l] . k[t] + bias[t]         (f32; bias is 0 or -1e30, f32)
//   p[l, t] = softmax_t(s[l, :])            (f32)
//   out[l]  = sum_t p[l, t] * v[t]          (accumulated in f32)
// q/out are (B, L, E), k/v (B, S, E), bias (B, S); heads are taken by
// stride inside E. The bias is finite, never -inf: a row whose keys are all
// masked sees S equal logits and gets the uniform softmax, not NaN (the
// contract of countdetr_tpu/ops/pallas/mha_kernel.py:22-24).
//
// One pass over the keys with an online softmax (the flash-attention
// shape), for every S and both dtypes: a running row max m and row sum l
// in f32; each key tile's probabilities exp(s - m) are summed into l
// unrounded, rescale the output by exp(m_old - m_new) when the max grows,
// and the output is divided by l once at the end. No row of logits is kept.
//
// Numerics against the TPU kernel: in bf16 the TPU kernel rounds the
// normalised p to bf16 before the PV product (mha_kernel.py:57); this
// kernel does too where a row's keys fit one 64-key tile, and past that
// rounds the unnormalised exp(s - m_running) and divides the f32 sum at
// the end, and takes exp as 2^(s log2(e) + bias log2(e) - m). Held
// against mha_core_plain at max(1e-2, 1 bf16 ulp of the output) (bf16) and
// 1e-4 (f32).
//
// Grid: (query tiles x batch, heads); the batch rides on gridDim.x, so
// any batch fits (the level layer runs one batch row per pixel).
//
// What bounds it on this card: at d = 32 a score costs 128 tensor-core
// operations but one exponential, and the SFU does 16 ex2 a clock per SM
// (4.2e12/s at 1.98 GHz on 132 SMs). At B=8, S=5600 the 2.0e9
// exponentials take 0.48 ms and the 257 GFLOP 0.26 ms (bf16), so the
// exponentials set the floor; at B=32, S=576 the exponentials (0.020 ms)
// come before the bytes (37.7 MB, 0.011 ms). So the design spends one ex2
// per score and keeps everything else off the SFU:
//  * bf16 (the serving path): one block per (64-query tile, head, batch):
//    one consumer warpgroup and one producer warp. The producer loads the
//    Q tile once and K/V tiles of 64 keys by TMA into a 4-stage ring
//    (full/empty mbarriers, no block-wide barrier per tile), with the key
//    bias row of the tile beside them. The consumer computes S = Q K^T by
//    wgmma m64n64k16 from shared memory (both operands K-major, D/16
//    k-steps), the online softmax in registers with one ex2 per score, and
//    O += P V by wgmma m64nDk16 with P packed to bf16 straight from the
//    score accumulators (register A) and V's tile read as stored ([key][d],
//    the transposed-B form). Keys past S arrive as zero rows (TMA fill) and
//    get bias -inf, so they weigh exactly 0; m starts at -FLT_MAX, so
//    exp2(m_old - m_new) is never -inf - -inf.
//  * float32 (the CLI's default dtype): every product in 3xTF32 on the
//    tensor cores (tf32.cuh), so f32 accuracy at 495 / 3 TFLOP/s, which
//    bounds it: 0.372 ms of operations at B=32 L=S=1369, against 0.115 of
//    exponentials. The bf16 kernel's block (a TMA producer warp, one
//    consumer warpgroup per 64-query tile, the online softmax with one ex2
//    per score) with f32 tiles in a 2-stage K/V ring, 3 blocks a SM. The
//    consumer splits Q once and each K tile in place (hi; lo beside it),
//    the B operands of S = Q K^T (3 chains of wgmma m64n64k8 from shared
//    memory, K-major on both sides). tf32 wgmma reads shared operands only
//    K-major and V lands [key][d], so each V tile is split and transposed
//    into V^T hi and lo (a warp takes 32 consecutive keys of one column
//    group: conflict-free both ways), keys in the order the score
//    accumulator holds them (tf32.cuh's key_slot), and P, split in
//    registers, is the A operand of the tile's P V (3 chains of m64nDk8),
//    which lands in an accumulator of its own and is added to O in f32
//    registers (O = O alpha + P V): the tensor cores' f32 accumulation
//    truncates, so O carried through every tile's products drifted with S
//    (max error 4.9e-6 at B=8 S=576, 1.3e-5 at B=32 S=1369; 8.6e-7 and
//    2.6e-6 with one round-to-nearest add a tile, at the same speed). The
//    split, the transposition and the softmax are ~750 instructions a
//    thread a key tile beside ~840 cycles of tensor-core time a tile (3
//    blocks' consumers on the 4 schedulers), so it runs at ~37% of the
//    bound (1.01 ms at B=32 L=S=1369; SDPA f32 3.69; PERF.md).
//    A 64-row query tile is ahead of the float32 kernel this one replaced
//    (CUDA cores, 32-query tiles) even where it is nearly empty: the level
//    layer's L = S = 3, 0.73 vs 0.77 ms at B=8064 (PERF.md), so every
//    float32 call takes it.

#include <cfloat>
#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "tf32.cuh"

namespace {

using namespace hopper;

constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16 ---

constexpr int kBQ = 64;       // queries per block: one consumer warpgroup
constexpr int kBK = 64;       // keys per tile
constexpr int kStages = 4;    // K/V tiles in flight
constexpr int kConsumers = 128;
constexpr int kBf16Threads = kConsumers + 32;  // plus the producer warp

// Shared memory in bytes from a 1024-aligned base: the Q tile, the K and V
// rings, the bias ring, the barriers.
template <int D>
struct Bf16Layout {
  static constexpr int kTile = kBK * D * 2;  // a 64-row tile (a multiple of 1024)
  static constexpr int q = 0;
  static constexpr int k = q + kTile;
  static constexpr int v = k + kStages * kTile;
  static constexpr int bias = v + kStages * kTile;
  static constexpr int bars = bias + kStages * kBK * 4;
  static constexpr int total = bars + (2 * kStages + 1) * 8;
  static constexpr int alloc = total + 1024;  // slack to align the base
};

template <int D>
__global__ void __launch_bounds__(kBf16Threads)
mha_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                 const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias,
                 __nv_bfloat16* __restrict__ out, int L, int S, int E, int tiles) {
  using Lay = Bf16Layout<D>;
  constexpr int kRow = Swizzle<D>::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + Lay::bias);  // [kStages][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // blockIdx.x = b * tiles + query tile: any batch fits gridDim.x
  const int b = blockIdx.x / tiles, l0 = (blockIdx.x % tiles) * kBQ, head = blockIdx.y;
  const int nt = (S + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);           // the producer warp's lanes, one with the bytes
      mbar_init(&empty[s], kConsumers);  // every consumer thread
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: Q once, then each key tile into stage t % kStages once the
    // consumers have released it
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Lay::kTile);
      tma_load_3d(smem + Lay::q, &map_q, q_full, head * D, l0, b);
    }
    const float* bb = bias + static_cast<size_t>(b) * S;
    for (int t = 0; t < nt; ++t) {
      const int st = t % kStages;
      mbar_wait(&empty[st], ((t / kStages) & 1) ^ 1);
      for (int i = lane; i < kBK; i += 32) {
        const int key = t * kBK + i;
        // in the log2 domain; padded keys weigh 0
        s_bias[st * kBK + i] = key < S ? bb[key] * kLog2e : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * Lay::kTile);
        tma_load_3d(smem + Lay::k + st * Lay::kTile, &map_k, &full[st], head * D, t * kBK, b);
        tma_load_3d(smem + Lay::v + st * Lay::kTile, &map_v, &full[st], head * D, t * kBK, b);
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w + g and 16w + g + 8
  const int g = lane / 4, c = lane % 4;
  const uint32_t q_addr = smem_u32(smem + Lay::q);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};  // log2 domain max, partial sums
  mbar_wait(q_full, 0);

  for (int t = 0; t < nt; ++t) {
    const int st = t % kStages;
    mbar_wait(&full[st], (t / kStages) & 1);
    const uint32_t k_addr = smem_u32(smem + Lay::k + st * Lay::kTile);
    const uint32_t v_addr = smem_u32(smem + Lay::v + st * Lay::kTile);

    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss_n64(s, desc<D>(q_addr + 32 * ks), desc<D>(k_addr + 32 * ks), ks);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // x = s log2(e) + bias log2(e), the tile's row max, the rescale factor
    const float* bs = s_bias + st * kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * j + e], kLog2e, bs[8 * j + 2 * c + (e & 1)]);
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
    // p = 2^(x - m), summed unrounded
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(s[4 * j + e] - mx[e >> 1]);
        l[e >> 1] += s[4 * j + e];
      }
    // a row whose keys fit one tile (the level layer's 3, the short point
    // tiers) is normalised before its bf16 rounding, as the plain version
    // and the TPU kernel round it; longer rows divide at the end
    if (nt == 1) {
      float inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] = quad_sum(l[r]);
        inv[r] = 1.f / l[r];
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= inv[(i >> 1) & 1];
    }
    // packed to bf16 as the A operand
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      pa[j / 2][(j % 2) * 2] = pack_bf16(s[4 * j], s[4 * j + 1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
    }
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] *= alpha[0];
      o[4 * i + 1] *= alpha[0];
      o[4 * i + 2] *= alpha[1];
      o[4 * i + 3] *= alpha[1];
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      wgmma_rs<D>(o, pa[kk], desc<D>(v_addr + 16 * kRow * kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    mbar_arrive(&empty[st]);
  }

  // (one tile: p was normalised already)
  const float z0 = nt == 1 ? 1.f : quad_sum(l[0]), z1 = nt == 1 ? 1.f : quad_sum(l[1]);
  const int r0 = l0 + warp * 16 + g, r1 = r0 + 8;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * L * E + head * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * E + col) =
          pack_bf16(o[4 * i] / z0, o[4 * i + 1] / z0);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * E + col) =
          pack_bf16(o[4 * i + 2] / z1, o[4 * i + 3] / z1);
  }
}

// ------------------------------------------------ float32, tensor cores ---

constexpr int kF32Stages = 2;  // K/V tiles in flight

// Shared memory in bytes from a 1024-aligned base, every tile 64 rows of D
// floats (Rows<D>) or D rows of 64 keys (Cols): Q (split to hi in place)
// and its lo part, the lo part of the current K tile, V^T's hi and lo
// parts, the K and V rings as TMA lands them, the bias ring, the barriers.
template <int D>
struct F32Layout {
  static constexpr int kTile = kBK * D * 4;  // a multiple of 1024
  static constexpr int q = 0;
  static constexpr int q_lo = q + kTile;
  static constexpr int k_lo = q_lo + kTile;
  static constexpr int vt_hi = k_lo + kTile;
  static constexpr int vt_lo = vt_hi + kTile;
  static constexpr int k = vt_lo + kTile;
  static constexpr int v = k + kF32Stages * kTile;
  static constexpr int bias = v + kF32Stages * kTile;
  static constexpr int bars = bias + kF32Stages * kBK * 4;
  static constexpr int total = bars + (2 * kF32Stages + 1) * 8;
  static constexpr int alloc = total + 1024;  // slack to align the base
};

// Blocks a SM: 3 at D <= 32; at D = 64 the shared memory holds one, and
// the block may take every register it wants.
template <int D>
__global__ void __launch_bounds__(kBf16Threads, D == 64 ? 1 : 3)
mha_tf32_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias,
                float* __restrict__ out, int L, int S, int E, int tiles) {
  using Lay = F32Layout<D>;
  using R = tf32::Rows<D>;
  using tf32::Cols;
  constexpr int kBoxes = D / R::kBoxCols;     // TMA boxes a tile (2 at D = 64)
  constexpr int kBox = kBK * R::kRowBytes;    // bytes of one box
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + Lay::bias);  // [kF32Stages][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bars);
  uint64_t* empty = full + kF32Stages;
  uint64_t* q_full = empty + kF32Stages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = blockIdx.x / tiles, l0 = (blockIdx.x % tiles) * kBQ, head = blockIdx.y;
  const int nt = (S + kBK - 1) / kBK;
  if (tid == 0) {
    for (int s = 0; s < kF32Stages; ++s) {
      mbar_init(&full[s], 32);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_init(q_full, 1);
    fence_barrier_init();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {
    // producer: Q once, then each key tile into stage t % kF32Stages once
    // the consumers have released it
    if (lane == 0) {
      mbar_arrive_expect_tx(q_full, Lay::kTile);
      for (int x = 0; x < kBoxes; ++x)
        tma_load_3d(smem + Lay::q + x * kBox, &map_q, q_full, head * D + x * R::kBoxCols, l0, b);
    }
    const float* bb = bias + static_cast<size_t>(b) * S;
    for (int t = 0; t < nt; ++t) {
      const int st = t % kF32Stages;
      mbar_wait(&empty[st], ((t / kF32Stages) & 1) ^ 1);
      for (int i = lane; i < kBK; i += 32) {
        const int key = t * kBK + i;
        s_bias[st * kBK + i] = key < S ? bb[key] * kLog2e : -INFINITY;
      }
      if (lane == 0) {
        mbar_arrive_expect_tx(&full[st], 2 * Lay::kTile);
        for (int x = 0; x < kBoxes; ++x) {
          const int col = head * D + x * R::kBoxCols;
          tma_load_3d(smem + Lay::k + st * Lay::kTile + x * kBox, &map_k, &full[st], col,
                      t * kBK, b);
          tma_load_3d(smem + Lay::v + st * Lay::kTile + x * kBox, &map_v, &full[st], col,
                      t * kBK, b);
        }
      } else {
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  // consumer warpgroup: warp w owns rows 16w + g and 16w + g + 8
  const int g = lane / 4, c = lane % 4;
  const uint32_t q_hi = smem_u32(smem + Lay::q), q_lo = smem_u32(smem + Lay::q_lo);
  const uint32_t k_lo = smem_u32(smem + Lay::k_lo);
  const uint32_t vt_hi = smem_u32(smem + Lay::vt_hi), vt_lo = smem_u32(smem + Lay::vt_lo);
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};  // log2 domain max, partial sums
  mbar_wait(q_full, 0);
  tf32::split_rows<D>(smem + Lay::q, smem + Lay::q_lo, kBQ, tid, kConsumers);

  for (int t = 0; t < nt; ++t) {
    const int st = t % kF32Stages;
    uint8_t* k_st = smem + Lay::k + st * Lay::kTile;
    const uint8_t* v_st = smem + Lay::v + st * Lay::kTile;
    mbar_wait(&full[st], (t / kF32Stages) & 1);
    tf32::bar_sync(1, kConsumers);  // the last tile's products are done in every warp
    // K: hi in place, lo beside it; V: hi and lo transposed to V^T (keys
    // in the permuted order of the score accumulator). A warp takes 32
    // consecutive keys of one column group: conflict-free both ways.
    tf32::split_rows<D>(k_st, smem + Lay::k_lo, kBK, tid, kConsumers);
    for (int i = tid; i < kBK * D / 4; i += kConsumers) {
      const int key = i % kBK, j = 4 * (i / kBK);
      const float4 x4 = *reinterpret_cast<const float4*>(v_st + R::offset(kBK, key, j));
      const float x[4] = {x4.x, x4.y, x4.z, x4.w};
      const int slot = tf32::key_slot(key);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float hi, lo;
        tf32::split(x[e], hi, lo);
        const uint32_t off = Cols::offset(D, j + e, slot);
        *reinterpret_cast<float*>(smem + Lay::vt_hi + off) = hi;
        *reinterpret_cast<float*>(smem + Lay::vt_lo + off) = lo;
      }
    }
    tf32::fence_proxy_async();
    tf32::bar_sync(1, kConsumers);

    // S = Q K^T in 3xTF32: hi lo + lo hi, then hi hi
    const uint32_t k_hi = smem_u32(k_st);
    float s[32];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      tf32::mma_ss_n64(s, R::desc(q_hi, kBQ, ks), R::desc(k_lo, kBK, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      tf32::mma_ss_n64(s, R::desc(q_lo, kBQ, ks), R::desc(k_hi, kBK, ks), 1);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks)
      tf32::mma_ss_n64(s, R::desc(q_hi, kBQ, ks), R::desc(k_hi, kBK, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // x = s log2(e) + bias log2(e), the tile's row max, the rescale factor
    const float* bs = s_bias + st * kBK;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * j + e], kLog2e, bs[8 * j + 2 * c + (e & 1)]);
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    mbar_arrive(&empty[st]);  // the stage's K, V and bias are consumed
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = ex2(m[r] - mx[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[4 * j + e] = ex2(s[4 * j + e] - mx[e >> 1]);
        l[e >> 1] += s[4 * j + e];
      }
    // the tile's P V^T in 3xTF32 (P split in registers as the A operand)
    // into an accumulator of its own, then O = O alpha + P V^T in f32
    // registers: the tensor cores' accumulation truncates, so carrying O
    // through every key tile's products biased it further with every tile
    // (the error grew with S); one round-to-nearest add a tile does not
    uint32_t p_hi[kBK / 8][4], p_lo[kBK / 8][4];
    tf32::split_a<kBK / 8>(s, p_hi, p_lo);
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) tf32::mma_rs<D>(pv, p_hi[kk], Cols::desc(vt_lo, D, kk), kk);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) tf32::mma_rs<D>(pv, p_lo[kk], Cols::desc(vt_hi, D, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBK / 8; ++kk) tf32::mma_rs<D>(pv, p_hi[kk], Cols::desc(vt_hi, D, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(pv);
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      o[4 * i] = fmaf(o[4 * i], alpha[0], pv[4 * i]);
      o[4 * i + 1] = fmaf(o[4 * i + 1], alpha[0], pv[4 * i + 1]);
      o[4 * i + 2] = fmaf(o[4 * i + 2], alpha[1], pv[4 * i + 2]);
      o[4 * i + 3] = fmaf(o[4 * i + 3], alpha[1], pv[4 * i + 3]);
    }
  }

  const float z0 = quad_sum(l[0]), z1 = quad_sum(l[1]);
  const int r0 = l0 + warp * 16 + g, r1 = r0 + 8;
  float* ob = out + static_cast<size_t>(b) * L * E + head * D;
#pragma unroll
  for (int i = 0; i < D / 8; ++i) {
    const int col = 8 * i + 2 * c;
    if (r0 < L)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r0) * E + col) =
          make_float2(o[4 * i] / z0, o[4 * i + 1] / z0);
    if (r1 < L)
      *reinterpret_cast<float2*>(ob + static_cast<size_t>(r1) * E + col) =
          make_float2(o[4 * i + 2] / z1, o[4 * i + 3] / z1);
  }
}

// ------------------------------------------------------------ dispatch ---

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int L, int S, int E, int num_heads, cudaStream_t stream) {
  // the batch rides on gridDim.x with the query tiles (gridDim.z stops at
  // 65535; the level layer's batch is B*H*W pixels)
  // (E, L|S, B) views, boxes of {D, 64, 1} at column head * D
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t dims_q[3] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t dims_kv[3] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(B)};
  if (dtype == 0) {
    // float32 on the tensor cores: boxes of one swizzle span of floats,
    // {D, 64, 1} at D <= 32 and two {32, 64, 1} at D = 64
    const cuuint32_t box32[3] = {tf32::Rows<D>::kBoxCols, kBK, 1};
    if (!tf32::f32_map<D>(&map_q, q, 3, dims_q, box32) ||
        !tf32::f32_map<D>(&map_k, k, 3, dims_kv, box32) ||
        !tf32::f32_map<D>(&map_v, v, 3, dims_kv, box32))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = mha_tf32_kernel<D>;
    const int smem = F32Layout<D>::alloc;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (L + kBQ - 1) / kBQ;
    if (static_cast<long long>(tiles) * B > 0x7fffffffLL)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    const dim3 grid(tiles * B, num_heads);
    kern<<<grid, kBf16Threads, smem, stream>>>(map_q, map_k, map_v, bias,
                                               static_cast<float*>(out), L, S, E, tiles);
    return static_cast<int>(cudaGetLastError());
  }
  const cuuint32_t box[3] = {D, kBK, 1};
  if (!bf16_map<D>(&map_q, q, 3, dims_q, box) || !bf16_map<D>(&map_k, k, 3, dims_kv, box) ||
      !bf16_map<D>(&map_v, v, 3, dims_kv, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mha_wgmma_kernel<D>;
  const int smem = Bf16Layout<D>::alloc;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (L + kBQ - 1) / kBQ;
  if (static_cast<long long>(tiles) * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const dim3 grid(tiles * B, num_heads);
  kern<<<grid, kBf16Threads, smem, stream>>>(map_q, map_k, map_v, bias,
                                             static_cast<__nv_bfloat16*>(out), L, S, E, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (3xTF32 on the tensor cores), 1 = bfloat16, for q, k,
// v and out; bias is float32.
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int mha_forward(int dtype, const void* q, const void* k,
                           const void* v, const void* bias, void* out, int B,
                           int L, int S, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || dtype < 0 || dtype > 1 || S <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* bf = static_cast<const float*>(bias);
  switch (E / num_heads) {
    case 16: return launch<16>(dtype, q, k, v, bf, out, B, L, S, E, num_heads, s);
    case 32: return launch<32>(dtype, q, k, v, bf, out, B, L, S, E, num_heads, s);
    case 64: return launch<64>(dtype, q, k, v, bf, out, B, L, S, E, num_heads, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
