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
// kernel rounds the unnormalised exp(s - m_running) and divides the f32
// sum at the end, and takes exp as 2^(s log2(e) + bias log2(e) - m). Held
// against mha_core_plain at 1e-2 (bf16) and 1e-4 (f32).
//
// What bounds it on this card: at d = 32 a score costs 128 tensor-core
// operations but one exponential, and the SFU does 16 ex2 a clock per SM
// (4.2e12/s at 1.98 GHz on 132 SMs). At B=8, S=5600 the 2.0e9
// exponentials take 0.48 ms and the 257 GFLOP 0.26 ms, so the exponentials
// set the floor; at B=32, S=576 the exponentials (0.020 ms) come before the
// bytes (37.7 MB, 0.011 ms). So the design spends one ex2 per score and
// keeps everything else off the SFU:
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
//  * float32 (parity only): CUDA cores, one block of 128 threads per
//    (32-query tile, head, batch); keys and values stream through shared
//    memory in 64-key chunks, one chunk of logits at a time.

#include <cfloat>
#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"

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
                 __nv_bfloat16* __restrict__ out, int L, int S, int E) {
  using Lay = Bf16Layout<D>;
  constexpr int kRow = Swizzle<D>::kRowBytes;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + Lay::bias);  // [kStages][kBK]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Lay::bars);
  uint64_t* empty = full + kStages;
  uint64_t* q_full = empty + kStages;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int l0 = blockIdx.x * kBQ, head = blockIdx.y, b = blockIdx.z;
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
    // p = 2^(x - m): summed unrounded, packed to bf16 as the A operand
    uint32_t pa[kBK / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[4 * j + e] - mx[e >> 1]);
        l[e >> 1] += p[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
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

  const float z0 = quad_sum(l[0]), z1 = quad_sum(l[1]);
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

// ------------------------------------------------------------- float32 ---

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTQ = 32;  // queries per block
constexpr int kKC = 64;  // keys per chunk

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               float* __restrict__ out, int L, int S, int E) {
  constexpr int P = D + 1;
  constexpr int CG = D / 4;             // output channel groups of 4
  constexpr int QG = kThreads / CG;     // output query groups
  constexpr int QPT = kTQ / QG;         // output queries per thread
  static_assert(QPT >= 1 && kTQ % QG == 0, "tile does not cover the queries");
  constexpr int SP = kKC + 1;           // chunk logits pitch

  __shared__ float s_q[kTQ * P];
  __shared__ __align__(16) float s_kv[kKC * P];  // the chunk's keys, then its values
  __shared__ float s_p[kTQ * SP];       // the chunk's logits, then exp(s - m)
  __shared__ float s_alpha[kTQ], s_m[kTQ], s_l[kTQ];

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kTQ;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;

  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int l = i / D, j = i % D;
    s_q[l * P + j] = l0 + l < L ? q[(b * L + l0 + l) * E + hoff + j] : 0.f;
  }
  if (tid < kTQ) {
    s_m[tid] = -FLT_MAX;
    s_l[tid] = 0.f;
  }

  const int tq = tid / 16, tk = tid % 16;   // logits: queries tq + 8i, keys tk + 16c
  const int warp = tid / 32, lane = tid % 32;
  const int cg = tid % CG, qg = tid / CG;   // output: queries qg + QG i, channels 4cg..
  float acc[QPT][4] = {};
  for (int s0 = 0; s0 < S; s0 += kKC) {
    __syncthreads();  // the previous chunk's values and probabilities are consumed
    for (int i = tid; i < kKC * D; i += kThreads) {
      const int t = i / D, j = i % D;
      s_kv[t * P + j] = s0 + t < S ? k[(b * S + s0 + t) * E + hoff + j] : 0.f;
    }
    __syncthreads();
    // 1. the chunk's logits, keys past S at -inf
    float a[4][4] = {};
#pragma unroll 8
    for (int j = 0; j < D; ++j) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(tq + 8 * i) * P + j];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) kv[cc] = s_kv[(tk + 16 * cc) * P + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) a[i][cc] = fmaf(qv[i], kv[cc], a[i][cc]);
    }
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int t = s0 + tk + 16 * cc;
      const float bt = t < S ? bias[b * S + t] : -INFINITY;
#pragma unroll
      for (int i = 0; i < 4; ++i) s_p[(tq + 8 * i) * SP + tk + 16 * cc] = a[i][cc] + bt;
    }
    __syncthreads();  // logits written, keys no longer read
    // 2. online softmax, one warp per row; 3. the chunk's values in
    for (int r = warp; r < kTQ; r += kWarps) {
      float* row = s_p + r * SP;
      const float x0 = row[lane], x1 = row[lane + 32];
      const float m_old = s_m[r];
      const float m_new = fmaxf(m_old, warp_max(fmaxf(x0, x1)));
      const float e0 = expf(x0 - m_new), e1 = expf(x1 - m_new);
      row[lane] = e0;
      row[lane + 32] = e1;
      const float sum = warp_sum(e0 + e1);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        s_alpha[r] = alpha;
        s_m[r] = m_new;
        s_l[r] = s_l[r] * alpha + sum;
      }
    }
    for (int i = tid; i < kKC * D; i += kThreads) {
      const int t = i / D, j = i % D;
      s_kv[t * D + j] = s0 + t < S ? v[(b * S + s0 + t) * E + hoff + j] : 0.f;
    }
    __syncthreads();
    // 4. out = out * alpha + p V
    const int n = min(kKC, S - s0);
#pragma unroll
    for (int i = 0; i < QPT; ++i) {
      const float al = s_alpha[qg + QG * i];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) acc[i][cc] *= al;
    }
    for (int t = 0; t < n; ++t) {
      const float4 vv = *reinterpret_cast<const float4*>(s_kv + t * D + cg * 4);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float p = s_p[(qg + QG * i) * SP + t];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int r = qg + QG * i, l = l0 + r;
    if (l >= L) continue;
    const float z = s_l[r];
    float* o = out + (b * L + l) * E + hoff + cg * 4;
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) o[cc] = acc[i][cc] / z;
  }
}

// ------------------------------------------------------------ dispatch ---

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int L, int S, int E, int num_heads, cudaStream_t stream) {
  if (dtype == 0) {
    const dim3 grid((L + kTQ - 1) / kTQ, num_heads, B);
    mha_f32_kernel<D><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), L, S, E);
    return static_cast<int>(cudaGetLastError());
  }
  // (E, L|S, B) views, boxes of {D, 64, 1} at column head * D
  CUtensorMap map_q, map_k, map_v;
  const cuuint64_t dims_q[3] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(L),
                                static_cast<cuuint64_t>(B)};
  const cuuint64_t dims_kv[3] = {static_cast<cuuint64_t>(E), static_cast<cuuint64_t>(S),
                                 static_cast<cuuint64_t>(B)};
  const cuuint32_t box[3] = {D, kBK, 1};
  if (!bf16_map<D>(&map_q, q, 3, dims_q, box) || !bf16_map<D>(&map_k, k, 3, dims_kv, box) ||
      !bf16_map<D>(&map_v, v, 3, dims_kv, box))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = mha_wgmma_kernel<D>;
  const int smem = Bf16Layout<D>::alloc;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + kBQ - 1) / kBQ, num_heads, B);
  kern<<<grid, kBf16Threads, smem, stream>>>(map_q, map_k, map_v, bias,
                                             static_cast<__nv_bfloat16*>(out), L, S, E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and out; bias is float32.
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int mha_forward(int dtype, const void* q, const void* k,
                           const void* v, const void* bias, void* out, int B,
                           int L, int S, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || (dtype != 0 && dtype != 1) || S <= 0)
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
