// Multi-head attention forward for Hopper (sm_90a).
//
// Replaces: countdetr_tpu/ops/pallas/mha_kernel.py::fused_mha (body
// _mha_kernel), the Pallas kernel of the decoder's query self-attention.
//
// Computes, per batch b, head n and query l (q pre-scaled by d^-1/2):
//   s[l, t] = q[l] . k[t] + bias[t]         (f32; bias is 0 or -1e30, f32)
//   p[l, t] = softmax_t(s[l, :])            (f32, then rounded to v's dtype)
//   out[l]  = sum_t p[l, t] * v[t]          (accumulated in f32)
// q/out are (B, L, E), k/v (B, S, E), bias (B, S); heads are taken by
// stride inside E. The bias is finite, never -inf: a row whose keys are all
// masked sees S equal logits and gets the uniform softmax, not NaN (the
// contract of countdetr_tpu/ops/pallas/mha_kernel.py:22-24).
//
// What bounds it on this card: at the decoder shape (B=32, L=S=576, 8 heads
// of d=32, bf16) the compulsory traffic is ~37.7 MB against 10.9 GFLOP, so
// on tensor cores it is bound by memory (11 us at 3.35 TB/s).
//
// What the design does about it:
//  * bf16 (the serving path): tensor cores, mma.sync m16n8k16 with f32
//    accumulation. One block of 4 warps per (64-query tile, head, batch),
//    each warp owning 16 queries. Three passes over the keys keep the
//    softmax exact without storing the logits: row max, row sum, then the
//    normalised probabilities, rounded to bf16 in the registers that hold
//    the scores, feed the PV product directly (a score tile's accumulator
//    layout is the A operand's). The QK^T products are recomputed per
//    pass, which is cheap on tensor cores; no (B, n, L, S) array reaches
//    device memory. Two layouts of the keys, chosen by S alone:
//    - resident (S up to ~1,500 at d=32): the head's K and V^T sit in
//      shared memory for all three passes;
//    - streamed (longer S, the stage-1 point tiers up to 5,600 and beyond):
//      K and V pass through shared memory in tiles of kKT keys, two tiles
//      in flight by cp.async, K once per pass and V in the third; only the
//      key bias row stays resident. The numerics are the resident layout's.
//  * float32: CUDA cores, one block of 128 threads per (32-query tile,
//    head, batch); the full logits row of every query stays in shared
//    memory, K and V stream through in 64-key chunks.

#include <cfloat>
#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;

// ---------------------------------------------------------------- bf16 ---

constexpr int kMmaTQ = 16 * kWarps;  // queries per block: 16 per warp

struct MmaLayout {  // shared memory in 32-bit words
  int s_pad, kp, vp, k, vt, bias, total;
  __host__ __device__ MmaLayout(int D, int S) {
    s_pad = (S + 15) & ~15;
    kp = frag_pitch(D / 2);       // K rows: bf16 pairs along d
    vp = frag_pitch(s_pad / 2);   // V^T rows: bf16 pairs along keys
    k = 0;
    vt = k + s_pad * kp;
    bias = vt + D * vp;
    total = bias + s_pad;
  }
};

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two rows of 8 bf16, one 16-byte chunk each.
struct Rows2 {
  uint4 a, b;
};

// Two rows of 8 bf16 (one uint4 each) interleaved into 8 words, word j =
// {a[j], b[j]}: a transposed 2 x 8 tile, as fragments of a k-major operand
// want it.
__device__ __forceinline__ void interleave_rows(const uint4& a, const uint4& b, uint32_t (&w)[8]) {
  const uint32_t av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[2 * i] = __byte_perm(av[i], bv[i], 0x5410);      // low halves
    w[2 * i + 1] = __byte_perm(av[i], bv[i], 0x7632);  // high halves
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
               __nv_bfloat16* __restrict__ out, int L, int S, int E) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  const MmaLayout lay(D, S);
  extern __shared__ __align__(16) uint32_t smem_w[];
  uint32_t* s_k = smem_w + lay.k;    // [s_pad][kp]
  uint32_t* s_vt = smem_w + lay.vt;  // [D][vp]
  float* s_b = reinterpret_cast<float*>(smem_w + lay.bias);

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kMmaTQ;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;
  // K rows and V^T rows in 16-byte chunks of 8 bf16, keys past S zero
  constexpr int CH = D / 8;
  const __nv_bfloat16* kb = k + b * S * E + hoff;
  const __nv_bfloat16* vb = v + b * S * E + hoff;
  auto chunk = [&](const __nv_bfloat16* base, int t, int ch) {
    return t < S ? *reinterpret_cast<const uint4*>(base + static_cast<size_t>(t) * E + ch * 8)
                 : make_uint4(0u, 0u, 0u, 0u);
  };
  staged_copy<8, kThreads>(
      lay.s_pad * CH, [&](int i) { return chunk(kb, i / CH, i % CH); },
      [&](int i, const uint4& u) {
        *reinterpret_cast<uint4*>(s_k + (i / CH) * lay.kp + (i % CH) * 4) = u;
      });
  staged_copy<4, kThreads>(
      lay.s_pad / 2 * CH,
      [&](int i) {
        const int t = 2 * (i / CH), ch = i % CH;
        return Rows2{chunk(vb, t, ch), chunk(vb, t + 1, ch)};
      },
      [&](int i, const Rows2& r) {
        uint32_t w[8];
        interleave_rows(r.a, r.b, w);
        const int tt = i / CH, c0 = (i % CH) * 8;
#pragma unroll
        for (int j = 0; j < 8; ++j) s_vt[(c0 + j) * lay.vp + tt] = w[j];
      });
  for (int i = tid; i < lay.s_pad; i += kThreads)
    s_b[i] = i < S ? bias[b * S + i] : -INFINITY;  // padded keys weigh 0
  __syncthreads();

  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = l0 + (tid / 32) * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + b * L * E + hoff;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    qa[ks][0] = r0 < L ? ld_pair(qb + static_cast<size_t>(r0) * E + c) : 0u;
    qa[ks][1] = r1 < L ? ld_pair(qb + static_cast<size_t>(r1) * E + c) : 0u;
    qa[ks][2] = r0 < L ? ld_pair(qb + static_cast<size_t>(r0) * E + c + 8) : 0u;
    qa[ks][3] = r1 < L ? ld_pair(qb + static_cast<size_t>(r1) * E + c + 8) : 0u;
  }

  // scores of rows (g, g+8) against keys n0 + 2t, n0 + 2t + 1
  auto scores = [&](int n0, float (&s)[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    const uint32_t* kr = s_k + (n0 + g) * lay.kp;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) mma_bf16(s, qa[ks], kr[ks * 8 + t4], kr[ks * 8 + 4 + t4]);
    const float b0 = s_b[n0 + 2 * t4], b1 = s_b[n0 + 2 * t4 + 1];
    s[0] += b0;
    s[1] += b1;
    s[2] += b0;
    s[3] += b1;
  };
  auto quad_max = [](float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };
  auto quad_sum = [](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };

  // pass 1: row maxima
  float m0 = -FLT_MAX, m1 = -FLT_MAX;
  for (int n0 = 0; n0 < lay.s_pad; n0 += 8) {
    float s[4];
    scores(n0, s);
    m0 = fmaxf(m0, fmaxf(s[0], s[1]));
    m1 = fmaxf(m1, fmaxf(s[2], s[3]));
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // pass 2: row sums of exp(s - max)
  float z0 = 0.f, z1 = 0.f;
  for (int n0 = 0; n0 < lay.s_pad; n0 += 8) {
    float s[4];
    scores(n0, s);
    z0 += expf(s[0] - m0) + expf(s[1] - m0);
    z1 += expf(s[2] - m1) + expf(s[3] - m1);
  }
  const float rz0 = 1.f / quad_sum(z0), rz1 = 1.f / quad_sum(z1);

  // pass 3: p = exp(s - max) / sum rounded to bf16, out += p V (times the
  // reciprocal: within an ulp of the quotient before the bf16 rounding)
  float acc[D / 8][4] = {};
  for (int n0 = 0; n0 < lay.s_pad; n0 += 16) {
    float s0[4], s1[4];
    scores(n0, s0);
    scores(n0 + 8, s1);
    const uint32_t pa[4] = {
        pack_bf16(expf(s0[0] - m0) * rz0, expf(s0[1] - m0) * rz0),
        pack_bf16(expf(s0[2] - m1) * rz1, expf(s0[3] - m1) * rz1),
        pack_bf16(expf(s1[0] - m0) * rz0, expf(s1[1] - m0) * rz0),
        pack_bf16(expf(s1[2] - m1) * rz1, expf(s1[3] - m1) * rz1),
    };
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const uint32_t* vr = s_vt + (nt * 8 + g) * lay.vp + n0 / 2;
      mma_bf16(acc[nt], pa, vr[t4], vr[4 + t4]);
    }
  }

  __nv_bfloat16* ob = out + b * L * E + hoff;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int c = nt * 8 + 2 * t4;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * E + c) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * E + c) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Streamed layout: the bias row [s_pad] resident, then two stages, each a
// tile of kKT key rows (pitch kp words) and kKT value rows as stored
// (pitch (D + 8) / 2 words, read by ldmatrix.trans).
constexpr int kKT = 128;  // keys per streamed tile

struct StreamLayout {  // shared memory in 32-bit words
  int s_pad, kp, vp, bias, k, v, stage, total;
  __host__ __device__ StreamLayout(int D, int S) {
    s_pad = (S + kKT - 1) / kKT * kKT;
    kp = frag_pitch(D / 2);
    vp = (D + 8) / 2;
    bias = 0;
    k = bias + s_pad;
    v = k + kKT * kp;
    stage = kKT * (kp + vp);
    total = k + 2 * stage;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
mha_mma_stream_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                      __nv_bfloat16* __restrict__ out, int L, int S, int E) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  const StreamLayout lay(D, S);
  extern __shared__ __align__(16) uint32_t smem_w[];
  float* s_b = reinterpret_cast<float*>(smem_w + lay.bias);

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kMmaTQ;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;
  for (int i = tid; i < lay.s_pad; i += kThreads)
    s_b[i] = i < S ? bias[b * S + i] : -INFINITY;  // padded keys weigh 0

  // Step i of the 3 * nt steps is pass i / nt over key tile i % nt; step i
  // uses stage i % 2, and step i + 1's tile is copied in while step i runs.
  // Keys past S are zero rows (stored directly), so no stale value enters.
  constexpr int CH = D / 8;  // 16-byte chunks per row
  const int nt = lay.s_pad / kKT;
  const __nv_bfloat16* kb = k + b * S * E + hoff;
  const __nv_bfloat16* vb = v + b * S * E + hoff;
  const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem_w));
  auto stage_k = [&](int step) { return lay.k + (step % 2) * lay.stage; };
  auto copy_rows = [&](const __nv_bfloat16* src, int t0, int words0, int pitch) {
    for (int i = tid; i < kKT * CH; i += kThreads) {
      const int r = i / CH, ch = i % CH;
      const int dst = words0 + r * pitch + ch * 4;
      if (t0 + r < S)
        cp_async16(smem_addr + dst * 4, src + static_cast<size_t>(t0 + r) * E + ch * 8);
      else
        *reinterpret_cast<uint4*>(smem_w + dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto issue = [&](int step) {
    if (step < 3 * nt) {
      const int t0 = (step % nt) * kKT;
      copy_rows(kb, t0, stage_k(step), lay.kp);
      if (step >= 2 * nt) copy_rows(vb, t0, stage_k(step) + kKT * lay.kp, lay.vp);
    }
    cp_async_commit();
  };
  issue(0);

  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int r0 = l0 + (tid / 32) * 16 + g, r1 = r0 + 8;
  const __nv_bfloat16* qb = q + b * L * E + hoff;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t4;
    qa[ks][0] = r0 < L ? ld_pair(qb + static_cast<size_t>(r0) * E + c) : 0u;
    qa[ks][1] = r1 < L ? ld_pair(qb + static_cast<size_t>(r1) * E + c) : 0u;
    qa[ks][2] = r0 < L ? ld_pair(qb + static_cast<size_t>(r0) * E + c + 8) : 0u;
    qa[ks][3] = r1 < L ? ld_pair(qb + static_cast<size_t>(r1) * E + c + 8) : 0u;
  }

  // scores of rows (g, g+8) against keys n0 + 2t, n0 + 2t + 1 of a tile
  auto scores = [&](const uint32_t* s_k, int t0, int n0, float (&s)[4]) {
    s[0] = s[1] = s[2] = s[3] = 0.f;
    const uint32_t* kr = s_k + (n0 + g) * lay.kp;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) mma_bf16(s, qa[ks], kr[ks * 8 + t4], kr[ks * 8 + 4 + t4]);
    const float b0 = s_b[t0 + n0 + 2 * t4], b1 = s_b[t0 + n0 + 2 * t4 + 1];
    s[0] += b0;
    s[1] += b1;
    s[2] += b0;
    s[3] += b1;
  };
  auto quad_max = [](float x) {
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  };
  auto quad_sum = [](float x) {
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    return x + __shfl_xor_sync(0xffffffffu, x, 2);
  };
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 16;
  const int vrow_bytes = lay.vp * 4;

  float m0 = -FLT_MAX, m1 = -FLT_MAX, z0 = 0.f, z1 = 0.f, rz0 = 0.f, rz1 = 0.f;
  float acc[D / 8][4] = {};
  for (int step = 0; step < 3 * nt; ++step) {
    cp_async_wait<0>();  // this thread's copies of the step's tile landed
    __syncthreads();     // everyone's did, and the other stage is free again
    issue(step + 1);
    const int pass = step / nt, t0 = (step % nt) * kKT;
    const uint32_t* s_k = smem_w + stage_k(step);
    if (pass == 0) {  // row maxima
      for (int n0 = 0; n0 < kKT; n0 += 8) {
        float s[4];
        scores(s_k, t0, n0, s);
        m0 = fmaxf(m0, fmaxf(s[0], s[1]));
        m1 = fmaxf(m1, fmaxf(s[2], s[3]));
      }
      if (step == nt - 1) {
        m0 = quad_max(m0);
        m1 = quad_max(m1);
      }
    } else if (pass == 1) {  // row sums of exp(s - max)
      for (int n0 = 0; n0 < kKT; n0 += 8) {
        float s[4];
        scores(s_k, t0, n0, s);
        z0 += expf(s[0] - m0) + expf(s[1] - m0);
        z1 += expf(s[2] - m1) + expf(s[3] - m1);
      }
      if (step == 2 * nt - 1) {
        rz0 = 1.f / quad_sum(z0);
        rz1 = 1.f / quad_sum(z1);
      }
    } else {  // p rounded to bf16, out += p V
      const uint32_t s_v = smem_addr + (stage_k(step) + kKT * lay.kp) * 4;
      for (int n0 = 0; n0 < kKT; n0 += 16) {
        float s0[4], s1[4];
        scores(s_k, t0, n0, s0);
        scores(s_k, t0, n0 + 8, s1);
        const uint32_t pa[4] = {
            pack_bf16(expf(s0[0] - m0) * rz0, expf(s0[1] - m0) * rz0),
            pack_bf16(expf(s0[2] - m1) * rz1, expf(s0[3] - m1) * rz1),
            pack_bf16(expf(s1[0] - m0) * rz0, expf(s1[1] - m0) * rz0),
            pack_bf16(expf(s1[2] - m1) * rz1, expf(s1[3] - m1) * rz1),
        };
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {  // two n-tiles of 8 channels
          uint32_t bf[4];
          ldmatrix_x4_trans(s_v + (n0 + lm_row) * vrow_bytes + np * 32 + lm_col, bf);
          mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
        }
      }
    }
  }

  __nv_bfloat16* ob = out + b * L * E + hoff;
#pragma unroll
  for (int nt8 = 0; nt8 < D / 8; ++nt8) {
    const int c = nt8 * 8 + 2 * t4;
    if (r0 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * E + c) =
          pack_bf16(acc[nt8][0], acc[nt8][1]);
    if (r1 < L)
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * E + c) =
          pack_bf16(acc[nt8][2], acc[nt8][3]);
  }
}

// ------------------------------------------------------------- float32 ---

constexpr int kTQ = 32;  // queries per block
constexpr int kKC = 64;  // keys per streamed chunk

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

// floats of shared memory: K/V chunk, q tile, bias row, logits [kTQ][S+1]
__host__ __device__ inline int f32_smem_floats(int D, int S) {
  return kKC * (D + 1) + kTQ * (D + 1) + S + kTQ * (S + 1);
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
  const int SP = S + 1;  // logits pitch: column reads stay conflict-free

  extern __shared__ __align__(16) float smem[];
  float* s_kv = smem;               // [kKC][P] keys, or [kKC][D] values
  float* s_q = s_kv + kKC * P;      // [kTQ][P]
  float* s_b = s_q + kTQ * P;       // [S]
  float* s_s = s_b + S;             // [kTQ][SP]

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * kTQ;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;

  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int l = i / D, j = i % D;
    s_q[l * P + j] = l0 + l < L ? q[(b * L + l0 + l) * E + hoff + j] : 0.f;
  }
  for (int i = tid; i < S; i += kThreads) s_b[i] = bias[b * S + i];

  // 1. logits: a 4 x 4 register tile per thread, queries tq + 8i and keys
  //    tk + 16c, so neighbouring lanes read neighbouring rows
  const int tq = tid / 16, tk = tid % 16;
  for (int s0 = 0; s0 < S; s0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kKC * D; i += kThreads) {
      const int t = i / D, j = i % D;
      s_kv[t * P + j] = s0 + t < S ? k[(b * S + s0 + t) * E + hoff + j] : 0.f;
    }
    __syncthreads();
    float acc[4][4] = {};
#pragma unroll 8
    for (int j = 0; j < D; ++j) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(tq + 8 * i) * P + j];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = s_kv[(tk + 16 * c) * P + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(qv[i], kv[c], acc[i][c]);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int t = s0 + tk + 16 * c;
      if (t >= S) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) s_s[(tq + 8 * i) * SP + t] = acc[i][c] + s_b[t];
    }
  }
  __syncthreads();

  // 2. softmax, one warp per query row
  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < kTQ; r += kWarps) {
    float* row = s_s + r * SP;
    float m = -FLT_MAX;
    for (int t = lane; t < S; t += 32) m = fmaxf(m, row[t]);
    m = warp_max(m);
    float sum = 0.f;
    for (int t = lane; t < S; t += 32) {
      const float e = expf(row[t] - m);
      row[t] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int t = lane; t < S; t += 32) row[t] /= sum;
  }

  // 3. out = P V, values streamed in chunks
  const int cg = tid % CG, qg = tid / CG;
  float acc[QPT][4] = {};
  for (int s0 = 0; s0 < S; s0 += kKC) {
    __syncthreads();
    for (int i = tid; i < kKC * D; i += kThreads) {
      const int t = i / D, j = i % D;
      s_kv[i] = s0 + t < S ? v[(b * S + s0 + t) * E + hoff + j] : 0.f;
    }
    __syncthreads();
    const int n = min(kKC, S - s0);
    for (int t = 0; t < n; ++t) {
      const float4 vv = *reinterpret_cast<const float4*>(s_kv + t * D + cg * 4);
#pragma unroll
      for (int i = 0; i < QPT; ++i) {
        const float p = s_s[(qg + QG * i) * SP + s0 + t];
        acc[i][0] = fmaf(p, vv.x, acc[i][0]);
        acc[i][1] = fmaf(p, vv.y, acc[i][1]);
        acc[i][2] = fmaf(p, vv.z, acc[i][2]);
        acc[i][3] = fmaf(p, vv.w, acc[i][3]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < QPT; ++i) {
    const int l = l0 + qg + QG * i;
    if (l >= L) continue;
    float* o = out + (b * L + l) * E + hoff + cg * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = acc[i][c];
  }
}

// ------------------------------------------------------------ dispatch ---

// The bf16 kernel keeps the head's keys resident when they fit, else streams.
bool streamed(int D, int S) {
  return static_cast<size_t>(MmaLayout(D, S).total) * sizeof(uint32_t) >
         static_cast<size_t>(kMaxSmem);
}

size_t smem_bytes(int dtype, int D, int S) {
  if (dtype == 0) return static_cast<size_t>(f32_smem_floats(D, S)) * sizeof(float);
  const int words = streamed(D, S) ? StreamLayout(D, S).total : MmaLayout(D, S).total;
  return static_cast<size_t>(words) * sizeof(uint32_t);
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, const float* bias,
           void* out, int B, int L, int S, int E, int num_heads, cudaStream_t stream) {
  const size_t smem = smem_bytes(dtype, D, S);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = mha_f32_kernel<D>;
    err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + kTQ - 1) / kTQ, num_heads, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), L, S, E);
  } else {
    auto kern = streamed(D, S) ? mha_mma_stream_kernel<D> : mha_mma_kernel<D>;
    err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + kMmaTQ - 1) / kMmaTQ, num_heads, B);
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), L, S, E);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 for q, k, v and out; bias is float32.
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int mha_forward(int dtype, const void* q, const void* k,
                           const void* v, const void* bias, void* out, int B,
                           int L, int S, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || (dtype != 0 && dtype != 1))
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

// Shared-memory bytes one block needs at key length S.
extern "C" long long mha_smem_bytes(int dtype, int D, int S) {
  return static_cast<long long>(smem_bytes(dtype, D, S));
}

// 1 if the bf16 kernel streams the keys at S (0: resident).
extern "C" int mha_streamed(int D, int S) { return streamed(D, S) ? 1 : 0; }
