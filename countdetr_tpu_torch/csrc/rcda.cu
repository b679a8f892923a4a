// Row-Column Decoupled Attention core for Hopper (sm_90a).
//
// Replaces: countdetr_tpu/ops/pallas/rcda_kernel.py::fused_rcda (body
// _rcda_kernel), the Pallas/Mosaic kernel of the JAX package.
//
// Computes, per batch b, head n and query l (q pre-scaled by d^-1/2):
//   a_row[l, w] = softmax_w(q_row[l] . k_row[w] + bias_row[w])   (f32, then
//                 rounded to the value dtype, as the TPU kernel does)
//   a_col[l, h] = softmax_h(q_col[l] . k_col[h] + bias_col[h])   (f32)
//   out[l, :]   = sum_h a_col[l, h] * sum_w a_row[l, w] * v[h, w, :]
// with every product accumulated in f32. q_row/q_col/out are (B, L, E),
// k_row (B, W, E), k_col (B, H, E), v (B, H, W, E), biases (B, W)/(B, H);
// heads are taken by stride inside E, so the caller transposes nothing.
//
// What bounds it on this card: the combine. At the encoder shape (B=32,
// L=1369, H=W=37, 8 heads of d=32) it is 30.7 of the 33.2 GFLOP, against
// ~90 MB of compulsory bf16 traffic, so the kernel is bound by arithmetic
// (34 us on bf16 tensor cores).
//
// What the design does about it: one block of 128 threads per (query tile,
// head, batch). The q tile, both key slices and both probability maps stay
// in shared memory for the whole block. Scores and softmaxes run one
// thread per (query, axis) row on the CUDA cores, lanes on consecutive
// queries, so every shared access is conflict-free. Then the combine:
//  * bf16 (the serving path): tensor cores. For each H row, the partial
//    sums a_row (16 queries x W, padded to 16) times v[h] (W x d) are
//    mma.sync m16n8k16 products with f32 accumulation, one 16-query slab
//    per warp, a_row held in registers for all H rows; a_col[l, h] then
//    weights them into the f32 output in registers. Value rows stream
//    through a ring of kStages cp.async slots in shared memory, as stored
//    (w-major), and reach the B operand by ldmatrix.trans; the ring reuses
//    the score phase's scratch, dead once a_row is packed to bf16, so four
//    blocks share an SM.
//  * float32: CUDA cores, each thread a 4 query x 4 channel register tile,
//    two float4 shared reads per 16 FMAs, one value row staged at a time.
// The Mosaic workarounds of the TPU kernel (the 0/1 fold matrix,
// pltpu.repeat, the (B, n, W, d*H) value reshuffle) have no counterpart:
// on CUDA the head-weighted combine is a plain accumulation in registers.

#include <cfloat>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90
constexpr int kMaxAxisBf16 = 64;  // H, W limit of the tensor-core path

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Shared-memory layout of the score phase, in 4-byte words from `base`:
// the probability maps a_col [H][TL] and a_row [W][TL] in f32, then the
// scratch the scores are computed from, dead once a_row is consumed: q
// tiles and key slices with pitch D + 4 (float4 rows) and the biases.
struct ScoreLayout {
  int acol, arow, qr, qc, kr, kc, br, bc, end;
  __host__ __device__ ScoreLayout(int TL, int D, int H, int W, int base = 0) {
    const int P = D + 4;
    acol = base;
    arow = acol + H * TL;
    qr = arow + W * TL;
    qc = qr + TL * P;
    kr = qc + TL * P;
    kc = kr + W * P;
    br = kc + H * P;
    bc = br + W;
    end = bc + H;
  }
};

// Stage the q tile, the head's key slices and the biases, then write both
// softmaxes into s + lay.arow / lay.acol (zero for queries past L). Ends
// with the probabilities written by each thread; the caller synchronises.
template <typename T, int D, int TL>
__device__ void scores_and_softmax(
    float* s, const ScoreLayout& lay, const T* q_row, const T* q_col,
    const T* k_row, const T* k_col, const T* bias_row, const T* bias_col,
    size_t b, int l0, int hoff, int L, int H, int W, int E) {
  constexpr int P = D + 4;
  const int tid = threadIdx.x;
  float* s_qr = s + lay.qr;
  float* s_qc = s + lay.qc;
  float* s_kr = s + lay.kr;
  float* s_kc = s + lay.kc;
  float* s_br = s + lay.br;
  float* s_bc = s + lay.bc;
  staged_copy<16, kThreads>(
      TL * D,
      [&](int i) {
        const int l = i / D, j = i % D;
        float2 q = make_float2(0.f, 0.f);
        if (l0 + l < L) {
          const size_t g = (b * L + l0 + l) * E + hoff + j;
          q = make_float2(to_f(q_row[g]), to_f(q_col[g]));
        }
        return q;
      },
      [&](int i, float2 q) {
        const int l = i / D, j = i % D;
        s_qr[l * P + j] = q.x;
        s_qc[l * P + j] = q.y;
      });
  staged_copy<16, kThreads>(
      W * D, [&](int i) { return to_f(k_row[(b * W + i / D) * E + hoff + i % D]); },
      [&](int i, float x) { s_kr[(i / D) * P + i % D] = x; });
  staged_copy<16, kThreads>(
      H * D, [&](int i) { return to_f(k_col[(b * H + i / D) * E + hoff + i % D]); },
      [&](int i, float x) { s_kc[(i / D) * P + i % D] = x; });
  for (int i = tid; i < W; i += kThreads) s_br[i] = to_f(bias_row[b * W + i]);
  for (int i = tid; i < H; i += kThreads) s_bc[i] = to_f(bias_col[b * H + i]);
  __syncthreads();

  for (int r = tid; r < 2 * TL; r += kThreads) {
    const bool is_row = r < TL;
    const int l = is_row ? r : r - TL;
    const int K = is_row ? W : H;
    const float* q = (is_row ? s_qr : s_qc) + l * P;
    const float* k = is_row ? s_kr : s_kc;
    const float* bias = is_row ? s_br : s_bc;
    float* a = s + (is_row ? lay.arow : lay.acol) + l;
    float4 qv[D / 4];
#pragma unroll
    for (int j = 0; j < D / 4; ++j) qv[j] = reinterpret_cast<const float4*>(q)[j];
    float m = -FLT_MAX;
    for (int kk = 0; kk < K; ++kk) {
      // four independent partial sums; the key row is a broadcast read
      const float4* kv = reinterpret_cast<const float4*>(k + kk * P);
      float4 acc4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < D / 4; ++j) {
        const float4 kj = kv[j];
        acc4.x = fmaf(qv[j].x, kj.x, acc4.x);
        acc4.y = fmaf(qv[j].y, kj.y, acc4.y);
        acc4.z = fmaf(qv[j].z, kj.z, acc4.z);
        acc4.w = fmaf(qv[j].w, kj.w, acc4.w);
      }
      const float sc = ((acc4.x + acc4.y) + (acc4.z + acc4.w)) + bias[kk];
      a[kk * TL] = sc;
      m = fmaxf(m, sc);
    }
    float sum = 0.f;
    for (int kk = 0; kk < K; ++kk) {
      const float e = expf(a[kk * TL] - m);
      a[kk * TL] = e;
      sum += e;
    }
    const bool live = l0 + l < L;
    for (int kk = 0; kk < K; ++kk) {
      float p = a[kk * TL] / sum;
      if (is_row) p = round_to(p, T());
      a[kk * TL] = live ? p : 0.f;
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kMmaTL = 16 * kWarps;  // queries per block: 16 per warp

constexpr int kStages = 8;  // value rows in flight (cp.async ring)

// Words: a_row packed to bf16 first, then the score layout. The ring of
// value rows reuses the score layout's a_row map and scratch, dead once
// a_row is packed; a_col stays live below it.
struct MmaLayout {
  ScoreLayout sc;
  int w_pad, ap, row_words, slot_words, a16, ring, total;
  __host__ __device__ MmaLayout(int D, int H, int W)
      : sc(kMmaTL, D, H, W, kMmaTL * frag_pitch(((W + 15) & ~15) / 2)) {
    w_pad = (W + 15) & ~15;
    ap = frag_pitch(w_pad / 2);  // a_row rows: bf16 pairs along w
    // value rows as stored, w-major, pitch D + 8 bf16: 16-byte aligned for
    // cp.async, and the 8 rows an ldmatrix tile reads hit distinct banks
    row_words = (D + 8) / 2;
    slot_words = w_pad * row_words;
    a16 = 0;
    ring = sc.arow;
    total = sc.end > ring + kStages * slot_words ? sc.end : ring + kStages * slot_words;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
rcda_mma_kernel(const __nv_bfloat16* __restrict__ q_row, const __nv_bfloat16* __restrict__ q_col,
                const __nv_bfloat16* __restrict__ k_row, const __nv_bfloat16* __restrict__ k_col,
                const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ bias_row,
                const __nv_bfloat16* __restrict__ bias_col, __nv_bfloat16* __restrict__ out,
                int L, int H, int W, int E) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int TL = kMmaTL;
  constexpr int kMaxKs = kMaxAxisBf16 / 16;                    // k-steps over w
  const MmaLayout lay(D, H, W);
  extern __shared__ __align__(16) uint32_t smem_w[];
  float* sf = reinterpret_cast<float*>(smem_w);
  const float* s_arow = sf + lay.sc.arow;
  const float* s_acol = sf + lay.sc.acol;
  uint32_t* s_a16 = smem_w + lay.a16;  // [TL][ap]

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * TL;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;
  scores_and_softmax<__nv_bfloat16, D, TL>(sf, lay.sc, q_row, q_col, k_row, k_col, bias_row,
                                           bias_col, b, l0, hoff, L, H, W, E);
  __syncthreads();

  // a_row as bf16 pairs along w, one row per query, zero past W (the
  // values are already bf16-rounded, so packing is exact)
  for (int i = tid; i < TL * (lay.w_pad / 2); i += kThreads) {
    const int l = i % TL, w = 2 * (i / TL);
    const float lo = w < W ? s_arow[w * TL + l] : 0.f;
    const float hi = w + 1 < W ? s_arow[(w + 1) * TL + l] : 0.f;
    s_a16[l * lay.ap + w / 2] = pack_bf16(lo, hi);
  }
  __syncthreads();  // a_row's f32 map and the scratch are free for the ring

  // value rows v[b, h, :, head] through a ring of kStages slots: row h is
  // multiplied while rows h+1 .. h+kStages-1 are in flight. Rows past W
  // stay zero in every slot.
  constexpr int CH = D / 8;  // 16-byte chunks per row
  uint32_t* ring = smem_w + lay.ring;
  for (int i = tid; i < kStages * (lay.w_pad - W) * lay.row_words; i += kThreads) {
    const int per_slot = (lay.w_pad - W) * lay.row_words;
    ring[(i / per_slot) * lay.slot_words + W * lay.row_words + i % per_slot] = 0u;
  }
  const __nv_bfloat16* vb = v + b * H * W * E + hoff;
  const uint32_t ring_addr = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  const int row_bytes = lay.row_words * 4, slot_bytes = lay.slot_words * 4;
  auto issue_row = [&](int h) {
    if (h < H) {
      const __nv_bfloat16* src = vb + static_cast<size_t>(h) * W * E;
      const uint32_t dst = ring_addr + (h % kStages) * slot_bytes;
      for (int i = tid; i < W * CH; i += kThreads)
        cp_async16(dst + (i / CH) * row_bytes + (i % CH) * 16,
                   src + static_cast<size_t>(i / CH) * E + (i % CH) * 8);
    }
    cp_async_commit();  // one group per row, empty past H, so counts stay aligned
  };
  for (int h = 0; h < kStages - 1; ++h) issue_row(h);

  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr = (tid / 32) * 16 + g;  // this thread's tile rows: lr, lr + 8
  const int nks = lay.w_pad / 16;
  uint32_t af[kMaxKs][4];
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (ks >= nks) break;
    const uint32_t* a0 = s_a16 + lr * lay.ap + ks * 8;
    const uint32_t* a1 = s_a16 + (lr + 8) * lay.ap + ks * 8;
    af[ks][0] = a0[t4];
    af[ks][1] = a1[t4];
    af[ks][2] = a0[4 + t4];
    af[ks][3] = a1[4 + t4];
  }
  // ldmatrix row address of this lane: tile m = lane / 8 covers w rows
  // (m % 2) * 8 .. + 7 and channels (m / 2) * 8 .. + 7 of a 16 x 16 block
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 16;

  float acc[D / 8][4] = {};
  for (int h = 0; h < H; ++h) {
    cp_async_wait<kStages - 2>();  // this thread's copies of row h landed
    __syncthreads();  // everyone's did, and row h - 1's slot is free again
    issue_row(h + kStages - 1);
    const uint32_t slot = ring_addr + (h % kStages) * slot_bytes;
    float hid[D / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks >= nks) break;
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {  // two n-tiles of 8 channels
        uint32_t bf[4];
        ldmatrix_x4_trans(slot + (ks * 16 + lm_row) * row_bytes + np * 32 + lm_col, bf);
        mma_bf16(hid[2 * np], af[ks], bf[0], bf[1]);
        mma_bf16(hid[2 * np + 1], af[ks], bf[2], bf[3]);
      }
    }
    const float c0 = s_acol[h * TL + lr], c1 = s_acol[h * TL + lr + 8];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      acc[nt][0] = fmaf(c0, hid[nt][0], acc[nt][0]);
      acc[nt][1] = fmaf(c0, hid[nt][1], acc[nt][1]);
      acc[nt][2] = fmaf(c1, hid[nt][2], acc[nt][2]);
      acc[nt][3] = fmaf(c1, hid[nt][3], acc[nt][3]);
    }
  }

  const int r0 = l0 + lr, r1 = r0 + 8;
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

// ------------------------------------------------------------- float32 ---

// Thread tiling for head dim D: CG channel groups of 4 by QG query groups
// of 4 cover a TL x D output tile with kThreads threads.
template <int D> struct Tiling {
  static constexpr int CG = D / 4;
  static constexpr int QG = kThreads / CG;
  static constexpr int TL = QG * 4;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
rcda_f32_kernel(const float* __restrict__ q_row, const float* __restrict__ q_col,
                const float* __restrict__ k_row, const float* __restrict__ k_col,
                const float* __restrict__ v, const float* __restrict__ bias_row,
                const float* __restrict__ bias_col, float* __restrict__ out,
                int L, int H, int W, int E) {
  using Tl = Tiling<D>;
  constexpr int TL = Tl::TL;
  extern __shared__ __align__(16) float smem[];
  const ScoreLayout lay(TL, D, H, W);
  const float* s_arow = smem + lay.arow;  // [W][TL]
  const float* s_acol = smem + lay.acol;  // [H][TL]
  float* s_v = smem + lay.qr;  // [W][D], reuses the q tiles (W * D <= 2 * TL * (D + 4))

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * TL;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;
  scores_and_softmax<float, D, TL>(smem, lay, q_row, q_col, k_row, k_col, bias_row,
                                   bias_col, b, l0, hoff, L, H, W, E);
  __syncthreads();

  // out[l, c] = sum_h a_col[l, h] * sum_w a_row[l, w] v[h, w, c]
  const int cg = tid % Tl::CG;
  const int qg = tid / Tl::CG;
  float acc[4][4] = {};
  for (int h = 0; h < H; ++h) {
    const float* vrow = v + (b * H + h) * W * E + hoff;
    staged_copy<16, kThreads>(
        W * D, [&](int i) { return vrow[static_cast<size_t>(i / D) * E + i % D]; },
        [&](int i, float x) { s_v[i] = x; });
    __syncthreads();
    float hid[4][4] = {};
    for (int w = 0; w < W; ++w) {
      const float4 ar = *reinterpret_cast<const float4*>(s_arow + w * TL + qg * 4);
      const float4 vv = *reinterpret_cast<const float4*>(s_v + w * D + cg * 4);
      const float a4[4] = {ar.x, ar.y, ar.z, ar.w};
      const float v4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) hid[i][c] = fmaf(a4[i], v4[c], hid[i][c]);
    }
    const float4 ac = *reinterpret_cast<const float4*>(s_acol + h * TL + qg * 4);
    const float c4[4] = {ac.x, ac.y, ac.z, ac.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(c4[i], hid[i][c], acc[i][c]);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int l = l0 + qg * 4 + i;
    if (l >= L) continue;
    float* o = out + (b * L + l) * E + hoff + cg * 4;
#pragma unroll
    for (int c = 0; c < 4; ++c) o[c] = acc[i][c];
  }
}

// ------------------------------------------------------------ dispatch ---

template <int D>
size_t smem_bytes_d(int dtype, int H, int W) {
  const int words = dtype == 0 ? ScoreLayout(Tiling<D>::TL, D, H, W).end
                               : MmaLayout(D, H, W).total;
  return static_cast<size_t>(words) * 4;
}

size_t smem_bytes(int dtype, int D, int H, int W) {
  switch (D) {
    case 16: return smem_bytes_d<16>(dtype, H, W);
    case 32: return smem_bytes_d<32>(dtype, H, W);
    case 64: return smem_bytes_d<64>(dtype, H, W);
    default: return 0;
  }
}

template <int D>
int launch(int dtype, const void* q_row, const void* q_col, const void* k_row,
           const void* k_col, const void* v, const void* bias_row,
           const void* bias_col, void* out, int B, int L, int H, int W, int E,
           int num_heads, cudaStream_t stream) {
  const size_t smem = smem_bytes_d<D>(dtype, H, W);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = rcda_f32_kernel<D>;
    err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + Tiling<D>::TL - 1) / Tiling<D>::TL, num_heads, B);
    using F = const float*;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<F>(q_row), static_cast<F>(q_col), static_cast<F>(k_row),
        static_cast<F>(k_col), static_cast<F>(v), static_cast<F>(bias_row),
        static_cast<F>(bias_col), static_cast<float*>(out), L, H, W, E);
  } else {
    if (H > kMaxAxisBf16 || W > kMaxAxisBf16) return static_cast<int>(cudaErrorInvalidValue);
    auto kern = rcda_mma_kernel<D>;
    err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + kMmaTL - 1) / kMmaTL, num_heads, B);
    using F = const __nv_bfloat16*;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<F>(q_row), static_cast<F>(q_col), static_cast<F>(k_row),
        static_cast<F>(k_col), static_cast<F>(v), static_cast<F>(bias_row),
        static_cast<F>(bias_col), static_cast<__nv_bfloat16*>(out), L, H, W, E);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor, biases included).
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int rcda_forward(int dtype, const void* q_row, const void* q_col,
                            const void* k_row, const void* k_col,
                            const void* v, const void* bias_row,
                            const void* bias_col, void* out, int B, int L,
                            int H, int W, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E / num_heads) {
    case 16:
      return launch<16>(dtype, q_row, q_col, k_row, k_col, v, bias_row, bias_col,
                        out, B, L, H, W, E, num_heads, s);
    case 32:
      return launch<32>(dtype, q_row, q_col, k_row, k_col, v, bias_row, bias_col,
                        out, B, L, H, W, E, num_heads, s);
    case 64:
      return launch<64>(dtype, q_row, q_col, k_row, k_col, v, bias_row, bias_col,
                        out, B, L, H, W, E, num_heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared-memory bytes one block needs (0 for an unsupported head dim).
extern "C" long long rcda_smem_bytes(int dtype, int D, int H, int W) {
  return static_cast<long long>(smem_bytes(dtype, D, H, W));
}
