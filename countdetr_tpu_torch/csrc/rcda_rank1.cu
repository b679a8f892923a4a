// Rank-1 Row-Column Decoupled Attention core for Hopper (sm_90a).
//
// Replaces: countdetr_tpu/ops/pallas/rcda_kernel.py::fused_rcda_rank1 (body
// _rcda_rank1_kernel), the Pallas/Mosaic kernel of the JAX package's
// COUNTDETR_PALLAS_VARIANT=rank1 (ModelConfig.rcda_variant="rank1" here).
//
// Computes, per batch b, head n and query l (q pre-scaled by d^-1/2):
//   a_row[l, w] = softmax_w(q_row[l] . k_row[w] + bias_row[w])   (f32)
//   a_col[l, h] = softmax_h(q_col[l] . k_col[h] + bias_col[h])   (f32)
//   P[l, h, w]  = a_col[l, h] * a_row[l, w]         (f32, rounded to v's dtype)
//   out[l, :]   = sum_{h, w} P[l, h, w] * v[h, w, :] (f32 accumulation)
// Layouts are rcda.cu's: q_row/q_col/out (B, L, E), k_row (B, W, E), k_col
// (B, H, E), v (B, H, W, E), biases (B, W)/(B, H), heads by stride inside E.
// These are the rank-1 numerics, not the two-stage kernel's: neither
// softmax is rounded, only the product P, once, right before the product
// with v.
//
// What bounds it on this card: at the stage-1 shapes (B=8, 8 heads of d=32,
// H=24, W=42; L = H*W = 1008 in the encoder, the point tier in the decoder)
// the combine is 2*d*H*W operations a query and head against ~4*E bytes of
// q and out a query, so the encoder call sits near the line between the
// two (~4.5 GFLOP against ~17 MB of bf16), the decoder's is bound by its
// operations as L grows.
//
// What the design does about it: one block of 128 threads per (64-query
// tile, head, batch); the score phase is rcda.cu's (rcda_scores.cuh), with
// both maps kept in f32. Then the combine:
//  * bf16: tensor cores. Each warp holds a_row for its 16 queries in f32
//    registers, at the positions of an mma.sync m16n8k16 A fragment (W
//    padded to 16 with zero columns). For each H row it scales them by
//    a_col[l, h], rounds the product to bf16 straight into the A fragment
//    (as mha.cu feeds its probabilities to PV), and accumulates P_h times
//    v[h] (W x d) into one f32 accumulator: the H*W contraction in 16-wide
//    k-steps, with no (B, n, L, H, d) intermediate. Value rows stream
//    through rcda.cu's ring of kStages cp.async slots, reused from the
//    score phase's scratch, and reach the B operand by ldmatrix.trans.
//  * float32 (parity only): CUDA cores, each thread a 4 query x 4 channel
//    register tile, P formed in f32 per (h, w) and multiplied into v.
// The TPU kernel's expand matrix and pltpu.repeat (Mosaic's way to build P
// on chip) have no counterpart: here P never leaves the registers.

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "mma.cuh"
#include "rcda_scores.cuh"

namespace {

constexpr int kMaxAxis = 64;  // H, W limit: a_row's fragments stay in registers

// ---------------------------------------------------------------- bf16 ---

constexpr int kMmaTL = 16 * kWarps;  // queries per block: 16 per warp
constexpr int kStages = 8;           // value rows in flight (cp.async ring)

// Words: the score layout; the ring of value rows reuses its a_row map and
// scratch, dead once a_row is in registers; a_col stays live below it.
struct MmaLayout {
  ScoreLayout sc;
  int w_pad, row_words, slot_words, ring, total;
  __host__ __device__ MmaLayout(int D, int H, int W) : sc(kMmaTL, D, H, W) {
    w_pad = (W + 15) & ~15;
    // value rows as stored, w-major, pitch D + 8 bf16: 16-byte aligned for
    // cp.async, and the 8 rows an ldmatrix tile reads hit distinct banks
    row_words = (D + 8) / 2;
    slot_words = w_pad * row_words;
    ring = sc.arow;
    total = sc.end > ring + kStages * slot_words ? sc.end : ring + kStages * slot_words;
  }
};

template <int D>
__global__ void __launch_bounds__(kThreads)
rcda_rank1_mma_kernel(const __nv_bfloat16* __restrict__ q_row,
                      const __nv_bfloat16* __restrict__ q_col,
                      const __nv_bfloat16* __restrict__ k_row,
                      const __nv_bfloat16* __restrict__ k_col,
                      const __nv_bfloat16* __restrict__ v,
                      const __nv_bfloat16* __restrict__ bias_row,
                      const __nv_bfloat16* __restrict__ bias_col,
                      __nv_bfloat16* __restrict__ out, int L, int H, int W, int E) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int TL = kMmaTL;
  constexpr int kMaxKs = kMaxAxis / 16;  // k-steps over w
  const MmaLayout lay(D, H, W);
  extern __shared__ __align__(16) uint32_t smem_w[];
  float* sf = reinterpret_cast<float*>(smem_w);
  const float* s_arow = sf + lay.sc.arow;
  const float* s_acol = sf + lay.sc.acol;

  const int tid = threadIdx.x;
  const int l0 = blockIdx.x * TL;
  const int hoff = blockIdx.y * D;
  const size_t b = blockIdx.z;
  scores_and_softmax<__nv_bfloat16, D, TL, false>(sf, lay.sc, q_row, q_col, k_row, k_col,
                                                  bias_row, bias_col, b, l0, hoff, L, H, W, E);
  __syncthreads();

  // a_row in f32 at this thread's A-fragment positions: rows lr, lr + 8,
  // columns 2t, 2t+1, 2t+8, 2t+9 of each 16-wide k-step; zero past W
  const int lane = tid % 32, g = lane / 4, t4 = lane % 4;
  const int lr = (tid / 32) * 16 + g;
  const int nks = lay.w_pad / 16;
  auto arow_at = [&](int w, int l) { return w < W ? s_arow[w * TL + l] : 0.f; };
  float ar[kMaxKs][8];
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (ks >= nks) break;
    const int w0 = ks * 16 + 2 * t4;
    ar[ks][0] = arow_at(w0, lr);
    ar[ks][1] = arow_at(w0 + 1, lr);
    ar[ks][2] = arow_at(w0, lr + 8);
    ar[ks][3] = arow_at(w0 + 1, lr + 8);
    ar[ks][4] = arow_at(w0 + 8, lr);
    ar[ks][5] = arow_at(w0 + 9, lr);
    ar[ks][6] = arow_at(w0 + 8, lr + 8);
    ar[ks][7] = arow_at(w0 + 9, lr + 8);
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

  // ldmatrix row address of this lane: tile m = lane / 8 covers w rows
  // (m % 2) * 8 .. + 7 and channels (m / 2) * 8 .. + 7 of a 16 x 16 block
  const int lm_row = (lane / 8 % 2) * 8 + lane % 8, lm_col = lane / 16 * 16;

  float acc[D / 8][4] = {};
  for (int h = 0; h < H; ++h) {
    cp_async_wait<kStages - 2>();  // this thread's copies of row h landed
    __syncthreads();  // everyone's did, and row h - 1's slot is free again
    issue_row(h + kStages - 1);
    const uint32_t slot = ring_addr + (h % kStages) * slot_bytes;
    const float c0 = s_acol[h * TL + lr], c1 = s_acol[h * TL + lr + 8];
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks >= nks) break;
      // P_h = a_col[l, h] * a_row[l, w] in f32, rounded to bf16 in place
      const uint32_t pa[4] = {
          pack_bf16(c0 * ar[ks][0], c0 * ar[ks][1]),
          pack_bf16(c1 * ar[ks][2], c1 * ar[ks][3]),
          pack_bf16(c0 * ar[ks][4], c0 * ar[ks][5]),
          pack_bf16(c1 * ar[ks][6], c1 * ar[ks][7]),
      };
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {  // two n-tiles of 8 channels
        uint32_t bf[4];
        ldmatrix_x4_trans(slot + (ks * 16 + lm_row) * row_bytes + np * 32 + lm_col, bf);
        mma_bf16(acc[2 * np], pa, bf[0], bf[1]);
        mma_bf16(acc[2 * np + 1], pa, bf[2], bf[3]);
      }
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

template <int D>
__global__ void __launch_bounds__(kThreads)
rcda_rank1_f32_kernel(const float* __restrict__ q_row, const float* __restrict__ q_col,
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
  scores_and_softmax<float, D, TL, false>(smem, lay, q_row, q_col, k_row, k_col, bias_row,
                                          bias_col, b, l0, hoff, L, H, W, E);
  __syncthreads();

  // out[l, c] = sum_h sum_w (a_col[l, h] * a_row[l, w]) v[h, w, c]
  const int cg = tid % Tl::CG;
  const int qg = tid / Tl::CG;
  float acc[4][4] = {};
  for (int h = 0; h < H; ++h) {
    const float* vrow = v + (b * H + h) * W * E + hoff;
    staged_copy<16, kThreads>(
        W * D, [&](int i) { return vrow[static_cast<size_t>(i / D) * E + i % D]; },
        [&](int i, float x) { s_v[i] = x; });
    __syncthreads();
    const float4 ac = *reinterpret_cast<const float4*>(s_acol + h * TL + qg * 4);
    const float c4[4] = {ac.x, ac.y, ac.z, ac.w};
    for (int w = 0; w < W; ++w) {
      const float4 ar = *reinterpret_cast<const float4*>(s_arow + w * TL + qg * 4);
      const float4 vv = *reinterpret_cast<const float4*>(s_v + w * D + cg * 4);
      const float p4[4] = {c4[0] * ar.x, c4[1] * ar.y, c4[2] * ar.z, c4[3] * ar.w};
      const float v4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][c] = fmaf(p4[i], v4[c], acc[i][c]);
    }
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
  if (H > kMaxAxis || W > kMaxAxis) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes_d<D>(dtype, H, W);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaFuncAttribute attr = cudaFuncAttributeMaxDynamicSharedMemorySize;
  cudaError_t err;
  if (dtype == 0) {
    auto kern = rcda_rank1_f32_kernel<D>;
    err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((L + Tiling<D>::TL - 1) / Tiling<D>::TL, num_heads, B);
    using F = const float*;
    kern<<<grid, kThreads, smem, stream>>>(
        static_cast<F>(q_row), static_cast<F>(q_col), static_cast<F>(k_row),
        static_cast<F>(k_col), static_cast<F>(v), static_cast<F>(bias_row),
        static_cast<F>(bias_col), static_cast<float*>(out), L, H, W, E);
  } else {
    auto kern = rcda_rank1_mma_kernel<D>;
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
extern "C" int rcda_rank1_forward(int dtype, const void* q_row, const void* q_col,
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
extern "C" long long rcda_rank1_smem_bytes(int dtype, int D, int H, int W) {
  return static_cast<long long>(smem_bytes(dtype, D, H, W));
}
