// The score phase of rcda.cu's CUDA-core float32 kernel (the float32 calls
// of either RCDA variant past the 3xTF32 kernel's limits): both 1-D score
// products and both softmaxes of one (query tile, head, batch) block, in f32
// on the CUDA cores, written to shared memory; and the block size and
// shared-memory limit the RCDA kernels share (rcda_wgmma.cuh).

#pragma once

#include <cfloat>
#include <cstddef>

#include <cuda_bf16.h>

#include "mma.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSmem = 232448;  // bytes a block may use on sm_90

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
// softmaxes into s + lay.arow / lay.acol (zero for queries past L). With
// kRoundRow, a_row is rounded to T (the two-stage kernel's numerics; the
// identity for T = float). Ends with the probabilities written
// by each thread; the caller synchronises.
template <typename T, int D, int TL, bool kRoundRow>
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
      if (kRoundRow && is_row) p = round_to(p, T());
      a[kk * TL] = live ? p : 0.f;
    }
  }
}

// Thread tiling of the float32 combine for head dim D: CG channel groups of
// 4 by QG query groups of 4 cover a TL x D output tile with kThreads threads.
template <int D> struct Tiling {
  static constexpr int CG = D / 4;
  static constexpr int QG = kThreads / CG;
  static constexpr int TL = QG * 4;
};

}  // namespace
