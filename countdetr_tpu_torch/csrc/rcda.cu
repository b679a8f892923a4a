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
// (34 us on bf16 tensor cores). What kept the first (mma.sync) design 16x
// off that was latency, not arithmetic: a block-wide barrier per H row for
// 12 mma.sync a warp, scores one thread per row on the CUDA cores, and
// each 64-query block re-reading its (batch, head)'s value slice (22 times
// per (b, head) at L=1369).
//
// What the design does about it:
//  * bf16 (the serving path): the block, TMA producer, q tiles, wgmma
//    scores and softmaxes of rcda_wgmma.cuh (shared with rcda_rank1.cu):
//    3 consumer warpgroups and a producer warp per 6 query tiles of one
//    (batch, head), the value slice resident in shared memory when it fits
//    (37x37 at d=32: 114 KB). The combine (V3Combine below): a_row rounded
//    to bf16 as register A operands; for each group of kN / D rows of H,
//    hid = a_row [v[h] | v[h+1] ...] by one wgmma m64n64k16 chain, then
//    out += a_col[l, h] * hid[h] in registers.
//  * float32 (parity only): the score phase of rcda_scores.cuh on the CUDA
//    cores, then each thread a 4 query x 4 channel register tile, two
//    float4 shared reads per 16 FMAs, one value row staged at a time.
// The Mosaic workarounds of the TPU kernel (the 0/1 fold matrix,
// pltpu.repeat, the (B, n, W, d*H) value reshuffle) have no counterpart:
// on CUDA the head-weighted combine is a plain accumulation in registers.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "rcda_scores.cuh"
#include "rcda_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ---

// The two-stage combine on the shared machinery (rcda_wgmma.cuh): a_row
// rounded to bf16 as register A operands; for each group of kG = kN / D
// rows of H, hid = a_row [v[h] | v[h+1] ...] by wgmma m64n64k16 (N = kN: the
// group's rows side by side, each v[h] read as stored, the transposed-B
// form with LBO = one row's slice; W/16 k-steps) into f32, then out +=
// a_col[l, h] * hid[h] in registers. kN = 64 keeps a warpgroup within the
// 128 registers a thread gets with 3 warpgroups and a producer warp.
template <int D>
struct V3Combine {
  static constexpr int kMaxKs = rcda_wgmma::kMaxAxis / 16;
  uint32_t af[kMaxKs][4];

  __device__ __forceinline__ void take_row(const float (&s)[32]) {
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) af[ks][i] = pack_bf16(s[8 * ks + 2 * i], s[8 * ks + 2 * i + 1]);
  }

  __device__ __forceinline__ void operator()(const float* s_acol, const rcda_wgmma::Ring& ring,
                                             int lr, int H, int W, float (&acc)[D / 2]) {
    using namespace hopper;
    constexpr int kN = rcda_wgmma::kN, kAP = rcda_wgmma::kAP, kG = kN / D, kRow = 2 * D;
    const int nks = (W + 15) / 16;  // k-steps over w
    for (int gi = 0; gi < ring.groups; ++gi) {
      const uint32_t va = ring.wait(gi);
      float hid[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks)
        if (ks < nks) wgmma_rs<kN>(hid, af[ks], desc<D>(va + 16 * kRow * ks, ring.slice), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hid);
      ring.release(gi);
#pragma unroll
      for (int hh = 0; hh < kG; ++hh) {
        const int h = gi * kG + hh;
        if (h >= H) break;
        const float c0 = s_acol[h * kAP + lr], c1 = s_acol[h * kAP + lr + 8];
#pragma unroll
        for (int i = 0; i < D / 8; ++i) {
          const int j = 4 * (hh * (D / 8) + i);  // the n8 block of row h, channels 8i..
          acc[4 * i] = fmaf(c0, hid[j], acc[4 * i]);
          acc[4 * i + 1] = fmaf(c0, hid[j + 1], acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(c1, hid[j + 2], acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(c1, hid[j + 3], acc[4 * i + 3]);
        }
      }
    }
  }
};

template <int D>
__global__ void __launch_bounds__(rcda_wgmma::kThreads, 1)
rcda_wgmma_kernel(const __grid_constant__ CUtensorMap map_qr,
                  const __grid_constant__ CUtensorMap map_qc,
                  const __grid_constant__ CUtensorMap map_kr,
                  const __grid_constant__ CUtensorMap map_kc,
                  const __grid_constant__ CUtensorMap map_v,
                  const __nv_bfloat16* __restrict__ bias_row,
                  const __nv_bfloat16* __restrict__ bias_col, __nv_bfloat16* __restrict__ out,
                  int L, int H, int W, int E, int stages) {
  rcda_wgmma::run<D, V3Combine<D>>(&map_qr, &map_qc, &map_kr, &map_kc, &map_v, bias_row,
                                   bias_col, out, L, H, W, E, stages);
}

// ------------------------------------------------------------- float32 ---

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
  scores_and_softmax<float, D, TL, true>(smem, lay, q_row, q_col, k_row, k_col, bias_row,
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
  if (dtype == 0) return static_cast<size_t>(ScoreLayout(Tiling<D>::TL, D, H, W).end) * 4;
  return rcda_wgmma::smem_bytes(D, H, W);
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
    return static_cast<int>(cudaGetLastError());
  }
  return rcda_wgmma::launch<D>(rcda_wgmma_kernel<D>, q_row, q_col, k_row, k_col, v, bias_row,
                               bias_col, out, B, L, H, W, E, num_heads, stream);
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
