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
// the combine is 2*d*H*W operations a query and head on the tensor cores,
// plus H*W products and conversions forming P on the CUDA cores (at d=32
// about as many instructions as the products), against ~4*E bytes of q
// and out a query: the encoder call sits near the line between bytes and
// operations. An earlier design (128-thread blocks of 64 queries, scores one
// thread per row, mma.sync with value rows through a cp.async ring re-read
// by every block) ran 14x above its bound.
//
// What the design does about it:
//  * bf16: the block, TMA producer, q tiles, wgmma scores and softmaxes of
//    rcda_wgmma.cuh (shared with rcda.cu): 3 consumer warpgroups and a
//    producer warp per 6 query tiles of one (batch, head), the value slice
//    v[b, :, :, head] resident in shared memory when it fits (37x37 at
//    d=32: 114 KB), both softmaxes in f32 registers and neither rounded.
//    The combine (Rank1Combine below): for each row h, P_h = a_col[:, h] *
//    a_row in f32, rounded once to bf16 straight into register A operands
//    (W padded to 16 by zero columns), and one f32 accumulator takes P_h
//    v[h] by wgmma m64nDk16 (v[h] read as stored, the transposed-B form)
//    over all h: no per-h intermediate, no a_col rescale. Two sets of A
//    registers alternate, so P_{h+1} is formed while the product on P_h is
//    in flight.
//  * float32 (the CLI's default dtype) has no kernel here: the wrapper
//    (ops/kernels/rcda_kernel.py::kernel_route) sends a float32 rank-1 call
//    to rcda.cu's float32 kernels, 3xTF32 on the tensor cores where H, W <=
//    64 and d <= 32, else its CUDA-core kernel. In float32 rounding P, or
//    each probability map, to v's dtype is the identity, so the rank-1 and
//    the two-stage formulations are one function up to the order of an f32
//    sum (the plain versions differ by under 1e-6 at the stage-1 shapes),
//    and rcda.cu's 3xTF32 combine (hid^T = v^T a_row^T, the value group the
//    register A operand) avoids the transposition of P_h or v[h] that a
//    one-contraction tf32 kernel would need: wgmma reads tf32 operands from
//    shared memory only K-major.
// The TPU kernel's expand matrix and pltpu.repeat (Mosaic's way to build P
// on chip) have no counterpart: here P never leaves the registers.

#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "rcda_wgmma.cuh"

namespace {

// ---------------------------------------------------------------- bf16 ---

template <int D>
struct Rank1Combine {
  static constexpr int kMaxKs = rcda_wgmma::kMaxAxis / 16;  // k-steps over w
  float ar[32];  // a_row in f32 at the accumulator layout (= the A layout)

  __device__ __forceinline__ void take_row(const float (&s)[32]) {
#pragma unroll
    for (int i = 0; i < 32; ++i) ar[i] = s[i];
  }

  __device__ __forceinline__ void operator()(const float* s_acol, const rcda_wgmma::Ring& ring,
                                             int lr, int H, int W, float (&acc)[D / 2]) {
    using namespace hopper;
    constexpr int kAP = rcda_wgmma::kAP, kG = rcda_wgmma::kN / D, kRow = 2 * D;
    const int nks = (W + 15) / 16;
    uint32_t pa[kMaxKs][4], pb[kMaxKs][4];
    int cur = -1;  // the value group in use
    uint32_t va = 0;
    // P_h into the A registers pf, then its products, issued and left in
    // flight; the wait retires the previous h's, freeing the other set
    auto step = [&](uint32_t (&pf)[kMaxKs][4], int h) {
      const int gi = h / kG;
      if (gi != cur) {
        if (cur >= 0 && !ring.resident) {
          wgmma_wait<0>();
          ring.release(cur);
        }
        va = ring.wait(gi);
        cur = gi;
      }
      const float c0 = s_acol[h * kAP + lr], c1 = s_acol[h * kAP + lr + 8];
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks)
        if (ks < nks)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ch = (i & 1) ? c1 : c0;  // a[1], a[3] hold row lr + 8
            pf[ks][i] = pack_bf16(ch * ar[8 * ks + 2 * i], ch * ar[8 * ks + 2 * i + 1]);
          }
      const uint32_t vh = va + (h % kG) * ring.slice;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxKs; ++ks)
        if (ks < nks) wgmma_rs<D>(acc, pf[ks], desc<D>(vh + 16 * kRow * ks), 1);
      wgmma_commit();
      wgmma_wait<1>();
    };
    for (int h = 0; h < H; h += 2) {
      step(pa, h);
      if (h + 1 < H) step(pb, h + 1);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (cur >= 0) ring.release(cur);
  }
};

template <int D>
__global__ void __launch_bounds__(rcda_wgmma::kThreads, 1)
rcda_rank1_wgmma_kernel(const __grid_constant__ CUtensorMap map_qr,
                        const __grid_constant__ CUtensorMap map_qc,
                        const __grid_constant__ CUtensorMap map_kr,
                        const __grid_constant__ CUtensorMap map_kc,
                        const __grid_constant__ CUtensorMap map_v,
                        const __nv_bfloat16* __restrict__ bias_row,
                        const __nv_bfloat16* __restrict__ bias_col,
                        __nv_bfloat16* __restrict__ out, int L, int H, int W, int E, int stages) {
  rcda_wgmma::run<D, Rank1Combine<D>>(&map_qr, &map_qc, &map_kr, &map_kc, &map_v, bias_row,
                                      bias_col, out, L, H, W, E, stages);
}

// ------------------------------------------------------------ dispatch ---

template <int D>
int launch(const void* q_row, const void* q_col, const void* k_row, const void* k_col,
           const void* v, const void* bias_row, const void* bias_col, void* out, int B, int L,
           int H, int W, int E, int num_heads, cudaStream_t stream) {
  return rcda_wgmma::launch<D>(rcda_rank1_wgmma_kernel<D>, q_row, q_col, k_row, k_col, v,
                               bias_row, bias_col, out, B, L, H, W, E, num_heads, stream);
}

}  // namespace

// dtype: 1 = bfloat16 (every tensor, biases included); any other code is
// refused with cudaErrorInvalidValue (float32 rank-1 calls take rcda.cu).
// Returns cudaGetLastError() after the launch; 0 means it was queued.
extern "C" int rcda_rank1_forward(int dtype, const void* q_row, const void* q_col,
                                  const void* k_row, const void* k_col,
                                  const void* v, const void* bias_row,
                                  const void* bias_col, void* out, int B, int L,
                                  int H, int W, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || dtype != 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (E / num_heads) {
    case 16:
      return launch<16>(q_row, q_col, k_row, k_col, v, bias_row, bias_col, out, B, L, H, W,
                        E, num_heads, s);
    case 32:
      return launch<32>(q_row, q_col, k_row, k_col, v, bias_row, bias_col, out, B, L, H, W,
                        E, num_heads, s);
    case 64:
      return launch<64>(q_row, q_col, k_row, k_col, v, bias_row, bias_col, out, B, L, H, W,
                        E, num_heads, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared-memory bytes one bfloat16 block needs (0 for another dtype or an
// unsupported head dim).
extern "C" long long rcda_rank1_smem_bytes(int dtype, int D, int H, int W) {
  const bool ok = dtype == 1 && (D == 16 || D == 32 || D == 64);
  return ok ? static_cast<long long>(rcda_wgmma::smem_bytes(D, H, W)) : 0;
}
