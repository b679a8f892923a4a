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
//  * bf16 (the serving path): one block of kWG = 3 consumer warpgroups and
//    a producer warp takes kTilesPerBlock = 6 query tiles of 64 of one
//    (batch, head), kWG at a time. The producer loads both key slices once
//    and the value slice v[b, :, :, head] by TMA, in groups of kN / D rows
//    of H ([W][d] per row, W padded to 16 by zero rows) into a ring of
//    mbarrier-guarded stages. When the slice fits in shared memory (37x37
//    at d=32: 114 KB) the ring holds all of it, loaded once and kept for
//    every tile of the block, so a (b, head)'s values are read from L2
//    once per 6 tiles; otherwise the groups stream again for each round of
//    tiles, the consumers releasing each stage on its empty barrier. No
//    block-wide barrier falls inside the loops. Each warpgroup's thread 0
//    loads its q_row and q_col tiles by TMA one round ahead (two buffers).
//    Per tile, a warpgroup computes s_row = q_row k_row^T and s_col =
//    q_col k_col^T together by wgmma m64n64k16 (all operands in shared
//    memory, K-major; columns past W or H at bias -inf), both softmaxes in
//    registers (one ex2 per score), a_row rounded to bf16 as register A
//    operands and a_col (f32) into shared memory for its own warps. Then for
//    each group, hid = a_row [v[h] | v[h+1] ...] by wgmma m64n64k16 (N = kN:
//    the group's rows side by side, each v[h] read as stored, the
//    transposed-B form with LBO = one row's slice; W/16 k-steps) into f32,
//    and out += a_col[l, h] * hid[h] in registers. kN = 64 keeps a
//    warpgroup within the 128 registers a thread gets with 3 warpgroups
//    and a producer warp on the SM.
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

namespace {

// ---------------------------------------------------------------- bf16 ---

constexpr int kMaxAxisBf16 = 64;   // H, W limit: one 64-wide score tile
constexpr int kTQ = 64;            // queries per tile: one consumer warpgroup
constexpr int kWG = 3;             // consumer warpgroups per block
constexpr int kTilesPerBlock = 6;  // query tiles per block, kWG at a time
constexpr int kBf16Threads = kWG * 128 + 32;
constexpr int kAP = 68;            // a_col row pitch in floats: conflict-free writes
constexpr int kN = 64;             // the combine's wgmma width: kN / D rows of H at once
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory in bytes from a 1024-aligned base: the two key tiles (64
// rows each), each warpgroup's q_row and q_col tiles in two buffers
// [kWG][2][2] (64 rows each), the ring of value row groups (kN / D rows of
// H each, [W][d] per row, W padded to 16), each warpgroup's a_col map
// [H][kAP], the biases (f32, -inf past W and H), the barriers: ring full
// and empty, the key tiles' and each warpgroup's two q buffers'.
struct Bf16Layout {
  int slice, group, groups, tile, kr, kc, q, ring, acol, bias, bars, total;
  __host__ __device__ Bf16Layout(int D, int H, int W, int stages) {
    const int row = 2 * D;
    slice = ((W + 15) & ~15) * row;  // one H row of values
    group = kN / D * slice;
    groups = (H + kN / D - 1) / (kN / D);
    tile = 64 * row;  // a multiple of 1024
    kr = 0;
    kc = kr + tile;
    q = kc + tile;
    ring = q + kWG * 4 * tile;
    acol = ring + stages * group;
    bias = acol + kWG * H * kAP * 4;
    bars = bias + 2 * 64 * 4;
    total = bars + (2 * stages + 1 + 2 * kWG) * 8;
  }
};

// Ring stages: every group of H rows when they fit, else as many as fit.
int stages_for(int D, int H, int W) {
  const Bf16Layout none(D, H, W, 0);
  const int avail = kMaxSmem - 1024 - none.total;
  return std::min(none.groups, avail / (none.group + 16));
}

template <int D>
__global__ void __launch_bounds__(kBf16Threads, 1)
rcda_wgmma_kernel(const __grid_constant__ CUtensorMap map_qr,
                  const __grid_constant__ CUtensorMap map_qc,
                  const __grid_constant__ CUtensorMap map_kr,
                  const __grid_constant__ CUtensorMap map_kc,
                  const __grid_constant__ CUtensorMap map_v,
                  const __nv_bfloat16* __restrict__ bias_row,
                  const __nv_bfloat16* __restrict__ bias_col, __nv_bfloat16* __restrict__ out,
                  int L, int H, int W, int E, int stages) {
  using namespace hopper;
  constexpr int kRow = 2 * D;
  const Bf16Layout lay(D, H, W, stages);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + lay.bias);  // row [64], then col [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* k_full = empty + stages;
  uint64_t* q_full = k_full + 1;  // [kWG][2]
  const bool resident = stages >= lay.groups;
  constexpr int kG = kN / D;  // H rows per group

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.y, b = blockIdx.z;
  const int t_begin = blockIdx.x * kTilesPerBlock;
  const int t_end = min(t_begin + kTilesPerBlock, (L + kTQ - 1) / kTQ);
  const int rounds = (t_end - t_begin + kWG - 1) / kWG;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 128);
    }
    mbar_init(k_full, 1);
    for (int i = 0; i < 2 * kWG; ++i) mbar_init(&q_full[i], 1);
    fence_barrier_init();
  }
  for (int i = tid; i < 128; i += kBf16Threads) {
    const int j = i % 64;
    s_bias[i] = i < 64 ? (j < W ? __bfloat162float(bias_row[b * W + j]) : -INFINITY)
                       : (j < H ? __bfloat162float(bias_col[b * H + j]) : -INFINITY);
  }
  __syncthreads();

  if (warp == kWG * 4) {
    // producer: the key slices, then each group of H rows of values into
    // stage i % stages (once when resident; once a round otherwise); rows
    // past H arrive as zeros
    if (lane == 0) {
      mbar_arrive_expect_tx(k_full, 2 * 64 * kRow);
      tma_load_3d(smem + lay.kr, &map_kr, k_full, head * D, 0, b);
      tma_load_3d(smem + lay.kc, &map_kc, k_full, head * D, 0, b);
      const int n = resident ? lay.groups : rounds * lay.groups;
      for (int i = 0; i < n; ++i) {
        const int st = i % stages;
        if (!resident) mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], lay.group);
        tma_load_4d(smem + lay.ring + st * lay.group, &map_v, &full[st], head * D, 0,
                    (i % lay.groups) * kG, b);
      }
    }
    return;
  }

  // consumers: warp wl of warpgroup wg owns tile rows lr and lr + 8
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, c = lane % 4;
  const int lr = wl * 16 + g;
  float* s_acol = reinterpret_cast<float*>(smem + lay.acol) + wg * H * kAP;  // [H][kAP]
  const uint32_t kr_addr = smem_u32(smem + lay.kr), kc_addr = smem_u32(smem + lay.kc);
  const uint32_t ring_addr = smem_u32(smem + lay.ring);
  uint8_t* q_buf = smem + lay.q + wg * 4 * lay.tile;  // [2 buffers][row, col]
  const int nks = (W + 15) / 16;  // k-steps over w
  // this warpgroup's q tiles of round rr into buffer rr % 2, by its thread 0
  auto load_q = [&](int rr) {
    const int tile = t_begin + rr * kWG + wg;
    if (tid % 128 != 0 || rr >= rounds || tile >= t_end) return;
    uint64_t* bar = &q_full[2 * wg + rr % 2];
    uint8_t* dst = q_buf + (rr % 2) * 2 * lay.tile;
    mbar_arrive_expect_tx(bar, 2 * lay.tile);
    tma_load_3d(dst, &map_qr, bar, head * D, tile * kTQ, b);
    tma_load_3d(dst + lay.tile, &map_qc, bar, head * D, tile * kTQ, b);
  };
  load_q(0);
  mbar_wait(k_full, 0);

  for (int r = 0; r < rounds; ++r) {
    // the warpgroup is past round r - 1, the last reader of buffer (r + 1) % 2
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    load_q(r + 1);
    const int tile = t_begin + r * kWG + wg;
    const int seq0 = resident ? 0 : r * lay.groups;  // ring sequence of this round's group 0
    auto slot = [&](int gi) { return (seq0 + gi) % stages; };
    auto parity = [&](int gi) { return static_cast<uint32_t>(((seq0 + gi) / stages) & 1); };
    if (tile >= t_end) {  // no tile this round: release the streamed groups all the same
      if (!resident)
        for (int gi = 0; gi < lay.groups; ++gi) {
          mbar_wait(&full[slot(gi)], parity(gi));
          mbar_arrive(&empty[slot(gi)]);
        }
      continue;
    }
    const int r0 = tile * kTQ + lr, r1 = r0 + 8;

    // both score products at once: q tiles and key tiles from shared memory
    float s_row[32], s_col[32];
    {
      mbar_wait(&q_full[2 * wg + r % 2], (r / 2) & 1);
      const uint32_t qr_addr = smem_u32(q_buf + (r % 2) * 2 * lay.tile);
      const uint32_t qc_addr = qr_addr + lay.tile;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s_row, desc<D>(qr_addr + 32 * ks), desc<D>(kr_addr + 32 * ks), ks);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(s_col, desc<D>(qc_addr + 32 * ks), desc<D>(kc_addr + 32 * ks), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s_row);
      fence_regs(s_col);
    }
    // softmax over the 64 columns (-inf past the axis), normalised in s
    auto softmax = [&](float (&s)[32], const float* bias) {
      float mx[2] = {-FLT_MAX, -FLT_MAX}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = (s[4 * j + e] + bias[8 * j + 2 * c + (e & 1)]) * kLog2e;
          s[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      mx[0] = quad_max(mx[0]);
      mx[1] = quad_max(mx[1]);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s[i] = ex2(s[i] - mx[(i >> 1) & 1]);
        sum[(i >> 1) & 1] += s[i];
      }
      const float rs[2] = {1.f / quad_sum(sum[0]), 1.f / quad_sum(sum[1])};
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= rs[(i >> 1) & 1];
    };

    // a_row rounded to bf16, as the A operand of the k-steps over w
    uint32_t af[kMaxAxisBf16 / 16][4];
    softmax(s_row, s_bias);
#pragma unroll
    for (int ks = 0; ks < kMaxAxisBf16 / 16; ++ks)
#pragma unroll
      for (int i = 0; i < 4; ++i) af[ks][i] = pack_bf16(s_row[8 * ks + 2 * i], s_row[8 * ks + 2 * i + 1]);
    // a_col in f32 into this warpgroup's map, rows of this warp only
    softmax(s_col, s_bias + 64);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = 8 * j + 2 * c + (e & 1);
        if (h < H) s_acol[h * kAP + lr + 8 * (e >> 1)] = s_col[4 * j + e];
      }
    __syncwarp();

    // the combine, kG rows of H a product: hid[h] = a_row v[h] for the
    // group's rows side by side (N = kG * D, one D-wide block per row, LBO
    // one row's slice), then out += a_col[l, h] * hid[h] in registers
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    for (int gi = 0; gi < lay.groups; ++gi) {
      mbar_wait(&full[slot(gi)], parity(gi));
      const uint32_t va = ring_addr + slot(gi) * lay.group;
      float hid[kN / 2];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kMaxAxisBf16 / 16; ++ks)
        if (ks < nks) wgmma_rs<kN>(hid, af[ks], desc<D>(va + 16 * kRow * ks, lay.slice), ks);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(hid);
      if (!resident) mbar_arrive(&empty[slot(gi)]);
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

    __nv_bfloat16* ob = out + static_cast<size_t>(b) * L * E + head * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = 8 * i + 2 * c;
      if (r0 < L)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * E + col) =
            pack_bf16(acc[4 * i], acc[4 * i + 1]);
      if (r1 < L)
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * E + col) =
            pack_bf16(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
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
  return static_cast<size_t>(Bf16Layout(D, H, W, stages_for(D, H, W)).total) + 1024;
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
  if (H > kMaxAxisBf16 || W > kMaxAxisBf16) return static_cast<int>(cudaErrorInvalidValue);
  // q (E, L, B) and key slices (E, W|H, B) in boxes of {D, 64, 1}; values (E, W, H, B) in
  // boxes of one group of H rows {D, W padded to 16, kN / D, 1}; all at
  // column head * D
  using U = cuuint64_t;
  const U dims_q[3] = {U(E), U(L), U(B)};
  const U dims_kr[3] = {U(E), U(W), U(B)}, dims_kc[3] = {U(E), U(H), U(B)};
  const U dims_v[4] = {U(E), U(W), U(H), U(B)};
  const cuuint32_t box_k[3] = {D, 64, 1};
  const cuuint32_t box_v[4] = {D, static_cast<cuuint32_t>((W + 15) & ~15), kN / D, 1};
  CUtensorMap map_qr, map_qc, map_kr, map_kc, map_v;
  if (!hopper::bf16_map<D>(&map_qr, q_row, 3, dims_q, box_k) ||
      !hopper::bf16_map<D>(&map_qc, q_col, 3, dims_q, box_k) ||
      !hopper::bf16_map<D>(&map_kr, k_row, 3, dims_kr, box_k) ||
      !hopper::bf16_map<D>(&map_kc, k_col, 3, dims_kc, box_k) ||
      !hopper::bf16_map<D>(&map_v, v, 4, dims_v, box_v))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = rcda_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kern, attr, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (L + kTQ - 1) / kTQ;
  const dim3 grid((ntiles + kTilesPerBlock - 1) / kTilesPerBlock, num_heads, B);
  using F = const __nv_bfloat16*;
  kern<<<grid, kBf16Threads, smem, stream>>>(
      map_qr, map_qc, map_kr, map_kc, map_v, static_cast<F>(bias_row), static_cast<F>(bias_col), static_cast<__nv_bfloat16*>(out), L, H,
      W, E, stages_for(D, H, W));
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
