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
//  * float32 (the CLI's default dtype), for both variants: the wrapper
//    (ops/kernels/rcda_kernel.py::kernel_route) sends float32 rank-1 calls
//    here too, since rounding P once (rank-1) or each probability map (v3)
//    to float32 is the identity, and the two formulations are one function
//    up to the order of an f32 sum.
//  * float32 on the tensor cores (f32tc below): every product in
//    3xTF32 on the tensor cores (tf32.cuh), so f32 accuracy at 495 / 3
//    TFLOP/s: 0.201 ms of operations at B=32, L=1369. Two consumer
//    warpgroups over 4 query tiles of one (batch, head) and a producer
//    warpgroup that hands its registers to them (setmaxnreg) and issues the
//    TMA loads: the key slices once (split into hi and lo in shared memory,
//    the B operand of both score products), the value slice in groups of
//    kN / D rows of H ([kG][W8][d] floats, 10 KB at 37x37) through a ring
//    of 4 stages, once a round of 2 tiles. wgmma takes tf32 operands from
//    shared memory only K-major, and v[h] is stored [w][d] (MN-major for
//    a_row v[h]), so the combine is turned around: hid^T = v^T a_row^T,
//    the value group (M = 64 value rows, K = w) the register A operand,
//    each thread loading its fragment straight from the TMA-landed tile
//    and splitting it in registers, and a_row^T (N = 64 queries, K = w) the
//    B operand, split and written once a tile. Nothing per value group is
//    transposed or written back. out^T += a_col[l, h] hid^T in f32
//    registers; the warps' partial sums (one per H row of a group) meet in
//    shared memory at the tile's end. The two warpgroups take turns
//    issuing their products (named barriers), so one's loads, splits and
//    FMAs run under the other's products: per value group a warpgroup
//    issues ~395 instructions beside 15 k8 products (~525 cycles of the
//    tensor cores), so issue, not the tensor cores, bounds it (0.50 ms at
//    B=32 L=1369, 40% of the bound; PERF.md). H and W up to 64 (one
//    64-wide score tile), d up to 32 (a row of q or k in one swizzle span).
//  * float32 past those limits (H or W > 64, d = 64): the score phase of
//    rcda_scores.cuh on the CUDA cores, then each thread a 4 query x 4
//    channel register tile, two float4 shared reads per 16 FMAs, one value
//    row staged at a time (rcda_f32_kernel).
// The Mosaic workarounds of the TPU kernel (the 0/1 fold matrix,
// pltpu.repeat, the (B, n, W, d*H) value reshuffle) have no counterpart:
// on CUDA the head-weighted combine is a plain accumulation in registers.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstddef>

#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "rcda_scores.cuh"
#include "rcda_wgmma.cuh"
#include "tf32.cuh"

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

// ------------------------------------------------ float32, tensor cores ---

namespace f32tc {

constexpr int kWG = 2;             // consumer warpgroups
constexpr int kTilesPerBlock = 4;  // query tiles of 64 of one (batch, head), kWG at a time
constexpr int kThreads = (kWG + 1) * 128;  // plus the producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;  // setmaxnreg: 128 x 40 + 256 x 232
constexpr int kMaxStages = 4;      // value groups in flight, as many as fit
constexpr int kN = 64;             // a value group: kN / D rows of H, the M of its product
constexpr int kAP = 68;            // a_col row pitch in floats
constexpr int kTurn = kWG + 2;     // named barriers kTurn + wg: warpgroup wg's turn to issue
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory in bytes from a 1024-aligned base: the key slices k_row and
// k_col (64 rows of D floats, Rows<D>; hi in place, then their lo parts);
// per warpgroup its q_row and q_col tiles as TMA lands them (Rows<D>),
// a_row^T (Cols: 64 query rows by W8 = W rounded up to 8; hi, then lo),
// which the tile's end reuses to sum the warps' partial outputs
// ([64 / D][64][D + 4] floats), and its a_col map [H][kAP]; the ring of
// value groups ([kN / D][W8][D], Rows<D>); the biases (f32, -inf past W
// and H); the barriers: ring full and empty, the key slices, each
// warpgroup's q tiles.
struct Layout {
  int w8, groups, group, tile, wg_bytes, kr, kc, kr_lo, kc_lo, wg, q, art, art_lo, acol, ring,
      bias, bars, total;
  __host__ __device__ Layout(int D, int H, int W, int stages) {
    const int row = D == 16 ? 64 : 128;  // Rows<D>::kRowBytes (D <= 32)
    w8 = (W + 7) & ~7;
    groups = (H + kN / D - 1) / (kN / D);
    group = (kN / D * w8 * row + 1023) & ~1023;
    tile = 64 * row;
    kr = 0;
    kc = kr + tile;
    kr_lo = kc + tile;
    kc_lo = kr_lo + tile;
    wg = kc_lo + tile;  // the warpgroups' areas, wg_bytes each
    q = 0;              // (offsets inside a warpgroup's area)
    art = q + 2 * tile;
    art_lo = (w8 + 31) / 32 * 64 * 128;
    const int red = 64 / D * 64 * (D + 4) * 4;
    acol = art + (2 * art_lo > red ? 2 * art_lo : red);
    wg_bytes = (acol + H * kAP * 4 + 1023) & ~1023;
    ring = wg + kWG * wg_bytes;
    bias = ring + stages * group;
    bars = bias + 2 * 64 * 4;
    total = bars + (2 * stages + 1 + kWG) * 8;
  }
};

// Ring stages: as many as fit, up to kMaxStages (0: none fits).
inline int stages_for(int D, int H, int W) {
  int s = kMaxStages;
  while (s > 0 && Layout(D, H, W, s).total + 1024 > kMaxSmem) --s;
  return s;
}

inline size_t smem_bytes(int D, int H, int W) {
  const int s = stages_for(D, H, W);
  return s ? static_cast<size_t>(Layout(D, H, W, s).total) + 1024 : ~size_t{0} >> 1;
}

// The A operand of k-step ks from a Rows<D> tile of 64 rows (row 16 wl + g
// and + 8, columns 8 ks + c and + 4), split into hi and lo.
template <int D>
__device__ __forceinline__ void load_a(const uint8_t* tile, int rows, int r0, int ks, int c,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  using R = tf32::Rows<D>;
  const int rr[4] = {r0, r0 + 8, r0, r0 + 8}, cc[4] = {8 * ks + c, 8 * ks + c, 8 * ks + c + 4,
                                                       8 * ks + c + 4};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float h, l;
    tf32::split(*reinterpret_cast<const float*>(tile + R::offset(rows, rr[e], cc[e])), h, l);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(l);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
rcda_tf32_kernel(const __grid_constant__ CUtensorMap map_qr,
                 const __grid_constant__ CUtensorMap map_qc,
                 const __grid_constant__ CUtensorMap map_kr,
                 const __grid_constant__ CUtensorMap map_kc,
                 const __grid_constant__ CUtensorMap map_v, const float* __restrict__ bias_row,
                 const float* __restrict__ bias_col, float* __restrict__ out, int L, int H, int W,
                 int E, int stages) {
  using namespace hopper;
  using R = tf32::Rows<D>;
  using tf32::Cols;
  constexpr int kG = kN / D;  // H rows per group
  const Layout lay(D, H, W, stages);
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_bias = reinterpret_cast<float*>(smem + lay.bias);  // row [64], then col [64]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + stages;
  uint64_t* k_full = empty + stages;
  uint64_t* q_full = k_full + 1;  // [kWG]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int head = blockIdx.y, b = blockIdx.z;
  const int t_begin = blockIdx.x * kTilesPerBlock;
  const int t_end = min(t_begin + kTilesPerBlock, (L + 63) / 64);
  const int rounds = (t_end - t_begin + kWG - 1) / kWG;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWG * 128);
    }
    mbar_init(k_full, 1);
    for (int i = 0; i < kWG; ++i) mbar_init(&q_full[i], 1);
    fence_barrier_init();
  }
  for (int i = tid; i < 128; i += kThreads) {
    const int j = i % 64;
    s_bias[i] = i < 64 ? (j < W ? bias_row[b * W + j] : -INFINITY)
                       : (j < H ? bias_col[b * H + j] : -INFINITY);
  }
  __syncthreads();

  // The value slice streams once a round, kG rows of H a group (rows past W
  // and H arrive as zeros).
  const int n_groups = rounds * lay.groups;
  auto load_group = [&](int i) {
    const int st = i % stages;
    mbar_arrive_expect_tx(&full[st], kG * lay.w8 * R::kRowBytes);
    tma_load_4d(smem + lay.ring + st * lay.group, &map_v, &full[st], head * D, 0,
                (i % lay.groups) * kG, b);
  };
  if (warp >= kWG * 4) {
    // producer warpgroup: it hands its registers to the consumers, and its
    // first thread issues the TMA loads of the key slices and of each
    // value group into stage i % stages once the consumers released it
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == kWG * 128) {
      mbar_arrive_expect_tx(k_full, 2 * lay.tile);
      tma_load_3d(smem + lay.kr, &map_kr, k_full, head * D, 0, b);
      tma_load_3d(smem + lay.kc, &map_kc, k_full, head * D, 0, b);
      for (int i = 0; i < n_groups; ++i) {
        if (i >= stages) mbar_wait(&empty[i % stages], ((i / stages) - 1) & 1);
        load_group(i);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int wg = warp / 4, wl = warp % 4, g = lane / 4, c = lane % 4, ct = tid % 128;
  const int r0 = 16 * wl + g;
  uint8_t* area = smem + lay.wg + wg * lay.wg_bytes;
  uint8_t* q_tiles = area + lay.q;  // q_row, q_col
  uint8_t* art = area + lay.art;    // a_row^T: hi, then lo
  float* s_acol = reinterpret_cast<float*>(area + lay.acol);  // [H][kAP]
  const uint32_t art_hi = smem_u32(art), art_lo = art_hi + lay.art_lo;
  const uint32_t kr_hi = smem_u32(smem + lay.kr), kc_hi = smem_u32(smem + lay.kc);
  const uint32_t kr_lo = smem_u32(smem + lay.kr_lo), kc_lo = smem_u32(smem + lay.kc_lo);
  const int nks = lay.w8 / 8;  // k-steps over w
  auto load_q = [&](int rr) {  // this warpgroup's q tiles of round rr, by its thread 0
    const int tile = t_begin + rr * kWG + wg;
    if (ct != 0 || rr >= rounds || tile >= t_end) return;
    mbar_arrive_expect_tx(&q_full[wg], 2 * lay.tile);
    tma_load_3d(q_tiles, &map_qr, &q_full[wg], head * D, tile * 64, b);
    tma_load_3d(q_tiles + lay.tile, &map_qc, &q_full[wg], head * D, tile * 64, b);
  };
  load_q(0);
  // the key slices: hi in place, lo beside them, split once by all consumers
  mbar_wait(k_full, 0);
  tf32::split_rows<D>(smem + lay.kr, smem + lay.kr_lo, 64, tid, kWG * 128);
  tf32::split_rows<D>(smem + lay.kc, smem + lay.kc_lo, 64, tid, kWG * 128);
  tf32::fence_proxy_async();
  tf32::bar_sync(kWG + 1, kWG * 128);
  if (wg == 1) tf32::bar_arrive(kTurn, kWG * 128);  // warpgroup 0 issues first

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

  // Warp wl of warpgroup wg owns rows r0 = 16 wl + g and r0 + 8 of each
  // 64-row product: query rows in the scores, value rows hl D + ch in the
  // combine. The combine of one tile over the round's value groups seq0 ..
  // takes NKS k-steps over w, known at compile time (straight-line
  // products); a group's product waits for this warpgroup's turn, so the two
  // warpgroups issue in alternation and one's loads and FMAs run under the
  // other's products.
  const int hl = 16 * wl / D, vrow = r0 % D;  // this warp's H row of a group, its channel
  uint32_t v_off[4];  // its A elements of k-step 0 in a group tile: k-step ks is 8 rows on
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v_off[e] = R::offset(kG * lay.w8, hl * lay.w8 + c + 4 * (e >> 1), vrow + 8 * (e & 1));
  const uint64_t art_hi_desc = Cols::desc(art_hi, 64, 0), art_lo_desc = Cols::desc(art_lo, 64, 0);
  auto combine = [&](auto nks_c, int seq0, float (&acc)[32]) {
    constexpr int NKS = decltype(nks_c)::value;
    for (int gi = 0; gi < lay.groups; ++gi) {
      const int i = seq0 + gi, st = i % stages;
      mbar_wait(&full[st], (i / stages) & 1);
      // v^T's A operands: split into registers, then the stage is released
      uint32_t v_hi[NKS][4], v_lo[NKS][4];
      const uint8_t* grp = smem + lay.ring + st * lay.group;
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float h, l;
          tf32::split(*reinterpret_cast<const float*>(grp + v_off[e] + 8 * ks * R::kRowBytes),
                      h, l);
          v_hi[ks][e] = __float_as_uint(h);
          v_lo[ks][e] = __float_as_uint(l);
        }
      mbar_arrive(&empty[st]);
      float hid[32];
      tf32::bar_sync(kTurn + wg, kWG * 128);  // this warpgroup's turn to issue
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        tf32::mma_rs<64>(hid, v_hi[ks], art_lo_desc + Cols::step(64, ks), ks);
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        tf32::mma_rs<64>(hid, v_lo[ks], art_hi_desc + Cols::step(64, ks), 1);
#pragma unroll
      for (int ks = 0; ks < NKS; ++ks)
        tf32::mma_rs<64>(hid, v_hi[ks], art_hi_desc + Cols::step(64, ks), 1);
      wgmma_commit();
      tf32::bar_arrive(kTurn + (wg ^ 1), kWG * 128);  // the other's turn
      wgmma_wait<0>();
      fence_regs(hid);
      const int h = gi * kG + hl;
      if (h >= H) continue;
      const float* ac = s_acol + h * kAP;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 a2 = *reinterpret_cast<const float2*>(ac + 8 * j + 2 * c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[4 * j + e] = fmaf((e & 1) ? a2.y : a2.x, hid[4 * j + e], acc[4 * j + e]);
      }
    }
  };

  // s = q k^T over a 64-row q tile and a 64-row key slice (hi, lo split)
  auto score = [&](const uint8_t* q, uint32_t k_hi, uint32_t k_lo, float (&s)[32]) {
    uint32_t q_hi[D / 8][4], q_lo[D / 8][4];
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) load_a<D>(q, 64, r0, ks, c, q_hi[ks], q_lo[ks]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) tf32::mma_rs<64>(s, q_hi[ks], R::desc(k_lo, 64, ks), ks);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) tf32::mma_rs<64>(s, q_lo[ks], R::desc(k_hi, 64, ks), 1);
#pragma unroll
    for (int ks = 0; ks < D / 8; ++ks) tf32::mma_rs<64>(s, q_hi[ks], R::desc(k_hi, 64, ks), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  };

  for (int r = 0; r < rounds; ++r) {
    const int tile = t_begin + r * kWG + wg, seq0 = r * lay.groups;
    if (tile >= t_end) {  // no tile this round (warpgroup 1): release the round's
      for (int gi = 0; gi < lay.groups; ++gi) {  // groups, take the turns all the same
        const int i = seq0 + gi;
        mbar_wait(&full[i % stages], (i / stages) & 1);
        mbar_arrive(&empty[i % stages]);
        tf32::bar_sync(kTurn + wg, kWG * 128);
        tf32::bar_arrive(kTurn + (wg ^ 1), kWG * 128);
      }
      continue;
    }

    // both score products in 3xTF32, q split in registers as the A operand,
    // one after the other (fewer registers live at once)
    float s_row[32], s_col[32];
    mbar_wait(&q_full[wg], r & 1);
    score(q_tiles, kr_hi, kr_lo, s_row);
    score(q_tiles + lay.tile, kc_hi, kc_lo, s_col);
    // every warp is past the products (the q tiles are free) and past the
    // last tile's sums (a_row^T and a_col may be rewritten)
    tf32::bar_sync(1 + wg, 128);
    load_q(r + 1);

    // a_row^T split into hi and lo (the B operand, rows = queries); a_col
    // in f32
    softmax(s_row, s_bias);
    softmax(s_col, s_bias + 64);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * c + (e & 1), row = r0 + 8 * (e >> 1);
        if (col < lay.w8) {
          float h, l;
          tf32::split(s_row[4 * j + e], h, l);
          const uint32_t off = Cols::offset(64, row, col);
          *reinterpret_cast<float*>(art + off) = h;
          *reinterpret_cast<float*>(art + lay.art_lo + off) = l;
        }
        if (col < H) s_acol[col * kAP + row] = s_col[4 * j + e];
      }
    tf32::fence_proxy_async();
    tf32::bar_sync(1 + wg, 128);

    // for each group of kG rows of H: hid^T = v^T a_row^T in 3xTF32 (M =
    // the group's kG x D value rows, N = the 64 queries, K = w), then
    // out^T[ch, l] += a_col[l, h] * hid^T[hl D + ch, l] in f32
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    switch (nks) {  // W <= 64: at most 8 k-steps
      case 1: combine(std::integral_constant<int, 1>{}, seq0, acc); break;
      case 2: combine(std::integral_constant<int, 2>{}, seq0, acc); break;
      case 3: combine(std::integral_constant<int, 3>{}, seq0, acc); break;
      case 4: combine(std::integral_constant<int, 4>{}, seq0, acc); break;
      case 5: combine(std::integral_constant<int, 5>{}, seq0, acc); break;
      case 6: combine(std::integral_constant<int, 6>{}, seq0, acc); break;
      case 7: combine(std::integral_constant<int, 7>{}, seq0, acc); break;
      default: combine(std::integral_constant<int, 8>{}, seq0, acc); break;
    }

    // the warps' partial sums (64 / D of them, one per H row of a group)
    // through shared memory, [part][query][D + 4], then out
    tf32::bar_sync(1 + wg, 128);  // every warp's products are done: a_row^T is free
    float* red = reinterpret_cast<float*>(art);
    constexpr int kPitch = D + 4, kParts = kN / D;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(hl * 64 + 8 * j + 2 * c + (e & 1)) * kPitch + vrow + 8 * (e >> 1)] = acc[4 * j + e];
    tf32::bar_sync(1 + wg, 128);
    float* ob = out + static_cast<size_t>(b) * L * E + head * D;
    for (int x = ct; x < 64 * D / 4; x += 128) {
      const int l = x / (D / 4), ch = 4 * (x % (D / 4));
      float4 s4 = *reinterpret_cast<const float4*>(red + l * kPitch + ch);
#pragma unroll
      for (int p = 1; p < kParts; ++p) {
        const float4 t4 = *reinterpret_cast<const float4*>(red + (p * 64 + l) * kPitch + ch);
        s4.x += t4.x;
        s4.y += t4.y;
        s4.z += t4.z;
        s4.w += t4.w;
      }
      if (tile * 64 + l < L)
        *reinterpret_cast<float4*>(ob + static_cast<size_t>(tile * 64 + l) * E + ch) = s4;
    }
  }
  if (wg == 0) tf32::bar_sync(kTurn, kWG * 128);  // warpgroup 1's last turn handed back
}

// q (E, L, B) and key slices (E, W|H, B) in boxes of {D, 64, 1}; values
// (E, W, H, B) in boxes of one group {D, W8, kN / D, 1}; all at column
// head * D. Returns a CUDA error code (0: queued).
template <int D>
int launch(const void* q_row, const void* q_col, const void* k_row, const void* k_col,
           const void* v, const void* bias_row, const void* bias_col, void* out, int B, int L,
           int H, int W, int E, int num_heads, cudaStream_t stream) {
  if constexpr (D > 32) {  // Layout holds a row of q or k in one 128-byte span
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const int stages = stages_for(D, H, W);
    if (H > 64 || W > 64 || stages == 0) return static_cast<int>(cudaErrorInvalidValue);
    using U = cuuint64_t;
    const U dims_q[3] = {U(E), U(L), U(B)};
    const U dims_kr[3] = {U(E), U(W), U(B)}, dims_kc[3] = {U(E), U(H), U(B)};
    const U dims_v[4] = {U(E), U(W), U(H), U(B)};
    const cuuint32_t box_k[3] = {D, 64, 1};
    const cuuint32_t box_v[4] = {D, static_cast<cuuint32_t>((W + 7) & ~7), kN / D, 1};
    CUtensorMap map_qr, map_qc, map_kr, map_kc, map_v;
    if (!tf32::f32_map<D>(&map_qr, q_row, 3, dims_q, box_k) ||
        !tf32::f32_map<D>(&map_qc, q_col, 3, dims_q, box_k) ||
        !tf32::f32_map<D>(&map_kr, k_row, 3, dims_kr, box_k) ||
        !tf32::f32_map<D>(&map_kc, k_col, 3, dims_kc, box_k) ||
        !tf32::f32_map<D>(&map_v, v, 4, dims_v, box_v))
      return static_cast<int>(cudaErrorInvalidValue);
    auto kern = rcda_tf32_kernel<D>;
    const int smem = Layout(D, H, W, stages).total + 1024;
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int ntiles = (L + 63) / 64;
    const dim3 grid((ntiles + kTilesPerBlock - 1) / kTilesPerBlock, num_heads, B);
    using F = const float*;
    kern<<<grid, kThreads, smem, stream>>>(map_qr, map_qc, map_kr, map_kc, map_v,
                                           static_cast<F>(bias_row), static_cast<F>(bias_col),
                                           static_cast<float*>(out), L, H, W, E, stages);
    return static_cast<int>(cudaGetLastError());
  }
}

}  // namespace f32tc

// ------------------------------------------------------------ dispatch ---

template <int D>
size_t smem_bytes_d(int dtype, int H, int W) {
  if (dtype == 0) return static_cast<size_t>(ScoreLayout(Tiling<D>::TL, D, H, W).end) * 4;
  if (dtype == 2) return D > 32 ? ~size_t{0} >> 1 : f32tc::smem_bytes(D, H, W);
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
  if (dtype == 2)
    return f32tc::launch<D>(q_row, q_col, k_row, k_col, v, bias_row, bias_col, out, B, L, H, W,
                            E, num_heads, stream);
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

// dtype: 0 = float32 on the CUDA cores, 1 = bfloat16, 2 = float32 on the
// tensor cores (3xTF32; D <= 32, H and W <= 64), every tensor, biases
// included. Returns cudaGetLastError() after the launch; 0 means it was
// queued.
extern "C" int rcda_forward(int dtype, const void* q_row, const void* q_col,
                            const void* k_row, const void* k_col,
                            const void* v, const void* bias_row,
                            const void* bias_col, void* out, int B, int L,
                            int H, int W, int E, int num_heads, void* stream) {
  if (num_heads <= 0 || E % num_heads || dtype < 0 || dtype > 2)
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
