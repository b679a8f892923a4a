// The bf16 Hopper machinery shared by the two RCDA kernels (rcda.cu, the
// two-stage v3 combine, and rcda_rank1.cu, the rank-1 combine): the block
// layout, the producer warp that brings the key and value slices by TMA,
// the q tiles by TMA one round ahead, both score products on wgmma and both
// softmaxes in f32 registers, and the epilogue. Each kernel supplies only
// its combine.
//
// A block is kWG = 3 consumer warpgroups and a producer warp, and takes
// kTilesPerBlock = 6 query tiles of 64 of one (batch, head), kWG at a time.
// The producer loads both key slices once and the value slice v[b, :, :,
// head] in groups of kN / D rows of H ([W][d] per row, W padded to 16 by
// zero rows) into a ring of mbarrier-guarded stages; when the slice fits in
// shared memory (37x37 at d=32: 114 KB) the ring holds all of it, loaded
// once for every tile of the block, otherwise the groups stream again for
// each round of tiles and the consumers release each stage on its empty
// barrier. No block-wide barrier falls inside the loops. Per tile a
// warpgroup computes s_row = q_row k_row^T and s_col = q_col k_col^T in one
// commit by wgmma m64n64k16 (K-major operands in shared memory; columns
// past W or H at bias -inf), both softmaxes in registers (one ex2 a score,
// normalised by a reciprocal), hands the row map to the combine as f32
// accumulator registers and writes a_col (f32) into its own [H][kAP] map.

#pragma once

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstddef>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"
#include "mma.cuh"
#include "rcda_scores.cuh"

namespace rcda_wgmma {

constexpr int kMaxAxis = 64;       // H, W limit: one 64-wide score tile
constexpr int kTQ = 64;            // queries per tile: one consumer warpgroup
constexpr int kWG = 3;             // consumer warpgroups per block
constexpr int kTilesPerBlock = 6;  // query tiles per block, kWG at a time
constexpr int kThreads = kWG * 128 + 32;
constexpr int kAP = 68;            // a_col row pitch in floats: conflict-free writes
constexpr int kN = 64;             // a value group: kN / D rows of H
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory in bytes from a 1024-aligned base: the two key tiles (64
// rows each), each warpgroup's q_row and q_col tiles in two buffers
// [kWG][2][2] (64 rows each), the ring of value row groups (kN / D rows of
// H each, [W][d] per row, W padded to 16), each warpgroup's a_col map
// [H][kAP], the biases (f32, -inf past W and H), the barriers: ring full
// and empty, the key tiles' and each warpgroup's two q buffers'.
struct Layout {
  int slice, group, groups, tile, kr, kc, q, ring, acol, bias, bars, total;
  __host__ __device__ Layout(int D, int H, int W, int stages) {
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
inline int stages_for(int D, int H, int W) {
  const Layout none(D, H, W, 0);
  const int avail = kMaxSmem - 1024 - none.total;
  return std::min(none.groups, avail / (none.group + 16));
}

// Dynamic shared memory of one block, the 1024-byte alignment slack included.
inline size_t smem_bytes(int D, int H, int W) {
  return static_cast<size_t>(Layout(D, H, W, stages_for(D, H, W)).total) + 1024;
}

// The value groups of one tile as a combine sees them: wait(gi) returns the
// shared address of group gi once it has landed; release(gi) hands a
// streamed stage back to the producer (a no-op when resident).
struct Ring {
  uint64_t* full;
  uint64_t* empty;
  uint32_t addr;
  int group, slice, groups, stages, seq0;
  bool resident;
  __device__ int slot(int gi) const { return (seq0 + gi) % stages; }
  __device__ uint32_t parity(int gi) const {
    return static_cast<uint32_t>(((seq0 + gi) / stages) & 1);
  }
  __device__ uint32_t wait(int gi) const {
    hopper::mbar_wait(&full[slot(gi)], parity(gi));
    return addr + slot(gi) * group;
  }
  __device__ void release(int gi) const {
    if (!resident) hopper::mbar_arrive(&empty[slot(gi)]);
  }
};

// The kernel body. Combine is default-constructed per tile and called as
//   comb.take_row(a_row)   right after the row softmax: float[32], the
//                          normalised f32 map at the accumulator layout of
//                          hopper.cuh (columns past W are 0);
//   comb(s_acol, ring, lr, H, W, acc)   after a_col is in this warpgroup's
//                          map (s_acol[h * kAP + row]); accumulates the tile's
//                          output rows lr and lr + 8 into acc[D / 2] (zeroed),
//                          at the accumulator layout of an m64nD product.
template <int D, typename Combine>
__device__ __forceinline__ void run(const CUtensorMap* map_qr, const CUtensorMap* map_qc,
                                    const CUtensorMap* map_kr, const CUtensorMap* map_kc,
                                    const CUtensorMap* map_v,
                                    const __nv_bfloat16* __restrict__ bias_row,
                                    const __nv_bfloat16* __restrict__ bias_col,
                                    __nv_bfloat16* __restrict__ out, int L, int H, int W, int E,
                                    int stages) {
  using namespace hopper;
  constexpr int kRow = 2 * D;
  const Layout lay(D, H, W, stages);
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
  for (int i = tid; i < 128; i += kThreads) {
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
      tma_load_3d(smem + lay.kr, map_kr, k_full, head * D, 0, b);
      tma_load_3d(smem + lay.kc, map_kc, k_full, head * D, 0, b);
      const int n = resident ? lay.groups : rounds * lay.groups;
      for (int i = 0; i < n; ++i) {
        const int st = i % stages;
        if (!resident) mbar_wait(&empty[st], ((i / stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[st], lay.group);
        tma_load_4d(smem + lay.ring + st * lay.group, map_v, &full[st], head * D, 0,
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
  uint8_t* q_buf = smem + lay.q + wg * 4 * lay.tile;  // [2 buffers][row, col]
  // this warpgroup's q tiles of round rr into buffer rr % 2, by its thread 0
  auto load_q = [&](int rr) {
    const int tile = t_begin + rr * kWG + wg;
    if (tid % 128 != 0 || rr >= rounds || tile >= t_end) return;
    uint64_t* bar = &q_full[2 * wg + rr % 2];
    uint8_t* dst = q_buf + (rr % 2) * 2 * lay.tile;
    mbar_arrive_expect_tx(bar, 2 * lay.tile);
    tma_load_3d(dst, map_qr, bar, head * D, tile * kTQ, b);
    tma_load_3d(dst + lay.tile, map_qc, bar, head * D, tile * kTQ, b);
  };
  load_q(0);
  mbar_wait(k_full, 0);

  for (int r = 0; r < rounds; ++r) {
    // the warpgroup is past round r - 1, the last reader of buffer (r + 1) % 2
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
    load_q(r + 1);
    const int tile = t_begin + r * kWG + wg;
    const Ring ring{full, empty, smem_u32(smem + lay.ring), lay.group, lay.slice, lay.groups,
                    stages, resident ? 0 : r * lay.groups, resident};
    if (tile >= t_end) {  // no tile this round: release the streamed groups all the same
      if (!resident)
        for (int gi = 0; gi < lay.groups; ++gi) {
          ring.wait(gi);
          ring.release(gi);
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

    Combine comb;
    softmax(s_row, s_bias);
    comb.take_row(s_row);
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

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    comb(s_acol, ring, lr, H, W, acc);

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

// Host side: the tensor maps and the launch of a kernel built on run<D>.
// q (E, L, B) and key slices (E, W|H, B) in boxes of {D, 64, 1}; values (E,
// W, H, B) in boxes of one group of H rows {D, W padded to 16, kN / D, 1};
// all at column head * D. Returns a CUDA error code (0: queued).
template <int D, typename Kernel>
int launch(Kernel kern, const void* q_row, const void* q_col, const void* k_row,
           const void* k_col, const void* v, const void* bias_row, const void* bias_col,
           void* out, int B, int L, int H, int W, int E, int num_heads, cudaStream_t stream) {
  if (H > kMaxAxis || W > kMaxAxis) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D, H, W);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
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
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntiles = (L + kTQ - 1) / kTQ;
  const dim3 grid((ntiles + kTilesPerBlock - 1) / kTilesPerBlock, num_heads, B);
  using F = const __nv_bfloat16*;
  kern<<<grid, kThreads, smem, stream>>>(map_qr, map_qc, map_kr, map_kc, map_v,
                                         static_cast<F>(bias_row), static_cast<F>(bias_col),
                                         static_cast<__nv_bfloat16*>(out), L, H, W, E,
                                         stages_for(D, H, W));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rcda_wgmma
