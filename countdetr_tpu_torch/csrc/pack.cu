// Pad, mask and space-to-depth pack a predict call's requests on the card,
// sm_90a: one launch for the whole batch, from the requests' raw images
// staged back to back in one buffer (one host-to-device copy).
//
// Replaces no TPU kernel. The JAX package, and the port's Batcher, pack on
// the host (data/batching.py: pad_to_bucket, np.stack, pack_space_to_depth);
// serving packs here instead, so the host only copies each raw image once
// into a pinned buffer (serve.py::stage_requests). The output equals the
// host pack's bit for bit (ops/kernels/pack_kernel.py::pack_images_plain).
//
//   staged (N,)            u8   raw HWC RGB images; request b's h x w x 3
//                               bytes start at table[b].offset
//   table  (B, 3)          i64  (offset, h, w) a request, h <= H, w <= W
//   images (B, H/2, W/2, 12) u8 out: channel (a*2+bb)*3 + c of block (i, j)
//                               is pixel (2i+a, 2j+bb)'s channel c, 0 on
//                               padding
//   mask   (B, H, W)       u8   out (torch.bool): 1 on padding
//
// What bounds it on this card: bytes. Each staged byte is read once, each
// output byte written once: at the serving pool's mean batch (32 images of
// 480 x 480 in a 592 x 592 bucket) 21.6 MB in, 33.6 + 11.2 MB out, ~20 us
// at 3.35 TB/s; there is no arithmetic to speak of.
//
// Design. The grid is two ranges of 256-thread blocks. The first gives one
// thread to each output 2x2 block: it reads the block's two rows as two
// 6-byte runs (3 bytes, or none, at the image's right and bottom edges, so
// any h and w work, odd ones included) and writes its 12 output bytes as
// three 4-byte stores; neighbouring threads read and write neighbouring
// bytes. The second writes the mask, 16 bytes a thread in one 16-byte
// store (a byte at a time for a tail shorter than 16).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaskBytes = 16;  // mask bytes a thread

__device__ __forceinline__ void load_row(const uint8_t* __restrict__ src, int pixels,
                                         uint8_t* dst) {
  // pixels in {0, 1, 2}: the run's pixels inside the image, the rest zero
#pragma unroll
  for (int k = 0; k < 6; ++k) dst[k] = k < 3 * pixels ? src[k] : 0;
}

__global__ void __launch_bounds__(kThreads)
    pack_kernel(const uint8_t* __restrict__ staged, const int64_t* __restrict__ table,
                uint8_t* __restrict__ images, uint8_t* __restrict__ mask, int B, int H,
                int W, long long image_ctas) {
  const int H2 = H / 2, W2 = W / 2;
  if (blockIdx.x < image_ctas) {
    const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
    const long long per_image = static_cast<long long>(H2) * W2;
    if (t >= per_image * B) return;
    const int b = static_cast<int>(t / per_image);
    const int r = static_cast<int>(t - b * per_image);
    const int i = r / W2, j = r % W2;
    const long long off = table[3 * b];
    const int h = static_cast<int>(table[3 * b + 1]);
    const int w = static_cast<int>(table[3 * b + 2]);
    const int x = 2 * j;
    const int pixels = x >= w ? 0 : (x + 1 < w ? 2 : 1);
    uint8_t v[12];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int y = 2 * i + a;
      load_row(staged + off + (static_cast<long long>(y) * w + x) * 3, y < h ? pixels : 0,
               v + 6 * a);
    }
    uint32_t* dst = reinterpret_cast<uint32_t*>(images + t * 12);
#pragma unroll
    for (int q = 0; q < 3; ++q)
      dst[q] = v[4 * q] | (v[4 * q + 1] << 8) | (v[4 * q + 2] << 16) |
               (static_cast<uint32_t>(v[4 * q + 3]) << 24);
    return;
  }
  const long long total = static_cast<long long>(B) * H * W;
  const long long f0 =
      ((static_cast<long long>(blockIdx.x) - image_ctas) * kThreads + threadIdx.x) * kMaskBytes;
  if (f0 >= total) return;
  const long long per_image = static_cast<long long>(H) * W;
  int b = static_cast<int>(f0 / per_image);
  const int r = static_cast<int>(f0 - b * per_image);
  int y = r / W, x = r % W;
  int h = static_cast<int>(table[3 * b + 1]), w = static_cast<int>(table[3 * b + 2]);
  const int n = total - f0 < kMaskBytes ? static_cast<int>(total - f0) : kMaskBytes;
  uint8_t m[kMaskBytes];
#pragma unroll
  for (int k = 0; k < kMaskBytes; ++k) {
    m[k] = (y >= h || x >= w) ? 1 : 0;
    if (++x == W) {
      x = 0;
      if (++y == H && k + 1 < n) {
        y = 0;
        ++b;
        h = static_cast<int>(table[3 * b + 1]);
        w = static_cast<int>(table[3 * b + 2]);
      }
    }
  }
  if (n == kMaskBytes) {
    uint4 word;
    uint32_t* u = reinterpret_cast<uint32_t*>(&word);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      u[q] = m[4 * q] | (m[4 * q + 1] << 8) | (m[4 * q + 2] << 16) |
             (static_cast<uint32_t>(m[4 * q + 3]) << 24);
    *reinterpret_cast<uint4*>(mask + f0) = word;
  } else {
    for (int k = 0; k < n; ++k) mask[f0 + k] = m[k];
  }
}

}  // namespace

// The whole batch in one launch on `stream`. H and W even and positive, B
// positive; images and mask 16-byte aligned. Returns cudaGetLastError().
extern "C" int pack_forward(const void* staged, const void* table, void* images, void* mask,
                            int B, int H, int W, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % 2 || W % 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = static_cast<long long>(B) * (H / 2) * (W / 2);
  const long long chunks = (static_cast<long long>(B) * H * W + kMaskBytes - 1) / kMaskBytes;
  const long long image_ctas = (blocks + kThreads - 1) / kThreads;
  const long long mask_ctas = (chunks + kThreads - 1) / kThreads;
  if (image_ctas + mask_ctas > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_kernel<<<static_cast<unsigned>(image_ctas + mask_ctas), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(staged), static_cast<const int64_t*>(table),
      static_cast<uint8_t*>(images), static_cast<uint8_t*>(mask), B, H, W, image_ctas);
  return static_cast<int>(cudaGetLastError());
}
