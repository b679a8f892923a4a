"""Request-side packing: pad an image into its bucket and space-to-depth pack
a batch (countdetr_tpu/data/batching.py). Pure numpy, on the host."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Bilinear HWC resize (align_corners=False convention); integer images
    are rounded, not truncated."""
    H, W = img.shape[:2]
    ys = (np.arange(h) + 0.5) * (H / h) - 0.5
    xs = (np.arange(w) + 0.5) * (W / w) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int64), 0, H - 1)
    x0 = np.clip(np.floor(xs).astype(np.int64), 0, W - 1)
    y1 = np.clip(y0 + 1, 0, H - 1)
    x1 = np.clip(x0 + 1, 0, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0).astype(np.float32)[:, None, None]
    wx = np.clip(xs - x0, 0.0, 1.0).astype(np.float32)[None, :, None]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    out = top * (1 - wy) + bot * wy
    if np.issubdtype(img.dtype, np.integer):
        out = np.rint(out)
    return out.astype(img.dtype)


def pad_to_bucket(img: np.ndarray, bucket: Tuple[int, int]):
    """Zero-pad an HWC image to the bucket; returns (padded, pad_mask) with
    pad_mask True on padding. An image larger than the bucket is downscaled
    to fit (never cropped), keeping its aspect ratio."""
    H, W = bucket
    h, w = img.shape[:2]
    if h > H or w > W:
        scale = min(H / h, W / w)
        nh, nw = max(1, int(h * scale)), max(1, int(w * scale))
        img = _resize_bilinear(img, nh, nw)
        h, w = img.shape[:2]
    out = np.zeros((H, W, img.shape[2]), dtype=img.dtype)
    out[:h, :w] = img
    mask = np.ones((H, W), dtype=bool)
    mask[:h, :w] = False
    return out, mask


def pack_space_to_depth(images: np.ndarray) -> np.ndarray:
    """(B, H, W, C) -> (B, H/2, W/2, 4C): each 2x2 pixel block goes into
    channels, out[..., (a*2+b)*C + c] = in[..., 2i+a, 2j+b, c]. The stem
    then runs as the equivalent 4x4/s1 convolution (models/resnet.py)."""
    B, H, W, C = images.shape
    if H % 2 or W % 2:
        raise ValueError(f"space-to-depth needs even sizes, got {(H, W)}")
    out = images.reshape(B, H // 2, 2, W // 2, 2, C)
    return np.ascontiguousarray(out.transpose(0, 1, 3, 2, 4, 5)).reshape(
        B, H // 2, W // 2, 4 * C
    )
