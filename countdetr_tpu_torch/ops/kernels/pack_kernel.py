"""Serving's batch pack: a hand-written CUDA kernel and its plain version.

``pack_images`` is what ``serve.py::Predictor`` calls once a predict call,
after the call's one host-to-device copy. Its input is the requests' raw
uint8 HWC RGB images staged back to back in one flat buffer
(``serve.py::stage_requests``) and a table of each request's (byte offset
into that buffer, h, w), h and w at most the bucket's. Its output is what
the model takes, equal bit for bit to the host pack of ``pack_requests``
(``data/batching.py``: ``pad_to_bucket``, then ``pack_space_to_depth``):
  images (B, H/2, W/2, 12) uint8, zero on padding, channel (a*2+b)*3 + c
      of block (i, j) holding pixel (2i+a, 2j+b)'s channel c;
  pad_mask (B, H, W) bool, True on padding.

On a CUDA tensor it launches the kernel in ``csrc/pack.cu`` (no TPU
counterpart: the JAX package packs on the host); on a CPU tensor it runs
``pack_images_plain``. There is no fallback between the two: a CUDA call
that the kernel cannot take raises. Each launch counts ``launch.pack``
(``utils/trace.py``); the launch lies in the caller's ``serve.h2d`` span.
The table's entries are the caller's to get right: the kernel reads each
request's h x w x 3 bytes at its offset without a bounds check.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from countdetr_tpu_torch.ops.kernels import _build
from countdetr_tpu_torch.utils import trace


def pack_images_plain(staged: torch.Tensor, table: torch.Tensor, bucket: Tuple[int, int]):
    """Plain PyTorch pack: each image padded into a zeroed bucket, the
    masks set, the batch space-to-depth packed."""
    H, W = bucket
    B = table.shape[0]
    images = torch.zeros((B, H, W, 3), dtype=torch.uint8, device=staged.device)
    mask = torch.ones((B, H, W), dtype=torch.bool, device=staged.device)
    for b, (off, h, w) in enumerate(table.tolist()):
        images[b, :h, :w] = staged[off:off + h * w * 3].view(h, w, 3)
        mask[b, :h, :w] = False
    packed = images.view(B, H // 2, 2, W // 2, 2, 3).permute(0, 1, 3, 2, 4, 5)
    return packed.reshape(B, H // 2, W // 2, 12), mask


def _lib() -> ctypes.CDLL:
    lib = _build.load("pack")
    if lib.pack_forward.argtypes is None:
        lib.pack_forward.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.pack_forward.restype = ctypes.c_int
    return lib


def _check(staged, table, bucket):
    if table.device != staged.device:
        raise ValueError(f"pack: table is on {table.device}, staged on {staged.device}")
    if staged.dtype != torch.uint8 or staged.dim() != 1 or not staged.is_contiguous():
        raise ValueError(f"pack: staged must be a contiguous 1-D uint8 tensor, got "
                         f"{staged.dtype} {tuple(staged.shape)}")
    if table.dtype != torch.int64 or table.dim() != 2 or table.shape[1] != 3 \
            or table.shape[0] < 1 or not table.is_contiguous():
        raise ValueError(f"pack: table must be a contiguous (B, 3) int64 tensor with B >= 1, "
                         f"got {table.dtype} {tuple(table.shape)}")
    H, W = bucket
    if H <= 0 or W <= 0 or H % 2 or W % 2:
        raise ValueError(f"pack: the bucket must have even positive sizes, got {(H, W)}")


def pack_images(staged: torch.Tensor, table: torch.Tensor, bucket: Tuple[int, int]):
    """(images (B, H/2, W/2, 12) uint8, pad_mask (B, H, W) bool) of the
    staged requests: the CUDA kernel for CUDA tensors, the plain version
    for CPU tensors."""
    if staged.device.type == "cpu":
        return pack_images_plain(staged, table, bucket)
    if staged.device.type != "cuda":
        raise ValueError(f"pack: no kernel for device {staged.device}")
    _check(staged, table, bucket)
    H, W = bucket
    B = table.shape[0]
    images = torch.empty((B, H // 2, W // 2, 12), dtype=torch.uint8, device=staged.device)
    mask = torch.empty((B, H, W), dtype=torch.bool, device=staged.device)
    stream = torch.cuda.current_stream(staged.device).cuda_stream
    err = _lib().pack_forward(staged.data_ptr(), table.data_ptr(), images.data_ptr(),
                              mask.data_ptr(), B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"pack kernel launch failed: CUDA error {err}")
    trace.count("launch.pack")
    return images, mask
