"""ctypes binding of the repository's native COCO greedy matcher,
``native/cocoeval.cpp`` (countdetr_tpu/eval/native_match.py; the reference
evaluates through detectron2's C++ COCOeval_opt, eval_all.py:18,516).

The first call compiles the source with ``c++`` into the port's
``_build/`` directory (a name hashed from the source, written atomically;
``native/`` is never written). When no compiler or source is there,
``match_image`` returns None and the caller uses the numpy matcher
(eval/coco_eval.py::_match_image_py), which gives the same matches. This is
a host matcher, not a card kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "cocoeval.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libcocoeval-{h}.so"


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if not SOURCE.is_file():
        return None
    so = library_path()
    if not so.exists():
        cxx = shutil.which("c++")
        if cxx is None:
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        try:
            subprocess.run([cxx, "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(tmp),
                            str(SOURCE)], check=True, capture_output=True, timeout=120)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            tmp.unlink(missing_ok=True)
            return None
    lib = ctypes.CDLL(str(so))
    lib.coco_match_image_v2.restype = None
    lib.coco_match_image_v2.argtypes = [
        ctypes.POINTER(ctypes.c_double),  # iou (n_det, n_gt)
        ctypes.c_int,  # n_det
        ctypes.c_int,  # n_gt
        ctypes.POINTER(ctypes.c_uint8),  # gt_ignore
        ctypes.POINTER(ctypes.c_uint8),  # gt_crowd
        ctypes.POINTER(ctypes.c_double),  # iou_thrs
        ctypes.c_int,  # n_thrs
        ctypes.POINTER(ctypes.c_int64),  # out: matched gt or -1
        ctypes.POINTER(ctypes.c_uint8),  # out: ignored
    ]
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def match_image(iou: np.ndarray, gt_ignore: np.ndarray, iou_thrs: np.ndarray,
                gt_crowd: Optional[np.ndarray] = None
                ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Greedy matching of one image: iou (N, M) with the dets in score
    order, gt_ignore (M,), iou_thrs (T,), gt_crowd (M,) (crowd gts may be
    matched many times). Returns (matched gt index or -1 (T, N) int64,
    matched an ignored gt (T, N) bool), or None without the library."""
    lib = _load()
    if lib is None:
        return None
    N, M = iou.shape
    T = len(iou_thrs)
    iou_c = np.ascontiguousarray(iou, dtype=np.float64)
    gig_c = np.ascontiguousarray(gt_ignore, dtype=np.uint8)
    gcr_c = np.ascontiguousarray(np.zeros(M) if gt_crowd is None else gt_crowd, dtype=np.uint8)
    thr_c = np.ascontiguousarray(iou_thrs, dtype=np.float64)
    out_m = np.empty((T, N), dtype=np.int64)
    out_ig = np.empty((T, N), dtype=np.uint8)
    lib.coco_match_image_v2(
        iou_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), N, M,
        gig_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        gcr_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        thr_c.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), T,
        out_m.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        out_ig.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out_m, out_ig.astype(bool)
