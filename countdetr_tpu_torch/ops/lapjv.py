"""ctypes binding of the repository's exact LAP solver, ``native/lapjv.cpp``
(countdetr_tpu/ops/lapjv.py): a host oracle for the on-card auction
matcher beside ``matching.scipy_match``, and offline tooling. Not on the
card's path.

The first call compiles the source with ``c++`` into the port's
``_build/`` directory (a name hashed from the source, written atomically;
``native/`` is never written). Without a compiler or the source,
``available()`` is False and ``solve``/``solve_batch`` fall back to scipy,
which gives assignments of the same cost.
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

SOURCE = Path(__file__).resolve().parents[2] / "native" / "lapjv.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"liblapjv-{h}.so"


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
    lib.lapjv_solve.restype = ctypes.c_float
    lib.lapjv_solve.argtypes = [
        ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.lapjv_solve_batch.restype = None
    lib.lapjv_solve_batch.argtypes = [
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def solve(cost: np.ndarray) -> Tuple[np.ndarray, float]:
    """Min-cost assignment of n rows to m >= n columns: (the column of each
    row (n,) int32, the total cost)."""
    lib = _load()
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    n, m = cost.shape
    if n > m:
        raise ValueError(f"solve needs rows <= columns, got {cost.shape}")
    out = np.zeros(n, dtype=np.int32)
    if lib is None:
        from scipy.optimize import linear_sum_assignment

        r, c = linear_sum_assignment(cost)
        out[r] = c
        return out, float(cost[r, c].sum())
    total = lib.lapjv_solve(n, m, cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out, float(total)


def solve_batch(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The batched padded form of ``matching.batched_match``: cost (B, Q, T)
    and valid (B, T) -> tgt2query (B, T) int32 (0 on invalid targets)."""
    lib = _load()
    cost = np.ascontiguousarray(cost, dtype=np.float32)
    valid = np.ascontiguousarray(valid, dtype=np.uint8)
    B, Q, T = cost.shape
    if lib is None:
        from countdetr_tpu_torch.ops.matching import scipy_match

        return np.asarray(scipy_match(cost, valid.astype(bool))[0], np.int32)
    out = np.zeros((B, T), dtype=np.int32)
    lib.lapjv_solve_batch(B, Q, T, cost.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                          valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
