"""Decoded-image caches for the dataset readers (countdetr_tpu/data/cache.py).

``load_image`` (data/fscd147.py) takes a dict-like ``decoded_cache`` of
image path -> (resized uint8 HWC array, (w, h)). ``decoded_cache_from_mode``
maps a reader's ``cache_mode`` onto one: "decoded" is a dict in each
process; "disk:<dir>" a ``DiskDecodedCache`` that every worker process and
every later run share. The resize is deterministic in (image bytes,
scale_factor), so a blob stays valid across runs.

Writes are crash- and race-safe: a blob goes to a unique temporary file and
is ``os.replace``d into place, so concurrent workers at worst decode an
image twice and readers only see complete files. A torn or corrupt blob
reads as a miss (``KeyError``), and the caller decodes and rewrites it.
"""

from __future__ import annotations

import hashlib
import os
import tempfile

import numpy as np


class DiskDecodedCache:
    """dict-like mapping image path -> (resized uint8 HWC array, (w, h)),
    one .npz file per image. The file name is the image's basename and a
    hash of its absolute path, so datasets sharing a directory never
    collide. One directory holds one resize (one ``scale_factor``)."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def _file(self, path: str) -> str:
        h = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
        base = os.path.splitext(os.path.basename(path))[0]
        return os.path.join(self.dir, f"{base}.{h}.npz")

    def __contains__(self, path: str) -> bool:
        return os.path.exists(self._file(path))

    def __getitem__(self, path: str):
        try:
            with np.load(self._file(path)) as z:
                arr8 = z["arr"]
                w, h = (int(x) for x in z["size"])
        except (OSError, KeyError, ValueError) as e:
            raise KeyError(path) from e  # a torn blob is a miss
        return arr8, (w, h)

    def __setitem__(self, path: str, value):
        arr8, (w, h) = value
        fd, tmp = tempfile.mkstemp(dir=self.dir, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as out:
                np.savez(out, arr=np.asarray(arr8, np.uint8), size=np.array([w, h], np.int64))
            os.replace(tmp, self._file(path))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __len__(self) -> int:
        return sum(1 for n in os.listdir(self.dir) if n.endswith(".npz"))


def decoded_cache_from_mode(cache_mode):
    """'decoded' -> a dict in this process; 'disk:<dir>' -> a shared
    DiskDecodedCache; anything else -> None (the byte cache, or none)."""
    if cache_mode == "decoded":
        return {}
    if isinstance(cache_mode, str) and cache_mode.startswith("disk:"):
        return DiskDecodedCache(cache_mode[len("disk:"):])
    return None
