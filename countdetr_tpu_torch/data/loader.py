"""Sample loading in worker processes for the Batcher
(countdetr_tpu/data/loader.py).

One Python thread decodes and resizes JPEGs at a few dozen images a
second, below what the card trains at, so ``Batcher(..., num_workers=N)``
evaluates ``dataset[i]`` in a pool of N spawned processes:
  * the pool persists across epochs (spawn start-up, which imports the
    dataset's module and with it torch, is paid once);
  * the Batcher's schedule names every index ahead of time, so an ordered
    stream keeps at most ``window`` samples submitted but not yet consumed
    (``Pool.imap`` would buffer up to a whole epoch of decoded images when
    the card is the slower side);
  * the workers are plain numpy/PIL processes: they are spawned with no
    CUDA device visible, so none can initialise or touch the card, and
    without re-running the parent's ``__main__`` (spawn's default), whose
    imports (torch, for a training script) would cost each worker more
    than its share of an epoch's decoding. They import only what the
    pickled dataset names, so nothing of it may live in ``__main__``.
``num_workers=0`` keeps the serial path in the calling process; both give
the same batches.
"""

from __future__ import annotations

import os
import pickle
import sys
from collections import deque
from typing import List, Optional, Tuple

# the dataset of each worker process, set by _init_worker
_WORKER_DS = None


def _init_worker(dataset):
    global _WORKER_DS
    _WORKER_DS = dataset


def _load_one(idx: int):
    return _WORKER_DS[idx]


class SampleLoader:
    """A persistent spawn pool evaluating dataset[i]; the dataset is
    pickled once, into each worker's initializer."""

    def __init__(self, dataset, num_workers: int):
        import multiprocessing as mp

        self.num_workers = num_workers
        if b"__main__" in pickle.dumps(dataset):
            # a spawned worker unpickles the dataset by importing the modules
            # it names; __main__ is not imported there, and the failure
            # would be a silent respawn loop
            raise ValueError(
                f"num_workers > 0 needs a dataset ({type(dataset).__name__}) whose classes "
                f"and functions live in importable modules, not __main__; move them into "
                f"a module or use num_workers=0")
        # spawn re-runs the parent's __main__ in each worker, found by its
        # __spec__ (python -m) or its __file__; both are hidden while the
        # pool starts
        main_mod = sys.modules["__main__"]
        spec = getattr(main_mod, "__spec__", None)
        main_file = main_mod.__dict__.pop("__file__", None)
        main_mod.__spec__ = None
        saved = os.environ.get("CUDA_VISIBLE_DEVICES")
        os.environ["CUDA_VISIBLE_DEVICES"] = ""  # inherited by the workers only
        try:
            self._pool = mp.get_context("spawn").Pool(
                num_workers, initializer=_init_worker, initargs=(dataset,))
        finally:
            main_mod.__spec__ = spec
            if main_file is not None:
                main_mod.__file__ = main_file
            if saved is None:
                del os.environ["CUDA_VISIBLE_DEVICES"]
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved

    def iter_samples(self, indices: List[int], window: Optional[int] = None):
        """dataset[i] for i in indices, in order, with at most ``window``
        tasks in flight (default 4 per worker, at least 8)."""
        if window is None:
            window = max(8, 4 * self.num_workers)
        pending = deque()
        it = iter(indices)
        for i in it:
            pending.append(self._pool.apply_async(_load_one, (i,)))
            if len(pending) >= window:
                break
        for i in it:
            out = pending.popleft().get()
            pending.append(self._pool.apply_async(_load_one, (i,)))
            yield out
        while pending:
            yield pending.popleft().get()

    def close(self):
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def iter_batches_parallel(batcher, plan: List[Tuple]):
    """Assembled batches of a Batcher epoch plan [(key, indices, n_real)],
    the real samples loaded by the Batcher's SampleLoader while this
    process assembles."""
    flat: List[int] = []
    for _, idxs, n_real in plan:
        flat.extend(idxs[:n_real])
    it = batcher._loader.iter_samples(flat)
    for (bucket, pt_cap, box_cap), _, n_real in plan:
        samples = [next(it) for _ in range(n_real)]
        yield batcher._assemble(samples, bucket, pt_cap, box_cap, n_real)
