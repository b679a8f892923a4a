"""Process topology for the CLI (countdetr_tpu/core/mesh.py:91-210): what
the command line calls, for one process on one card.

The JAX package spans a device mesh and many hosts; the port runs one
process, so ``init_distributed`` only checks that no launcher asked for
more, the process queries answer for a single process, and
``gather_metrics`` is the identity. Data parallelism over
torch.distributed is queued in ROADMAP.md (Queue 1, long tail: "core/mesh.py,
ported to torch.distributed DDP").
"""

from __future__ import annotations

import os

DDP_ITEM = ('ROADMAP.md, Queue 1 item 6 (long tail): "core/mesh.py, ported to '
            'torch.distributed DDP"')


def init_distributed() -> bool:
    """A no-op for one process (returns False). A launcher's WORLD_SIZE
    above 1 raises SystemExit: the port has no multi-process training yet."""
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise SystemExit(f"WORLD_SIZE={world}: the port runs one process on one card; "
                         f"data parallelism is {DDP_ITEM}")
    return False


def process_index() -> int:
    return 0


def process_count() -> int:
    return 1


def is_main_process() -> bool:
    return process_index() == 0


def gather_metrics(metrics: dict, weight: float = 1.0) -> dict:
    """The weighted cross-process mean of scalar metrics; for one process
    the metrics as floats (``weight``, the process's real sample count,
    matters only across processes)."""
    return {k: float(v) for k, v in metrics.items()}
