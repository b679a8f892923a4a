"""Process topology and data parallelism over torch.distributed
(countdetr_tpu/core/mesh.py:91, 146-212; reference util/misc.py:399-436,
main.py:206-208).

A world of W processes, one per card, as ``torchrun`` starts them (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT in the environment),
trains what one process trains on the same global batches:
  * the Batcher's global schedule gives each rank its slice of every
    global batch (data/batching.py);
  * every batch-wide normaliser of the losses is summed over the ranks
    (``GlobalSum``, ops/losses.py), so each rank's loss is its share of the
    global batch's loss: the JAX package's semantics, where the losses are
    computed on the global arrays, and not the reference's per-rank means;
  * the Trainer wraps its loss in DistributedDataParallel (``wrap_ddp``),
    which averages the gradients;
  * metrics are averaged over the ranks, weighted by each rank's real
    samples (``gather_metrics``).

Backend: NCCL when every process of a host has a card of its own, gloo on
the CPU and when processes share a card (NCCL refuses two ranks on one
device). The process's card is ``cuda:LOCAL_RANK`` (modulo the cards
there are). Only a "data" axis exists: tensor parallelism (the JAX
package's tp_param_spec / shard_params_tp) is not ported (``TP_ITEM``).
"""

from __future__ import annotations

import datetime
import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch

TP_ITEM = 'ROADMAP.md, Queue 1 item 6: "Tensor parallelism, the last module still to port"'


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def process_index() -> int:
    d = _dist()
    return d.get_rank() if d else 0


def process_count() -> int:
    d = _dist()
    return d.get_world_size() if d else 1


def is_main_process() -> bool:
    return process_index() == 0


def local_rank() -> int:
    """LOCAL_RANK, else the rank: the process's index among its host's."""
    if os.environ.get("LOCAL_RANK"):
        return int(os.environ["LOCAL_RANK"])
    return process_index() if _dist() else int(os.environ.get("RANK", "0") or 0)


def local_world_size() -> int:
    """LOCAL_WORLD_SIZE, else the world size: the processes on this host."""
    for key in ("LOCAL_WORLD_SIZE", "WORLD_SIZE"):
        if os.environ.get(key):
            return int(os.environ[key])
    return process_count()


def select_backend(device, local_world: Optional[int] = None) -> str:
    """'nccl' when ``device`` is CUDA and the host has a card for each of
    its ``local_world`` processes, else 'gloo'."""
    if torch.device(device).type != "cuda":
        return "gloo"
    n = local_world if local_world is not None else local_world_size()
    return "nccl" if torch.cuda.device_count() >= n else "gloo"


def local_device(device, rank: Optional[int] = None) -> torch.device:
    """This process's device: ``device`` itself in one process or when it
    names an index; for a bare "cuda" in a world of several, the card
    ``local_rank()`` (or ``rank``) modulo the cards there are, so that
    processes share cards when there are fewer cards than processes."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None or not torch.cuda.is_available():
        return dev
    if rank is None:
        if process_count() == 1:
            return dev
        rank = local_rank()
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_distributed(device="cuda", init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     timeout_s: Optional[float] = None) -> bool:
    """Join the process group. Without arguments it reads torchrun's
    environment and returns False for one process (WORLD_SIZE unset or 1);
    with ``init_method`` (a ``file://`` store or ``tcp://`` address) it
    joins as ``rank`` of ``world_size``, any size. The backend follows
    ``select_backend``; a CUDA process is pinned to its card first.
    Returns True once the group exists."""
    import torch.distributed as dist

    if dist.is_initialized():
        return True
    if init_method is None:
        world = int(os.environ.get("WORLD_SIZE", "1") or 1)
        if world <= 1:
            return False
        missing = [k for k in ("RANK", "MASTER_ADDR", "MASTER_PORT") if not os.environ.get(k)]
        if missing:
            raise SystemExit(f"WORLD_SIZE={world} but {', '.join(missing)} not set: start the "
                             f"processes with torchrun --nproc_per_node=N")
        rank, init_method = int(os.environ["RANK"]), "env://"
        local_world, card = local_world_size(), local_rank()
    else:
        world = int(world_size)
        local_world, card = int(os.environ.get("LOCAL_WORLD_SIZE") or world), rank
    backend = select_backend(device, local_world)
    dev = local_device(device, card)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank, **kw)
    return True


def shutdown():
    """Leave the process group, if there is one."""
    d = _dist()
    if d:
        d.destroy_process_group()


def barrier():
    """Wait for every rank (nothing in one process)."""
    d = _dist()
    if d is None:
        return
    if d.get_backend() == "nccl":
        d.barrier(device_ids=[torch.cuda.current_device()])
    else:
        d.barrier()


def check_mesh(shape: Sequence[int], axes: Sequence[str]):
    """SystemExit unless the mesh is the one data axis over the processes:
    axes ("data",), shape (-1,) or (process_count(),). A "model" axis is
    tensor parallelism, not ported."""
    axes, shape = tuple(axes), tuple(shape)
    if "model" in axes:
        raise SystemExit(f"mesh_axes {axes}: tensor parallelism (a 'model' axis) is not in the "
                         f"port; it is {TP_ITEM}")
    if axes != ("data",):
        raise SystemExit(f"mesh_axes {axes}: the port has one axis, 'data', over the processes")
    if len(shape) != 1 or shape[0] not in (-1, process_count()):
        raise SystemExit(f"mesh_shape {shape}: the 'data' axis spans the {process_count()} "
                         f"process(es): (-1,) or ({process_count()},)")


def wrap_ddp(module: torch.nn.Module, device) -> torch.nn.Module:
    """``module`` in DistributedDataParallel on ``device``. Buffers are not
    broadcast each step (the model's are frozen and equal on every rank;
    DDP's construction broadcasts rank 0's parameters and buffers once).
    ``find_unused_parameters``: parameters the loss does not reach (the
    cls head in stage 1, the mask head the losses never read) are marked
    ready after each forward, found by a traversal from the module's
    outputs; so the module returns the loss and its parts, nothing the
    loss does not read."""
    from torch.nn.parallel import DistributedDataParallel

    dev = torch.device(device)
    ids = None
    if dev.type == "cuda":
        ids = [dev.index if dev.index is not None else torch.cuda.current_device()]
    return DistributedDataParallel(module, device_ids=ids, broadcast_buffers=False,
                                   find_unused_parameters=True)


class GlobalSum:
    """Sums over every rank, for the losses' batch-wide normalisers
    (``__call__``, no gradient) and the matched-mean L1 of the variance
    loss (``with_grad``, a differentiable all-reduce whose backward sums
    the cotangents of every rank). ``world`` is the number of ranks. It
    makes a process group of its own (with the default group's backend),
    which keeps these collectives apart from DDP's gradient buckets."""

    def __init__(self):
        import torch.distributed as dist

        self.group = dist.new_group(backend=dist.get_backend())
        self.world = dist.get_world_size(self.group)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        y = x.detach().clone()
        dist.all_reduce(y, group=self.group)
        return y

    def with_grad(self, x: torch.Tensor) -> torch.Tensor:
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(x, group=self.group)

    def sum_dict(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Each 0-d value summed over the ranks, in one all-reduce."""
        keys = sorted(values)
        total = self(torch.stack([values[k].detach().float() for k in keys]))
        return dict(zip(keys, total.unbind()))


def _weighted_reduce(all_vals: np.ndarray) -> np.ndarray:
    """Weighted per-column mean of an (n_hosts, n_metrics+1) matrix whose
    last column is each host's weight. Accumulates in f64 so large sample
    counts (1e5+ per host, many hosts) don't lose precision in the weighted
    sum, and zeroes out zero-weight rows so a NaN metric on an all-padding
    host (NaN * 0 = NaN) can't poison the mean. A NaN on a host with real
    samples still propagates, as it should."""
    all_vals = np.asarray(all_vals, np.float64)
    w = all_vals[:, -1:]
    vals = np.where(w > 0, all_vals[:, :-1], 0.0)
    total_w = max(float(w.sum()), 1e-9)
    return (vals * w).sum(axis=0) / total_w


def gather_metrics(metrics: dict, weight: float = 1.0) -> dict:
    """The weighted cross-process mean of scalar metrics; ``weight`` is the
    process's real (non-padding) sample count for them, so a rank whose
    slice of a tail batch is padding weighs less. The values go over the
    wire as float32 and are reduced in float64 (``_weighted_reduce``), as in
    the JAX package. One process: the metrics as floats."""
    if process_count() == 1:
        return {k: float(v) for k, v in metrics.items()}
    import torch.distributed as dist

    keys = sorted(metrics.keys())
    # NCCL takes tensors on the process's card
    dev = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
           else torch.device("cpu"))
    vec = torch.tensor([float(metrics[k]) for k in keys] + [max(weight, 0.0)],
                       dtype=torch.float32, device=dev)
    parts = [torch.empty_like(vec) for _ in range(process_count())]
    dist.all_gather(parts, vec)
    all_vals = torch.stack(parts).cpu().numpy()
    return dict(zip(keys, _weighted_reduce(all_vals).tolist()))
