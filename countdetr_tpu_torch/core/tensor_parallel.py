"""Tensor parallelism over the "model" axis of a (data, model) mesh
(countdetr_tpu/core/mesh.py:103-143, ``tp_param_spec`` and
``shard_params_tp``).

The JAX package annotates each parameter with a PartitionSpec and lets
XLA's partitioner insert the collectives. The port has no partitioner: the
three sharded blocks of models/transformer.py (``RCDAAttention``,
``MHAttention``, ``FFN``) run on their local widths and call the two
operators of the Megatron recipe themselves:
  * ``copy_to_model`` (f): the identity forward, an all-reduce over the
    model group backward; where a replicated input enters a sharded block,
    so that the replicated parameters upstream get the whole gradient;
  * ``reduce_from_model`` (g): an all-reduce forward, the identity
    backward; after ``out_proj`` and ``linear2``, whose biases are then
    added once. (A differentiable all-reduce whose backward sums the
    cotangents, ``GlobalSum.with_grad``, would multiply the gradient by M
    here: after g every model rank holds the same output and the same
    cotangent.)

Which tensors are sharded, and along which dimension, is JAX's rule
(``tp_param_spec``): the rows of ``in_proj_weight`` and ``in_proj_bias``,
the columns of ``out_proj.weight``, the rows of ``linear1``'s weight and
its bias, the columns of ``linear2``'s weight; everything else is
replicated, ``out_proj.bias`` and ``linear2.bias`` among them. The order
within the dimension is the port's own: by head, where JAX cuts contiguous
row blocks. Model rank m keeps heads [m n/M, (m+1) n/M) of each packed role
(q_row, q_col, k_row, k_col, v of RCDA's (5E, E); q, k, v of MHA's (3E,
E)), the matching columns of ``out_proj.weight``, and hidden units [m F/M,
(m+1) F/M) of the FFN. So each rank runs n/M whole heads through the
attention kernels, at the head dim of one process, and the function equals
one process's.

gloo's all-reduce (a ring: each chunk is reduced on one rank, then copied
to every rank) gives every rank the same bytes, so the activations after g,
the heads' outputs and the matcher's assignments are bit-equal across a
model group. The replicated parameters' gradients are equal in exact
arithmetic but not bit for bit on the card: cuDNN's backward convolutions
sum with atomics in an order that changes from run to run, and chip_smoke's
``tp`` phase saw the backbone's copies drift apart from the second step.
So the Trainer averages them over the model group in one flat all-reduce
(``average_replicated_grads``) before the clip, and every rank then takes
the same update. tests/test_torch_tp.py holds the all-reduce's bytes and
the replicated parameters bit-equal across each model group.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn


def tp_param_spec(name: str, tensor: torch.Tensor, axis: str = "model") -> Tuple:
    """The PartitionSpec of a parameter of the port (its state-dict name,
    the reference torch model's), as a tuple: (axis, None) for rows,
    (None, axis) for columns, (axis,) for a bias, () replicated. The
    counterpart of JAX's ``tp_param_spec`` on the same parameter."""
    parts = name.split(".")
    leaf, mod = parts[-1], parts[-2] if len(parts) >= 2 else ""
    nd = tensor.dim()
    if leaf == "in_proj_weight" and nd == 2:
        return (axis, None)
    if leaf == "in_proj_bias":
        return (axis,)
    if mod == "out_proj" and leaf == "weight" and nd == 2:
        return (None, axis)
    if mod == "linear1" and leaf == "weight" and nd == 2:
        return (axis, None)
    if mod == "linear1" and leaf == "bias":
        return (axis,)
    if mod == "linear2" and leaf == "weight" and nd == 2:
        return (None, axis)
    return ()


def tp_layout(state: Dict[str, torch.Tensor], local_count: int = 1
              ) -> Dict[str, Tuple[int, int]]:
    """{name: (dim, roles)} of the sharded tensors of a state dict: the
    sharded dimension, and how many packed roles it holds (5 for RCDA's
    in_proj, 3 for MHA's, else 1), each cut by head. ``local_count``: M
    when ``state`` holds one model rank's shards, 1 for full tensors."""
    out = {}
    for name, t in state.items():
        spec = tp_param_spec(name, t)
        if not spec:
            continue
        roles = 1
        if name.endswith(("in_proj_weight", "in_proj_bias")):
            w = state[name[:name.rfind(".") + 1] + "in_proj_weight"]
            roles = w.shape[0] * local_count // w.shape[1]
        out[name] = (spec.index("model"), roles)
    return out


def shard_tensor(full: torch.Tensor, dim: int, roles: int, index: int, count: int
                 ) -> torch.Tensor:
    """Model rank ``index``'s block of each of the ``roles`` packed along
    ``dim``, a new contiguous tensor."""
    x = full.unflatten(dim, (roles, count, -1)).select(dim + 1, index)
    return x.flatten(dim, dim + 1).contiguous().clone()


def assemble(parts: Sequence[torch.Tensor], dim: int, roles: int) -> torch.Tensor:
    """The full tensor from every model rank's shard (``shard_tensor``'s
    inverse), in rank order."""
    blocks = [p.unflatten(dim, (roles, -1)) for p in parts]
    return torch.stack(blocks, dim + 1).flatten(dim, dim + 2)


@dataclasses.dataclass(frozen=True)
class ModelShard:
    """A sharded block's place in its model group: rank ``index`` of
    ``count``; ``group`` the model group's process group (None in one
    process holding one rank's shard, where only ``partial`` runs)."""

    index: int
    count: int
    group: object = None

    def local(self, n: int, what: str) -> int:
        if n % self.count:
            raise ValueError(f"tensor parallelism: {what} {n} is not a multiple of the "
                             f"model axis {self.count}")
        return n // self.count


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """f: ``x`` itself forward; its gradient summed over the model group."""
    return _CopyToModel.apply(x, shard.group)


def copy_each_to_model(tensors: Sequence[Optional[torch.Tensor]], shard: ModelShard
                       ) -> List[Optional[torch.Tensor]]:
    """``copy_to_model`` of each tensor, once a distinct tensor (a block
    that reads one input twice all-reduces its gradient once)."""
    seen: Dict[int, torch.Tensor] = {}
    out = []
    for t in tensors:
        if t is not None and id(t) not in seen:
            seen[id(t)] = copy_to_model(t, shard)
        out.append(None if t is None else seen[id(t)])
    return out


def reduce_from_model(x: torch.Tensor, shard: ModelShard) -> torch.Tensor:
    """g: ``x`` summed over the model group forward; the gradient passes."""
    return _ReduceFromModel.apply(x, shard.group)


def average_replicated_grads(params: Sequence[nn.Parameter], mesh) -> None:
    """The gradients of the replicated parameters among ``params`` (no
    ``tp_dim``) replaced by their mean over ``mesh``'s model group, in one
    flat all-reduce: every rank of the group then holds the same bytes."""
    import torch.distributed as dist

    grads = [p.grad for p in params if p.grad is not None and getattr(p, "tp_dim", None) is None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.model_group)
    flat /= mesh.model_count()
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def shard_model_(model: nn.Module, index: int, count: int, group=None
                 ) -> Dict[str, Tuple[int, int]]:
    """Turn a full model into model rank ``index``'s shard of ``count``, in
    place: each sharded parameter becomes a new Parameter holding its block
    (``requires_grad`` kept, ``tp_dim`` set to its sharded dimension), and
    each sharded block (a module with a ``tp`` attribute) gets its
    ``ModelShard``. Returns the layout (``tp_layout`` of the full state).
    ValueError where a head count or FFN width is not a multiple of
    ``count``."""
    shard = ModelShard(index, count, group)
    for name, m in model.named_modules():
        if not hasattr(m, "tp"):
            continue
        if hasattr(m, "num_heads"):
            shard.local(m.num_heads, f"{name}: nheads")
        if hasattr(m, "linear1"):
            shard.local(m.linear1.out_features, f"{name}: dim_feedforward")
    params = dict(model.named_parameters())
    layout = tp_layout(params)
    with torch.no_grad():
        for name, (dim, roles) in layout.items():
            p = params[name]
            owner, _, leaf = name.rpartition(".")
            local = nn.Parameter(shard_tensor(p.detach(), dim, roles, index, count),
                                 requires_grad=p.requires_grad)
            local.tp_dim = dim
            setattr(model.get_submodule(owner), leaf, local)
    for m in model.modules():
        if hasattr(m, "tp"):
            m.tp = shard
    return layout


def shard_params_tp(model: nn.Module, mesh) -> Dict[str, Tuple[int, int]]:
    """``shard_model_`` for this process's place on ``mesh``
    (core/mesh.py::Mesh): the model's local shard, in place."""
    return shard_model_(model, mesh.model_index(), mesh.model_count(), mesh.model_group)


def shard_state(state: Dict[str, torch.Tensor], index: int, count: int
                ) -> Dict[str, torch.Tensor]:
    """A full state dict cut to model rank ``index``'s shard (the other
    entries as they are)."""
    layout = tp_layout(state)
    return {k: shard_tensor(v, *layout[k], index, count) if k in layout else v
            for k, v in state.items()}


def gather_tensor(local: torch.Tensor, dim: int, roles: int, mesh) -> torch.Tensor:
    """The full tensor of a shard, all-gathered over ``mesh``'s model group."""
    import torch.distributed as dist

    local = local.detach().contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.model_count())]
    dist.all_gather(parts, local, group=mesh.model_group)
    return assemble(parts, dim, roles)


def gather_params_tp(state: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """A model rank's state dict with every shard replaced by the full
    tensor (a collective of the model group: each of its ranks calls it)."""
    layout = tp_layout(state, mesh.model_count())
    return {k: gather_tensor(v, *layout[k], mesh) if k in layout else v
            for k, v in state.items()}
