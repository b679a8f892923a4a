"""Checkpoints of the port, and the importer of the reference's .pth files
(countdetr_tpu/train/checkpoints.py; reference main.py:217-238, 297-311).

A checkpoint is the directory contract of the JAX package, with one
``torch.save`` payload in place of Orbax's tree:
  {dir}/checkpoint_{step}/state.pt     the Trainer's state (below)
  {dir}/checkpoint_{step}.meta.json    {"step", extra such as "epoch",
                                        "config": the model and train configs}
  {dir}/latest.json                    {"step"} of the newest committed one
The payload holds the model's weights and buffers, the optimizer's state
(AdamW's moments and step counts), the LR scheduler's position, the
device-side ``bad_steps`` count and the optimizer step: tensors, numbers
and plain containers only, so ``torch.load(weights_only=True)`` reads it.
A checkpoint is committed when its meta file exists; ``latest.json``
moves only after that, so a crash mid-write resumes from the previous one.

    saver = AsyncSaver()
    saver.save(out_dir, epoch, trainer, {"epoch": epoch})  # returns at once
    ...
    saver.finalize()                                       # commit, publish
    step = latest_step(out_dir)
    meta = restore_checkpoint(out_dir, step, trainer)      # meta["epoch"]
    restore_weights(out_dir, step, model)                  # the weights alone

Under data parallelism rank 0 writes the payload, the meta and
latest.json, and every rank then waits at a barrier (``finalize`` commits
first), so no rank reads a directory the writer has not committed; the
weights are the same on every rank. Under tensor parallelism every rank
first takes ``trainer.state_dict()``, which gathers the full weights and
moments over each model group, and rank 0 writes those. Every rank
restores from the files, onto its own device (a tensor-parallel Trainer
cuts the full tensors to its shard). The payload holds the model's own
keys (no DDP prefix) and full tensors, so a checkpoint written on a mesh of
any shape loads in one process and the other way round.

``load_torch_checkpoint`` reads a reference .pth into the port's
state_dict; the port's module names are the reference's (weights.py).
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import tempfile
import threading
from typing import Dict, Optional

import torch

from countdetr_tpu_torch.core.mesh import barrier, is_main_process

PAYLOAD = "state.pt"


def config_to_dict(cfg) -> Dict:
    """A dataclass config as a plain JSON-able dict (the reference pickles
    its args into every checkpoint, main.py:302-311)."""
    return dataclasses.asdict(cfg)


def _host_copy(obj):
    """``obj`` with every tensor copied to host memory (a new tensor even
    when it is already there), containers rebuilt."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


def _write_payload(directory: str, step: int, payload: Dict):
    """The payload into ``checkpoint_{step}/``, written beside it and
    renamed into place (an older directory of that step is replaced)."""
    tmp = tempfile.mkdtemp(dir=directory, prefix=f".checkpoint_{step}.")
    try:
        torch.save(payload, os.path.join(tmp, PAYLOAD))
        final = os.path.join(directory, f"checkpoint_{step}")
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _write_meta(directory: str, step: int, extra: Optional[Dict], trainer,
                keep_last: int, keep_every: int):
    """Commit: the side-car meta, then latest.json, then retention."""
    meta = {"step": int(step), **(extra or {}),
            "config": {"model": config_to_dict(trainer.cfg),
                       "train": config_to_dict(trainer.train_cfg)}}
    with open(os.path.join(directory, f"checkpoint_{step}.meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(directory, "latest.json"), "w") as f:
        json.dump({"step": int(step)}, f)
    if keep_last > 0:
        t = trainer.train_cfg
        gc_checkpoints(directory, keep_last=keep_last, keep_every=keep_every,
                       lr_drop=t.lr_drop, drop_epochs=t.lr_drop_epochs)


def gc_checkpoints(directory: str, keep_last: int = 1, keep_every: int = 10,
                   lr_drop: Optional[int] = None, drop_epochs=None):
    """Retention as in the reference (one rolling checkpoint, permanent ones
    every 10th and at lr-drop epochs, main.py:297-311), with the step as the
    epoch: keep the ``keep_last`` newest committed checkpoints, the one
    latest.json names, every one with (step + 1) % keep_every == 0 and those
    at lr-drop epochs; never touch an uncommitted one (no meta file)."""
    steps = sorted(int(m.group(1)) for name in os.listdir(directory)
                   if (m := re.fullmatch(r"checkpoint_(\d+)", name))
                   and os.path.isdir(os.path.join(directory, name)))
    done = [s for s in steps
            if os.path.exists(os.path.join(directory, f"checkpoint_{s}.meta.json"))]
    keep = set(done[-max(keep_last, 1):])
    latest = latest_step(directory)
    if latest is not None:
        keep.add(latest)
    drops = set(drop_epochs or [])
    for s in done:
        if (keep_every and (s + 1) % keep_every == 0) or (lr_drop and (s + 1) % lr_drop == 0) \
                or (s + 1) in drops:
            keep.add(s)
    for s in done:
        if s in keep:
            continue
        shutil.rmtree(os.path.join(directory, f"checkpoint_{s}"), ignore_errors=True)
        try:
            os.remove(os.path.join(directory, f"checkpoint_{s}.meta.json"))
        except OSError:
            pass


def save_checkpoint(directory: str, step: int, trainer, extra: Optional[Dict] = None,
                    keep_last: int = 0, keep_every: int = 10):
    """Write and commit a checkpoint of ``trainer`` (blocks until done; on
    rank 0, the others wait). ``keep_last`` > 0 runs ``gc_checkpoints``
    after the commit."""
    try:
        state = trainer.state_dict()  # a collective under tensor parallelism
        if is_main_process():
            directory = os.path.abspath(directory)
            os.makedirs(directory, exist_ok=True)
            _write_payload(directory, step, _host_copy(state))
            _write_meta(directory, step, extra, trainer, keep_last, keep_every)
    finally:
        barrier()


class AsyncSaver:
    """Checkpoints written behind the training loop. ``save`` first commits
    the write in flight (an epoch of compute has usually hidden it), then
    copies the trainer's state to host memory, so training may go on
    updating it at once, and writes it on a background thread. ``finalize``
    waits for the write and commits it (the meta file, then latest.json);
    call it after the loop and before reading the directory. Under data
    parallelism rank 0 writes (every rank calls ``save``: under tensor
    parallelism the state is gathered first), and ``finalize`` ends at a
    barrier of every rank."""

    def __init__(self, keep_last: int = 0, keep_every: int = 10):
        self.keep_last = keep_last
        self.keep_every = keep_every
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = None  # (directory, step, extra, trainer)

    def save(self, directory: str, step: int, trainer, extra: Optional[Dict] = None):
        self.finalize()
        state = trainer.state_dict()  # a collective under tensor parallelism
        if not is_main_process():
            return
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        payload = _host_copy(state)

        def write():
            try:
                _write_payload(directory, step, payload)
            except BaseException as e:
                self._error = e

        self._pending = (directory, step, extra, trainer)
        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def finalize(self):
        """Block until the write in flight is on disk, then commit it, and
        wait for every rank. Idempotent; raises the write's error, if it
        failed."""
        try:
            if self._thread is not None:
                self._thread.join()
                self._thread = None
            if self._pending is not None:
                directory, step, extra, trainer = self._pending
                self._pending = None
                if self._error is not None:
                    err, self._error = self._error, None
                    raise RuntimeError(f"checkpoint {step} was not written") from err
                _write_meta(directory, step, extra, trainer, self.keep_last, self.keep_every)
        finally:
            barrier()


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "latest.json")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(json.load(f)["step"])


def _load_payload(directory: str, step: int) -> Dict:
    return torch.load(os.path.join(os.path.abspath(directory), f"checkpoint_{step}", PAYLOAD),
                      map_location="cpu", weights_only=True)


def _read_meta(directory: str, step: int) -> Dict:
    meta_path = os.path.join(os.path.abspath(directory), f"checkpoint_{step}.meta.json")
    if not os.path.exists(meta_path):
        return {}
    with open(meta_path) as f:
        return json.load(f)


def restore_weights(directory: str, step: int, model: torch.nn.Module) -> Dict:
    """Load only the weights and buffers of checkpoint ``step`` into
    ``model`` (strict), for the modes that run a model without training it;
    returns the meta with ``opt_step``."""
    payload = _load_payload(directory, step)
    model.load_state_dict(payload["model"])
    return {**_read_meta(directory, step), "opt_step": int(payload["step"])}


def restore_checkpoint(directory: str, step: int, trainer) -> Dict:
    """Load checkpoint ``step`` into ``trainer`` (weights, optimizer moments,
    scheduler position, ``bad_steps``) and return its meta with
    ``opt_step``, the optimizer step it was taken at."""
    payload = _load_payload(directory, step)
    trainer.load_state_dict(payload)
    return {**_read_meta(directory, step), "opt_step": int(payload["step"])}


# ---------------------------------------------------------------- reference .pth

BBOX_LAST_BIAS = "transformer.bbox_embed.0.layers.2.bias"
WH_BIAS = (0.0, 0.0, -2.0, -2.0)  # folded into that bias by the reference
# counters thop leaves in a profiled model; the reference ignores them too
# (main.py:231)
_IGNORED_SUFFIXES = ("total_params", "total_ops")
# the decoder heads are one module each, stored once per layer
_SHARED_HEAD = re.compile(r"transformer\.(cls_embed|bbox_embed|bbox_variance)\.([1-9]\d*)\.")


def _never_run(key: str, want) -> bool:
    """Whether ``key`` is of a module the reference keeps but never runs in
    the model whose state_dict keys are ``want``."""
    if key.startswith("input_proj."):  # stage 2 projects the aggregated map
        return any(n.startswith("aggr_input_proj.") for n in want)
    if key.startswith("transformer.adapt_pos1d."):  # the 1-D embeddings feed RCDA only
        return not any(n.startswith("transformer.adapt_pos1d.") for n in want)
    return False


def load_torch_checkpoint(path: str, model: torch.nn.Module,
                          skip_mismatched: bool = False) -> Dict[str, torch.Tensor]:
    """The state_dict for ``model`` from a reference .pth
    (``{"model": state_dict, ...}``): the backbone's Joiner prefix and
    DETRsegm's ``detr.`` dropped, the decoder heads' per-layer copies read
    from index 0, the folded wh bias taken out of the bbox head's last bias
    (the port adds it in the forward), stage 1's (1,) cls bias broadcast,
    ``modify_pattern`` read as ``pattern``, and the modules the reference
    keeps but never runs dropped: the stage-2 model's plain ``input_proj``
    and, under standard attention, ``transformer.adapt_pos1d``. The levels'
    ``input_proj.{lv}``, ``transformer.encoder_layers_level.*``,
    ``level_fc`` and ``level_embed`` and DETRsegm's ``bbox_attention`` and
    ``mask_head`` keep their names. Strict: an unknown or missing key raises
    KeyError, a shape mismatch ValueError unless ``skip_mismatched`` (then
    the model's own tensor is kept). The file pickles the reference's
    argparse Namespace, so it is read with ``weights_only=False``: load
    only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("model", obj) if isinstance(obj, dict) else obj
    want = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    unknown = []
    for key, v in sd.items():
        k = key[len("detr."):] if key.startswith("detr.") else key
        if key.endswith(_IGNORED_SUFFIXES) or _SHARED_HEAD.match(k):
            continue
        k = k.replace("backbone.0.body.", "backbone.body.", 1)
        k = k.replace("transformer.modify_pattern.", "transformer.pattern.", 1)
        v = v.detach().to(torch.float32) if v.is_floating_point() else v.detach()
        if k == BBOX_LAST_BIAS:
            v = v - torch.tensor(WH_BIAS, dtype=v.dtype)
        if k.startswith("transformer.cls_embed.0.bias") and k in want \
                and v.shape != want[k].shape and v.numel() == 1:
            v = v.expand(want[k].shape).clone()  # the stage-1 (1,)-bias quirk
        if k not in want:
            if not _never_run(k, want):
                unknown.append(key)
            continue
        if v.shape != want[k].shape:
            if not skip_mismatched:
                raise ValueError(f"{key}: shape {tuple(v.shape)}, the model's "
                                 f"{tuple(want[k].shape)}")
            print(f"skipping mismatched import {key}: {tuple(v.shape)} != "
                  f"{tuple(want[k].shape)} (keeping the model's)")
            v = want[k]
        out[k] = v.to(want[k].dtype)
    if unknown:
        raise KeyError(f"reference keys the port does not know: {unknown[:10]}"
                       f" (+{max(len(unknown) - 10, 0)} more)")
    missing = sorted(set(want) - set(out))
    if missing:
        raise KeyError(f"model keys the checkpoint lacks: {missing[:10]}"
                       f" (+{max(len(missing) - 10, 0)} more)")
    return out
