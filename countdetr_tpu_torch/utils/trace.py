"""The port's spans and counters: one module, torch and the standard library.

``span(name)`` marks a stretch of host work as a ``record_function`` range.
Whatever torch.profiler session is running collects it (the benchmark's
profiled sub-window, the CLI's ``--profile``) as a ``user_annotation``
event on the clock of the CUDA kernels, so a reader can put each kernel's
launch (``args.correlation``) and each idle gap of the device down to the
innermost span open on the launching thread. With no profiler running, a
span costs one boolean check: it returns a shared null context and builds
neither a ``RecordFunction`` nor its name.

A name is a fixed prefix, optionally a space and a shape, formatted only
while tracing:

    with span("serve.pack"):
        ...
    with span("core.rcda", lambda: f"B={B} L={L} {H}x{W} float32"):
        ...

Readers match the prefix up to the first space. Spans nest on the calling
thread: every span of one ``Predictor.predict`` call lies inside its
``serve.predict`` span.

    serve.predict   Predictor.predict, the whole call
    serve.pack      the requests staged: each raw image copied into the
                    predictor's pinned buffer, with the boxes and a table of
                    offsets and sizes (``serve.py::stage_requests``)
    serve.h2d       the staged bytes copied to the device in one copy and
                    the pack kernel launched (``ops/kernels/pack_kernel.py``);
                    in ``Predictor.forward``, the copy of host arrays
    serve.model     the model's forward issued (the host's time; the device
                    runs behind it)
    serve.d2h       the logits and boxes read back (waits for the device)
    serve.count     the sigmoid and adaptive_threshold_counting
    serve.topk      a stage-1 call's detections: topk_postprocess on the
                    device and its results read back (waits for the device)
    model.backbone  the input normalised and the ResNet body issued
    core.rcda, core.rcda_rank1, core.mha, core.auction
                    one attention core or auction call (its dispatch: the
                    kernel on a card, the plain version on the CPU)

``count(name, n)`` adds to a counter on the host; it never touches the
device. The counters:

    serve.px_real    pixels of the request images after any downscale
    serve.px_bucket  pixels of the buckets they are padded into
    serve.pack_resized  requests larger than the bucket, downscaled on the
                     host before they are staged
    launch.rcda, launch.rcda_rank1, launch.mha, launch.auction, launch.pack
                     kernel launches by variant, whichever source ran
                     (``launch_counts``); ``pack`` is one a predict call on
                     a card
    launch.rcda_cuda_cores  float32 RCDA launches (counted in launch.rcda or
                     launch.rcda_rank1 too) that ``f32_route`` sends to
                     rcda.cu's CUDA-core kernel rather than the tensor cores
                     (each float32 launch adds to it, 0 on the tensor cores)
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

LAUNCHES = ("rcda", "rcda_rank1", "mha", "auction", "pack")

_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_counters: Dict[str, int] = {}
_lock = threading.Lock()


def span(name: str, shape: Optional[Callable[[], str]] = None):
    """A ``record_function`` range called ``name`` (and ``shape()`` after a
    space) while a profiler runs; otherwise a shared null context."""
    if not _profiler_enabled():
        return _NULL
    return record_function(f"{name} {shape()}" if shape is not None else name)


def count(name: str, n: int = 1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def reset():
    with _lock:
        _counters.clear()


def launch_counts() -> Dict[str, int]:
    """Every kernel's launches since the counters were last zeroed."""
    return {k: _counters.get(f"launch.{k}", 0) for k in LAUNCHES}


def reset_launches():
    """Zero every ``launch.*`` counter."""
    with _lock:
        for k in [k for k in _counters if k.startswith("launch.")]:
            del _counters[k]
