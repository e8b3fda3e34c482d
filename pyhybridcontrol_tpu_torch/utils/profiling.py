"""Tracing and timing helpers: a torch.profiler trace of device work, a
wall-clock timer that waits for the card, and the B&B counter set.

Counterpart of ``pyhybridcontrol_tpu/utils/profiling.py``, with
``torch.profiler`` in place of ``jax.profiler`` and a CUDA synchronize in
place of ``block_until_ready``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import tempfile
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Capture a torch.profiler trace of the enclosed work (the card's
    kernels too, where there is one) and write it as a Chrome trace into
    ``log_dir`` (default: a folder under the temporary directory):

        with profiling.trace("trace_dir") as prof:
            solve_miqp_bnb(...)
        prof.key_averages()
    """
    log_dir = log_dir or os.path.join(tempfile.gettempdir(),
                                      "hybrid_mpc_trace")
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _first_tensor(obj):
    """The first tensor in a nest of dicts, dataclasses, lists and tuples
    (or None)."""
    if isinstance(obj, torch.Tensor):
        return obj
    if isinstance(obj, dict):
        items = obj.values()
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        items = (getattr(obj, f.name) for f in dataclasses.fields(obj))
    elif isinstance(obj, (list, tuple)):
        items = obj
    else:
        return None
    for it in items:
        t = _first_tensor(it)
        if t is not None:
            return t
    return None


def _synchronize(sync) -> None:
    """Wait for the CUDA device of ``sync``: a device (or its name), or
    the first tensor of a nest of results. Nothing to wait for on the
    CPU."""
    if isinstance(sync, (str, torch.device)):
        dev = torch.device(sync)
    else:
        t = _first_tensor(sync)
        dev = None if t is None else t.device
    if dev is not None and dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def wall_timer(label: str = "", sync: Optional[object] = None):
    """Host wall-clock timing of the enclosed block. ``sync``: a device,
    or a tensor or nest of tensors, whose CUDA device is synchronized on
    exit so that the time covers the device work queued in the block.
    The seconds land in the yielded dict under ``"seconds"``."""
    _synchronize(sync)
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        _synchronize(sync)
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[{label}] {box['seconds'] * 1e3:.2f} ms")


def bnb_stats(result) -> dict:
    """Summarize a BnbResult into the counter set (nodes, waves, bound
    gap) as plain Python values for logging."""
    obj = float(result.obj)
    open_b = float(result.best_open_bound)
    gap = (obj - open_b) if open_b < 1e29 else 0.0
    return dict(
        obj=obj,
        found=bool(result.found),
        waves=int(result.waves),
        nodes_solved=int(result.nodes_solved),
        overflow=bool(result.overflow),
        bound_gap=gap,
    )
