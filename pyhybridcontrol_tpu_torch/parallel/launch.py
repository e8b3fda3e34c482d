"""Spawn a world of ranks, one process each, and collect what they return.

``spawn(fn, world_size, args, device_type="cuda")`` starts
``world_size`` processes (multiprocessing "spawn"), joins them into one
``torch.distributed`` world through a ``FileStore`` in a fresh temporary
directory (no fixed port, so concurrent worlds never collide) with the
backend that ``mesh.backend_for`` picks from the topology, runs
``fn(*args)`` on every rank and returns the ranks' results in rank order.
Tensors in a result come back on the host. It raises ``RankFailed`` with
the rank's traceback if any rank raises or dies, and ``TimeoutError``
once ``timeout`` seconds have passed; either way every rank is killed.
The process group's own timeout is the same, so a collective that can
never match fails rather than hangs.

``fn`` is pickled by its qualified name: it must live in a module that
the ranks can import (and that imports no more than the ranks need). The
ranks use the card unless the caller asks for ``device_type="cpu"``, as
the CPU tests do; there each rank runs one torch thread.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

from pyhybridcontrol_tpu_torch.parallel.mesh import backend_for, rank_device
from pyhybridcontrol_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)


class RankFailed(RuntimeError):
    """A rank raised or died; ``exitcodes``: each rank's exit code when it
    was seen (None: still running)."""

    def __init__(self, msg, exitcodes=None):
        super().__init__(msg)
        self.exitcodes = exitcodes or {}


def to_host(obj):
    """``obj`` with every tensor moved to the host (dicts, lists and tuples
    walked)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return type(obj)((k, to_host(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def _rank_main(rank, world_size, backend, device_type, store_path, timeout,
               fn, args, results):
    import torch.distributed as dist

    if device_type == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(rank_device(rank, device_type))
    try:
        store = dist.FileStore(store_path, world_size)
        dist.init_process_group(
            backend, store=store, rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout))
        out = fn(*args)
        if device_type == "cuda":
            torch.cuda.synchronize()
        results.put((rank, True, to_host(out)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    try:
        dist.destroy_process_group()
    except Exception:
        pass


def _exitcodes(procs):
    """Each rank's exit code, after a moment for a dying peer to finish."""
    for p in procs:
        p.join(timeout=0.2)
    return {r: p.exitcode for r, p in enumerate(procs)}


def spawn(fn, world_size: int, args=(), device_type: str = DEFAULT_DEVICE,
          timeout: float = 300.0):
    """Run ``fn(*args)`` on every rank of a new world; the results in rank
    order. The ranks use the card unless ``device_type="cpu"`` (raises if
    there is no card). See the module docstring."""
    resolve_device(device_type)
    backend = backend_for(world_size, device_type)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="phc_world_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, device_type,
                               store_path, timeout, fn, args, results))
             for r in range(world_size)]
    got = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(got) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(got))
                raise TimeoutError(f"ranks {missing} of a {backend} world "
                                   f"of {world_size} ran out of time "
                                   f"({timeout:.0f} s)")
            try:
                rank, ok, out = results.get(timeout=min(left, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    # a result may still be in the pipe: look once more
                    try:
                        rank, ok, out = results.get(timeout=1.0)
                    except queue.Empty:
                        codes = _exitcodes(procs)
                        raise RankFailed(
                            f"rank {dead[0]} died (exit code "
                            f"{codes[dead[0]]}) without a result; exit "
                            f"codes {codes}", codes)
                else:
                    continue
            if not ok:
                codes = _exitcodes(procs)
                raise RankFailed(f"rank {rank} failed (exit codes {codes}):"
                                 f"\n{out}", codes)
            got[rank] = out
        for p in procs:
            p.join(timeout=30)
        return [got[r] for r in range(world_size)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            if p.pid is not None:
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
