"""Where the time of one served request goes, on the card:

    python -m pyhybridcontrol_tpu_torch.profile_serve --config double_integrator
    python -m pyhybridcontrol_tpu_torch.profile_serve --batch

Builds the controller as the serve loop does (with its warmup solve).

Default mode: for each state, times one ``feedback`` request on the host
clock and splits it into the rollout-repair seed and the B&B wave loop
(each bracketed by a synchronise), with the number of waves. Then the
first state runs once more under ``torch.profiler``: device operations
launched, K1's and K2's device time, and the device's busy time (the
union of the device operations' intervals) against the request's
unprofiled time, which gives the idle share.

``--batch``: one batched request (``feedback_batch``) of the
configuration's batch size (``--config scenario_batch``: 1024 states drawn
from ``--seed``), repeated ``--reps`` times: per-phase ms (assembly,
rollout-repair seed, pooled B&B loop), waves, nodes, K1/K2 launches and
their batch sizes; then one more request under ``torch.profiler`` for the
device idle share.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

STATES = ([2.0, 0.0], [-3.0, 1.0], [5.0, -1.0], [0.5, 0.5], [12.0, 0.0])


@contextlib.contextmanager
def _phase_timers(log: dict, ctrl=None):
    """Time the phases of ``feedback`` / ``feedback_batch`` into ``log``
    (ms, each bracketed by a synchronise): the repair seed, the B&B loop
    (single or pooled) and, given ``ctrl``, the assembly. Restores
    everything on exit."""
    from pyhybridcontrol_tpu_torch.control import mpc
    from pyhybridcontrol_tpu_torch.solver import repair

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            log[key] = 1e3 * (time.perf_counter() - t0)
            if hasattr(out, "waves"):
                log["waves"] = out.waves
                log["nodes"] = int(out.nodes_solved)
            return out
        return wrapped

    targets = [(repair, "root_repair_incumbent", "repair_ms"),
               (mpc, "solve_miqp_bnb", "bnb_ms"),
               (mpc, "solve_miqp_bnb_pooled", "bnb_ms")]
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in targets]
    for obj, name, key in targets:
        setattr(obj, name, timed(getattr(obj, name), key))
    if ctrl is not None:
        qp = ctrl._qp
        qp.assemble = timed(qp.assemble, "assemble_ms")   # instance attr
    try:
        yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        if ctrl is not None:
            del ctrl._qp.assemble


def _busy_us(events) -> float:
    """Length of the union of the events' [start, end] intervals (µs)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_request(run) -> dict:
    """``run()`` once under torch.profiler: device operations, K1/K2/K4
    launches and device time, device busy time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    out = {"device_ops": len(dev), "device_busy_ms": _busy_us(dev) / 1e3}
    for k, name in (("k1", "admm_k1"), ("k2", "admm_k2"),
                    ("k4", "sw_solve_k")):
        ev = [e for e in dev if name in e.name]
        out[f"{k}_launches"] = len(ev)
        out[f"{k}_device_ms"] = sum(e.time_range.elapsed_us()
                                    for e in ev) / 1e3
    return out


def _timed_request(run, log, ctrl=None):
    with _phase_timers(log, ctrl):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sol = run()
        torch.cuda.synchronize()
        log["total_ms"] = 1e3 * (time.perf_counter() - t0)
    return sol


def profile_single(ctrl) -> list:
    rows = []
    for x0 in STATES:
        log = {"x0": x0}
        sol = _timed_request(lambda: ctrl.feedback(x0), log)
        log["found"] = bool(sol.found)
        rows.append(log)
    prof = profile_request(lambda: ctrl.feedback(STATES[0]))
    prof["x0"] = STATES[0]
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / rows[0]["total_ms"]
    rows.append(prof)
    return rows


def profile_batch(ctrl, batch: int, seed: int, reps: int) -> list:
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    x0s = np.random.default_rng(seed).normal(
        size=(batch, ctrl.model.info.nx)).astype(np.float32)
    rows = []
    for rep in range(reps):
        log = {"batch": batch, "rep": rep}
        ca.reset_launch_counts()
        sol = _timed_request(lambda: ctrl.feedback_batch(x0s), log, ctrl)
        log["launches"] = dict(ca.LAUNCHES)
        log["launch_batches"] = {k: dict(v)
                                 for k, v in ca.LAUNCH_BATCHES.items() if v}
        log["found_share"] = float(sol.found.float().mean())
        log["ms_per_instance"] = log["total_ms"] / batch
        rows.append(log)
    prof = profile_request(lambda: ctrl.feedback_batch(x0s))
    prof["batch"] = batch
    best = min(r["total_ms"] for r in rows)
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / best
    rows.append(prof)
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default=None,
                   help="default: double_integrator, or scenario_batch "
                        "with --batch")
    p.add_argument("--batch", action="store_true",
                   help="profile one batched request of the "
                        "configuration's batch size")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device available", file=sys.stderr)
        return 1
    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.configs import get_config

    config = args.config or ("scenario_batch" if args.batch
                             else "double_integrator")
    ctrl, _ = serve.build_controller(config, "bnb", "cuda")
    if args.batch:
        rows = profile_batch(ctrl, get_config(config).batch, args.seed,
                             args.reps)
    else:
        rows = profile_single(ctrl)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
