"""Where the time of one served control step goes, on the card:

    python -m pyhybridcontrol_tpu_torch.profile_serve --config double_integrator

Builds the controller as the serve loop does (with its warmup solve),
then, for each state, times one ``feedback`` request on the host clock
and splits it into the rollout-repair seed and the B&B wave loop (each
bracketed by a synchronise), with the number of waves. Then the first
state runs once more under ``torch.profiler``: device operations
launched, K2's device time, and the device's busy time (the union of
the device operations' intervals) against the request's unprofiled
time, which gives the idle share.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

STATES = ([2.0, 0.0], [-3.0, 1.0], [5.0, -1.0], [0.5, 0.5], [12.0, 0.0])


@contextlib.contextmanager
def _phase_timers(log: dict):
    """Time the repair seed and the B&B loop of ``feedback`` into ``log``
    (ms, each bracketed by a synchronise); restores both on exit."""
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
            return out
        return wrapped

    seed, bnb = repair.root_repair_incumbent, mpc.solve_miqp_bnb
    repair.root_repair_incumbent = timed(seed, "repair_ms")
    mpc.solve_miqp_bnb = timed(bnb, "bnb_ms")
    try:
        yield
    finally:
        repair.root_repair_incumbent, mpc.solve_miqp_bnb = seed, bnb


def _busy_us(events) -> float:
    """Length of the union of the events' [start, end] intervals (µs)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end)
                       for e in events):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def profile_request(ctrl, x0) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ctrl.feedback(x0)
        torch.cuda.synchronize()
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    k2 = [e for e in dev if "admm_k2" in e.name]
    return {"device_ops": len(dev), "k2_launches": len(k2),
            "k2_device_ms": sum(e.time_range.elapsed_us() for e in k2) / 1e3,
            "device_busy_ms": _busy_us(dev) / 1e3}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--config", default="double_integrator")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve: no CUDA device available", file=sys.stderr)
        return 1
    from pyhybridcontrol_tpu_torch import serve

    ctrl, _ = serve.build_controller(args.config, "bnb", "cuda")
    rows = []
    for x0 in STATES:
        log = {"x0": x0}
        with _phase_timers(log):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sol = ctrl.feedback(x0)
            torch.cuda.synchronize()
            log["total_ms"] = 1e3 * (time.perf_counter() - t0)
        log["found"] = bool(sol.found)
        rows.append(log)
    prof = profile_request(ctrl, STATES[0])
    prof["x0"] = STATES[0]
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / rows[0]["total_ms"]
    rows.append(prof)
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
