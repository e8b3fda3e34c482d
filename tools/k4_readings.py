"""Readings of K4 against its plain version over seeds, on the card (how
the "sweep" limit of ``chip_smoke.py`` and the whole-solve holds of its
phase 20 are set):

    python tools/k4_readings.py [--seeds 0-7] [--config6] [--plain-solve]
                                [--profile]

Builds the kernels, then runs ``chip_smoke.phase_k4`` once per seed with
``--readings`` semantics (every field read, none stopping the run) and
prints, per regime, the largest error of every field over the seeds, and
the fields off their limits. ``--config6`` then runs phase 21 (config 6's
two arms and the served stagewise requests) once, as ``chip_smoke.py``
does; ``--plain-solve`` times one solve of config 6's long arm through K4
and one through the plain sweeps (each after a warm-up solve through K4);
``--profile`` profiles one whole solve of the long arm (device
operations, idle share).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def config6_long_solver(dev):
    """A function that runs one solve of config 6's long arm."""
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext,
        solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    swt, swtp = cs.config6_preps(dev, cs.config6_trees()[1],
                                 cs.config6_extra(cs.CFG6_N))
    x0 = torch.tensor(cs.X0_6, device=dev)
    data = assemble_stagewise_tree(swt, x0)
    eu = assemble_stagewise_tree_ext(swt, x0)

    def solve():
        return solve_tree_miqp_stagewise(swt, *data, BnbSpec(**cs.CFG6_SPEC),
                                         swt_probe=swtp, ext_u=eu)

    return solve


def time_solve(solve):
    """(result, host-clock seconds) of one call, ended by a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def plain_solve(dev):
    """One solve of config 6's long arm through K4 and one through the
    plain sweeps, after a warm-up solve through K4: seconds, nodes and
    objectives of both."""
    import chip_smoke as cs

    solve = config6_long_solver(dev)
    solve()
    res, t_k4 = time_solve(solve)
    with cs.plain_sweep():
        ref, t_plain = time_solve(solve)
    print(f"config 6 long arm, one solve: {t_k4:.3f} s through K4 "
          f"({int(res.nodes_solved)} nodes, objective {float(res.obj):.7f}),"
          f" {t_plain:.3f} s through the plain sweeps "
          f"({int(ref.nodes_solved)} nodes, objective "
          f"{float(ref.obj):.7f}): {t_plain / t_k4:.2f}x", flush=True)
    cs.check(bool(res.found) and bool(ref.found),
             "config 6 plain solve: no plan found")


def profile_config6_solve(dev):
    """One whole solve of config 6's long arm under torch.profiler (its
    ~360k device operations take minutes to collect, too long for
    ``chip_smoke.py``): device operations, K4's launches and device time,
    busy time and the idle share against the median of 3 unprofiled
    solves."""
    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.profile_serve import profile_request

    solve = config6_long_solver(dev)
    solve()
    times = [1e3 * time_solve(solve)[1] for _ in range(3)]
    prof = profile_request(solve)
    prof["ms"] = sorted(times)[1]
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["ms"]
    print(f"config 6 long arm, one solve under torch.profiler: "
          f"{prof['device_ops']} device operations, busy "
          f"{prof['device_busy_ms']:.1f} ms of {prof['ms']:.1f} ms unprofiled "
          f"(median of {[round(t, 1) for t in times]}): idle share "
          f"{prof['idle_share']:.3f}; K4 {prof['k4_launches']} launches, "
          f"{prof['k4_device_ms']:.1f} ms on the device", flush=True)
    cs.check(prof["k4_launches"] > 0 and prof["k1_launches"] == 0
             and prof["k2_launches"] == 0, "config 6 profile: launches")
    return prof


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--config6", action="store_true")
    ap.add_argument("--plain-solve", action="store_true")
    ap.add_argument("--profile", action="store_true")
    a = ap.parse_args(argv)
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)

    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("k4_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    _build.load_library("stagewise")
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    for line in cs.ptxas_report(_build.BUILD_INFO.get("log", "")):
        print(f"  ptxas: {line}", flush=True)
    cs.READINGS_ONLY = True
    rec = {}
    for seed in seeds:
        cs.SEED = seed
        print(f"seed {seed}:", flush=True)
        cs.phase_k4(dev, cs.phase_rng("k4"), rec)
    for regime, seen in cs.READINGS.items():
        print(f"largest error over seeds {a.seeds}, {regime} (limit): "
              + " ".join(f"{k}={v:.2e} ({cs.LIMITS[regime][k]:.0e})"
                         for k, v in seen.items()), flush=True)
    print("off their limits: " + ("; ".join(cs.OVER) or "none"), flush=True)
    cs.READINGS_ONLY = False
    if a.config6:
        cs.phase("config 6", cs.phase_config6, dev)
    if a.plain_solve:
        cs.phase("config 6 plain solve", plain_solve, dev)
    if a.profile:
        cs.phase("config 6 profile", profile_config6_solve, dev)
    return 1 if cs.OVER else 0


if __name__ == "__main__":
    sys.exit(main())
