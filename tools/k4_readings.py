"""Readings of K4 and K5 against their plain versions over seeds, on the
card (how the "sweep" and "k5" limits of ``chip_smoke.py`` and the
whole-solve holds of its phase 20 are set):

    python tools/k4_readings.py [--seeds 0-7] [--config6] [--plain-solve]
                                [--profile]
    python tools/k4_readings.py --flex [--seeds 0-7] [--probes N,...]
    python tools/k4_readings.py --any [--seeds 0-7]
    python tools/k4_readings.py --par [--seeds 0-7]
    python tools/k4_readings.py --k6 [--seeds 0-7]
    python tools/k4_readings.py --long-repeat R

Builds the kernels, then runs ``chip_smoke.phase_k4`` and
``chip_smoke.phase_k5`` (both timed at the first seed only) once per seed
with ``--readings`` semantics (every field read, none stopping the run)
and prints, per regime, the largest error of every field over the seeds,
and the fields off their limits. ``--config6`` then runs phase 21 (config
6's two arms and the served stagewise requests) once, as ``chip_smoke.py``
does; ``--plain-solve`` times solves of config 6's long arm in turns:
through K5, through the torch loop with K4 (the path K5 replaced), through
that loop again and through K5 again (each route warmed up first), then
one through the torch loop with the plain sweeps; ``--profile`` profiles
one whole solve of the long arm through K5 (device operations, busy time,
idle share).

``--flex`` runs ``chip_smoke.phase_k5_flex`` instead (K5's grouped,
global-state and horizon variants against the plain loop at the
long_horizon and wide_tree paths' shapes, the horizon variant's parallel
sweep against its windowed plain loop, and the others forced against the
shared variant at config 6's; timed at the first seed only) once per
seed, as above (how the "k5_flex" and "k5_horizon_par" limits are set),
then the long_horizon and wide_tree paths once; ``--probes N,...`` then runs the hull model's long_horizon solve
again at each probe iteration count (its found share against the probe's
length).

``--any`` runs ``chip_smoke.phase_k5_any`` (K5 past its register path:
b above 16 and more than 4 extra rows, against the plain loop; timed at
the first seed only) once per seed, as above (how the "k5_any" and
"k5_rt" limits are set), then the battery_fleet path once.

``--par`` runs ``chip_smoke.phase_k5_par`` (K5's parallel sweep inside
the shared and FLEX variants against its windowed plain loop at every
shape its paths launch; timed at the first seed only) once per seed, as
above (how the "k5_par*" limits are set),
then the paths with their ``parallel_sweeps`` twins once: config 6's two
arms (phase 21), battery_fleet, long_horizon and wide_tree.

``--k6`` runs ``chip_smoke.phase_k6`` (K6, the sweep at any b and over
windows, against its plain versions at K6_SHAPES, then the tree past K5's
clusters through the route; timed at the first seed only) once per seed,
as above (how the "k6" and "k6_random" limits are set), then the
fleet_b160 paths once.

``--long-repeat R`` runs none of the phases: it reads the long_horizon
path's four solves (the double integrator and the hull model, each with
its ``sw_parallel`` twin) R times each after a warm-up, as chip_smoke.py
reads them once (``chip_smoke.long_warm_reading``: a timed solve and one
under torch.profiler, every K5 launch's iterations, plan, the card's
clusters at once and device time logged), then the spread of each
solve's K5 device time over the readings.
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
    """Solves of config 6's long arm in turns, K5 and the torch loop with
    K4 (the route K5 replaced) each after a warm-up solve of its own: K5,
    that loop, that loop again, K5 again; then one through the torch loop
    with the plain sweeps (~70 s, not warmed up). Seconds, nodes and
    objectives of each."""
    import contextlib

    import chip_smoke as cs

    solve = config6_long_solver(dev)
    routes = {"K5": contextlib.nullcontext,
              "torch loop + K4": lambda: cs.torch_loop(cs.k4_sweep),
              "torch loop + plain sweeps": cs.torch_loop}
    seen = {}
    for name in ("K5", "torch loop + K4", "torch loop + K4", "K5",
                 "torch loop + plain sweeps"):
        with routes[name]():
            if name not in seen and "plain" not in name:
                solve()
            res, t = time_solve(solve)
        seen.setdefault(name, []).append(t)
        print(f"config 6 long arm, one solve through {name}: {t:.3f} s "
              f"({int(res.nodes_solved)} nodes, {res.waves} waves, "
              f"objective {float(res.obj):.7f})", flush=True)
        cs.check(bool(res.found), f"config 6 through {name}: no plan")


def profile_config6_solve(dev):
    """One whole solve of config 6's long arm through K5 under
    torch.profiler: device operations, K5's launches and device time, busy
    time and the idle share against the median of 3 unprofiled solves."""
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
          f"{prof['idle_share']:.3f}; K5 {prof['k5_launches']} launches, "
          f"{prof['k5_device_ms']:.1f} ms on the device", flush=True)
    cs.check(prof["k5_launches"] > 0 and all(
        prof[f"k{i}_launches"] == 0 for i in (1, 2, 4)),
        "config 6 profile: launches")
    return prof


def long_repeat(dev, reps):
    """``reps`` warm readings of each long_horizon solve
    (``chip_smoke.long_warm_reading``) after one warm-up solve, and the
    spread of K5's device time: on CUDA events in the timed runs, and on
    events and in the profiler's trace in the profiled ones."""
    import chip_smoke as cs

    for key, par in (("hull", False), ("hull", True), ("di", False),
                     ("di", True)):
        c = cs.long_controller(key, dev, parallel=par)
        x0 = list(cs.X0_LONG[key])
        c.feedback(x0)
        name = key + ("_parallel" if par else "")
        reads = [cs.long_warm_reading(name, lambda: c.feedback(x0))
                 for _ in range(reps)]

        def spread(vals):
            return (f"{min(vals):.1f}–{max(vals):.1f} ms "
                    f"({', '.join(f'{v:.1f}' for v in vals)})")

        print(f"{name}, {reps} readings: timed wall "
              + spread([r["ms"] for r in reads]) + "; timed K5 (events) "
              + spread([sum(x["ms"] for x in r["timed_launches"])
                        for r in reads])
              + "; profiled wall " + spread([r["wall_ms"] for r in reads])
              + "; profiled K5 (events) "
              + spread([sum(x["ms"] for x in r["profiled_launches"])
                        for r in reads])
              + "; profiled K5 (profiler) "
              + spread([r["k5_device_ms"] for r in reads])
              + "; idle share " + ", ".join(f"{r['idle_share']:.4f}"
                                            for r in reads), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--config6", action="store_true")
    ap.add_argument("--plain-solve", action="store_true")
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--flex", action="store_true")
    ap.add_argument("--any", action="store_true")
    ap.add_argument("--par", action="store_true")
    ap.add_argument("--k6", action="store_true")
    ap.add_argument("--probes", default="")
    ap.add_argument("--long-repeat", type=int, default=0)
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
    print(f"build {time.perf_counter() - t0:.1f} s (every library, side by "
          f"side)", flush=True)
    for line in cs.ptxas_report(_build.BUILD_INFO.get("log", "")):
        print(f"  ptxas: {line}", flush=True)
    if a.long_repeat:
        cs.phase("long_horizon readings", long_repeat, dev, a.long_repeat)
        return 1 if cs.OVER else 0
    cs.READINGS_ONLY = True
    for seed in seeds:
        cs.SEED = seed
        cs.TIMINGS = seed == seeds[0]       # the times at the first seed
        print(f"seed {seed}:", flush=True)
        if a.any:
            cs.phase("k5_any", cs.phase_k5_any, dev, cs.phase_rng("k5_any"),
                     {k: {} for k in cs.K5_FAMILY})
            continue
        if a.par:
            cs.phase("k5_par", cs.phase_k5_par, dev, cs.phase_rng("k5_par"),
                     {k: {} for k in cs.REPLACES})
            continue
        if a.k6:
            cs.phase("k6", cs.phase_k6, dev, cs.phase_rng("k6"), {})
            continue
        if a.flex:
            recs = {k: {} for k in cs.K5_FAMILY}
            cs.phase("k5_flex", cs.phase_k5_flex, dev,
                     cs.phase_rng("k5_flex"), recs)
            continue
        for name, fn in (("k4", cs.phase_k4), ("k5", cs.phase_k5)):
            cs.phase(name, fn, dev, cs.phase_rng(name), {})
    for regime, seen in cs.READINGS.items():
        print(f"largest error over seeds {a.seeds}, {regime} (limit): "
              + " ".join(f"{k}={v:.2e} ({cs.LIMITS[regime][k]:.0e})"
                         for k, v in seen.items()), flush=True)
    print("off their limits: " + ("; ".join(cs.OVER) or "none"), flush=True)
    cs.READINGS_ONLY = False
    if a.any:
        cs.phase("battery fleet", cs.phase_battery_fleet, dev)
    elif a.par:
        for name, fn in (("config 6", cs.phase_config6),
                         ("battery fleet", cs.phase_battery_fleet),
                         ("long horizons and wide trees",
                          cs.phase_wide_paths)):
            cs.phase(name, fn, dev)
    elif a.flex:
        cs.phase("long horizons and wide trees", cs.phase_wide_paths, dev)
    elif a.k6:
        cs.phase("fleet b=160", cs.phase_fleet_b160, dev)
    for n in filter(None, a.probes.split(",")):
        cs.LONG_SPEC = dict(cs.LONG_SPEC, probe_iters=int(n))
        c = cs.long_controller("hull", dev)
        res, sec = time_solve(lambda: c.feedback(list(cs.X0_LONG["hull"])))
        print(f"hull N={c.N}, probe_iters {n}: {sec:.2f} s, found "
              f"{bool(res.found)}, {int(res.nodes)} nodes, obj "
              f"{float(res.obj):.6f}", flush=True)
    if a.config6:
        cs.phase("config 6", cs.phase_config6, dev)
    if a.plain_solve:
        cs.phase("config 6 plain solve", plain_solve, dev)
    if a.profile:
        cs.phase("config 6 profile", profile_config6_solve, dev)
    return 1 if cs.OVER else 0


if __name__ == "__main__":
    sys.exit(main())
