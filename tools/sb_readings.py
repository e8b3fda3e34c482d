"""Readings of K1 against its plain version at root strong branching's
batch and of device condensation against the host fp64 build, over seeds,
on the card (how the "strong_branching" and "condense" limits of
``chip_smoke.py`` are set), and one run of config 2's search-option
paths:

    python tools/sb_readings.py [--seeds 0-7] [--paths] [--ablate]

Builds the kernels, then runs ``chip_smoke.phase_sb_batch`` (config 2's
120 candidate children of the root, 400 iterations warm; timed at the
first seed only) and ``chip_smoke.phase_condense`` once per seed with
``--readings`` semantics (every field read, none stopping the run) and
prints, per regime, the largest error of every field over the seeds and
the fields off their limits. ``--paths`` then runs the new phases once, as
``chip_smoke.py`` does: config 2's six search arms, the split-cut frame
with arm d on it. ``--ablate`` solves arm d again with each of its
options left out in turn (objective, certified gap, waves, nodes, ms).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--paths", action="store_true")
    ap.add_argument("--ablate", action="store_true")
    a = ap.parse_args(argv)
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)

    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("sb_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    for lib in _build.LIBRARIES:
        _build.load_library(lib)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    recs = {k: {} for k in cs.SOURCES}
    cs.READINGS_ONLY = True
    out = {}
    for seed in seeds:
        cs.SEED = seed
        cs.TIMINGS = seed == seeds[0]       # the times at the first seed
        print(f"seed {seed}:", flush=True)
        cs.phase("K1 at the strong-branching batch", cs.phase_sb_batch, dev,
                 cs.phase_rng("sb_batch"), recs)
        out[f"condense_seed{seed}"] = cs.phase(
            "device condensation", cs.phase_condense, dev,
            cs.phase_rng("condense"))
    for regime, seen in cs.READINGS.items():
        print(f"largest error over seeds {a.seeds}, {regime} (limit): "
              + " ".join(f"{k}={v:.2e} ({cs.LIMITS[regime][k]:.0e})"
                         for k, v in seen.items()), flush=True)
    if cs.OVER:
        print("off their limits:\n  " + "\n  ".join(cs.OVER), flush=True)
    if a.paths:
        cs.SEED, cs.TIMINGS, cs.READINGS_ONLY = seeds[0], True, False
        arms = cs.phase("config 2 search options", cs.phase_config2_arms,
                        dev, recs)
        out["config2_sb"] = arms
        out["config2_cut"] = cs.phase("config 2 cut frame",
                                      cs.phase_config2_cut, dev, recs, arms)
    if a.ablate:
        out["arm_d_ablated"] = ablate_arm_d(cs, dev)
    print(json.dumps({"records": {k: v for k, v in recs.items() if v},
                      "calls": out}, default=str), flush=True)
    return 1 if cs.OVER else 0


def ablate_arm_d(cs, dev):
    """Arm d of config 2 whole, then with each option left out (sb_iters
    with sb_fix): {left out: reading}."""
    import torch

    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    st = cs.cfg2_setup(dev)
    x0 = torch.tensor(cs.CFG2_X0, device=dev)
    d = cs.CFG2_ARMS["d"]
    out = {}
    for drop in ("nothing", "root_iters", "dive_slots", "sb_fix",
                 "sb_iters"):
        kw = {k: v for k, v in d.items() if k != drop
              and not (drop == "sb_iters" and k == "sb_fix")}
        spec = BnbSpec(**cs.CFG2_SB_SPEC, **kw)
        cs.cfg2_solve(st, spec, x0)                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = cs.cfg2_solve(st, spec, x0)
        torch.cuda.synchronize()
        obj, bo = float(r.obj), float(r.best_open_bound)
        out[drop] = dict(ms=1e3 * (time.perf_counter() - t0), waves=r.waves,
                         nodes=int(r.nodes_solved), objective=obj,
                         certified_rel_gap=max(obj - bo, 0.0)
                         / max(1.0, abs(obj)))
        print(f"  arm d without {drop}: {out[drop]}", flush=True)
    return out


if __name__ == "__main__":
    sys.exit(main())
