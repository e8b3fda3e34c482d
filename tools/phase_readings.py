"""Readings of named kernel phases of ``chip_smoke.py`` over seeds, on the
card, in one process (how a phase's limits and shares are read without a
whole ``--readings`` run per seed):

    python tools/phase_readings.py --phases streamed_paths [--seeds 0-7]

Builds the kernels, then runs each phase of ``--phases`` (names of
``PHASES`` below, comma-separated) once per seed with ``--readings``
semantics (every field read, none stopping the run; no times) and prints,
per regime, the largest error of every field over the seeds, every held
probe's instances that round a relaxed binary otherwise, every held
certificate's differing bits with the factor within which the farthest of
them lies of its threshold, and the fields off their limits.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

# phase name -> (chip_smoke function, its generator's name, its records)
PHASES = {
    "streamed": ("phase_streamed", "streamed", "all"),
    "streamed_paths": ("phase_streamed_paths", "streamed_paths", "all"),
    "tree_shapes": ("phase_tree_shapes", "tree_shapes", "all"),
    "split": ("phase_split", "split", "admm_k1_split"),
    "mixed_schedule": ("phase_mixed_schedule", "mixed_schedule", "all"),
}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0-7")
    ap.add_argument("--phases", required=True)
    a = ap.parse_args(argv)
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)
    names = a.phases.split(",")
    for name in names:
        if name not in PHASES:
            ap.error(f"unknown phase {name!r} (have {', '.join(PHASES)})")

    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("phase_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    for lib in _build.LIBRARIES:
        _build.load_library(lib)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    recs = {k: {} for k in cs.SOURCES}
    cs.READINGS_ONLY = True
    cs.TIMINGS = False
    for seed in seeds:
        cs.SEED = seed
        print(f"seed {seed}:", flush=True)
        for name in names:
            fn, rng, rec = PHASES[name]
            cs.phase(name, getattr(cs, fn), dev, cs.phase_rng(rng),
                     recs if rec == "all" else recs[rec])
    for regime, seen in cs.READINGS.items():
        print(f"largest error over seeds {a.seeds}, {regime} (limit): "
              + " ".join(f"{k}={v:.3e} ({cs.LIMITS[regime][k]:.1e})"
                         for k, v in seen.items()), flush=True)
    cs.print_flip_and_cert_readings()
    if cs.OVER:
        print("off their limits:\n  " + "\n  ".join(cs.OVER), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
