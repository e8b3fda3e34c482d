"""Readings of K2 against its plain version at the surfaces' waves over
seeds, on the card (how the "surfaces" limits of ``chip_smoke.py`` are
set), and one run of the surfaces' paths:

    python tools/surface_readings.py [--seeds 0-7] [--paths] [--md]

Builds the kernels, then runs ``chip_smoke.phase_surface_shapes`` (the
4- and 3-agent micro-grid waves, the decentralized agents' wave and config
5's global wave; timed at the first seed only) once per seed with
``--readings`` semantics (every field read, none stopping the run) and
prints, per regime, the largest error of every field over the seeds and
the fields off their limits. ``--paths`` then runs the surfaces' phases
once, as ``chip_smoke.py`` does: the ``run`` CLI on configs 1–5 with
checkpoint/resume and the log, the micro-grid coordinator at 3 and 4
agents, the decentralized micro-grid and the examples. ``--md`` reads the
multi-device phase's per-rank waves instead
(``chip_smoke.phase_md_shapes``: config 5's pool wave and the
``feedback_batch(mesh=)`` slice; how their limits are set).
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
    ap.add_argument("--md", action="store_true")
    a = ap.parse_args(argv)
    lo, _, hi = a.seeds.partition("-")
    seeds = range(int(lo), int(hi or lo) + 1)

    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("surface_readings: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    t0 = time.perf_counter()
    for lib in _build.LIBRARIES:
        _build.load_library(lib)
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    recs = {k: {} for k in cs.SOURCES}
    cs.READINGS_ONLY = True
    for seed in seeds:
        cs.SEED = seed
        cs.TIMINGS = seed == seeds[0]       # the times at the first seed
        print(f"seed {seed}:", flush=True)
        if a.md:
            cs.phase("md shapes", cs.phase_md_shapes, dev,
                     cs.phase_rng("md_shapes"), recs)
        else:
            cs.phase("surface shapes", cs.phase_surface_shapes, dev,
                     cs.phase_rng("surface_shapes"), recs)
    for regime, seen in cs.READINGS.items():
        print(f"largest error over seeds {a.seeds}, {regime} (limit): "
              + " ".join(f"{k}={v:.2e} ({cs.LIMITS[regime][k]:.0e})"
                         for k, v in seen.items()), flush=True)
    print("off their limits: " + ("; ".join(cs.OVER) or "none"), flush=True)
    print(json.dumps({k: v for k, v in recs.items() if v}), flush=True)
    cs.READINGS_ONLY = False
    cs.SEED = 0
    if a.paths:
        out = dict(run=cs.phase("run CLI", cs.phase_run_cli, dev),
                   micro_grid=cs.phase("micro-grid", cs.phase_micro_grid,
                                       dev),
                   decentralized=cs.phase("decentralized micro-grid",
                                          cs.phase_decentralized, dev))
        cs.phase("examples", cs.phase_examples, dev)
        print(json.dumps(out), flush=True)
        print(json.dumps({p: cs.PATH_LAUNCHES[p] for p in cs.PATH_LAUNCHES}),
              flush=True)
    return 1 if cs.OVER else 0


if __name__ == "__main__":
    sys.exit(main())
