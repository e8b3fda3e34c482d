"""The JAX package's results on ``long_horizon``, the numbers that
``chip_smoke.py`` prints beside the port's (``LONG_REF_OBJ``); a
development tool of the reference side, run on the CPU:

    JAX_PLATFORMS=cpu python tools/long_reference.py [--only di|hull]
        [--parallel] [--reps R]

Twin of ``tools/fleet_reference.py``. Builds ``chip_smoke.long_controller``'s
two controllers on the JAX package: the double integrator at
``LONG_DI_N`` and the PWA hull model (on/off actuator, as config 2) at
``LONG_HULL_N``, ``solver="stagewise"`` with ``LONG_SPEC`` (capacity 64,
wave 8, 8 waves, 300 relaxation and 1000 probe iterations), each from its
``X0_LONG`` state; runs ``feedback`` R times and prints one JSON line a
run: objective (full precision), nodes, found, u₀ and seconds (the first
run compiles). ``--parallel``: the ``sw_parallel=True`` controllers (the
log-depth sweeps). A reading, not a gate: the search order may differ
between the packages.
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
    ap.add_argument("--only", choices=("di", "hull"))
    ap.add_argument("--parallel", action="store_true")
    ap.add_argument("--reps", type=int, default=1)
    a = ap.parse_args(argv)

    import numpy as np

    import chip_smoke as cs
    from pyhybridcontrol_tpu.control.mpc import MpcController
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    for key in (a.only,) if a.only else ("di", "hull"):
        if key == "di":
            model, N, w = (switched_double_integrator(), cs.LONG_DI_N,
                           default_weights())
        else:
            model, N, w = (pwa_spring_mld(on_off=True, formulation="hull"),
                           cs.LONG_HULL_N, pwa_weights())
        c = MpcController(model, N, w, solver="stagewise",
                          bnb_spec=BnbSpec(**cs.LONG_SPEC),
                          sw_parallel=a.parallel)
        x0 = np.asarray(cs.X0_LONG[key], np.float32)
        for _ in range(a.reps):
            t0 = time.perf_counter()
            r = c.feedback(x0)
            print(json.dumps(dict(package="jax", model=key, N=N,
                                  parallel=a.parallel, obj=float(r.obj),
                                  nodes=int(r.nodes), found=bool(r.found),
                                  u0=np.asarray(r.u).tolist(),
                                  s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
