"""The JAX package's result on the battery fleet, the number that
``chip_smoke.py`` prints beside the port's (``FLEET_REF_OBJ``); a
development tool of the reference side, run on the CPU:

    JAX_PLATFORMS=cpu python tools/fleet_reference.py [--reps R] [--port]
        [--parallel] [--batteries M --horizon N]

Twin of ``tools/config2_reference.py``. Builds ``chip_smoke.py``'s
``battery_fleet`` setup on the JAX package: eight default batteries
(models/battery.py) aggregated with the feeder limit |Σp| ≤ 20 kW as
coupling rows, N = 96, ``solver="stagewise"``, the 20 horizon-coupled rows
and the TOU price of ``chip_smoke.fleet_arrays``, the spec ``FLEET_SPEC``
(capacity 256, wave 8, 8 waves, 150 relaxation and 1000 probe
iterations), from SoC linspace(0.3, 0.7, 8); runs ``feedback`` R times and
prints one JSON line a run: objective (full precision), nodes, found, u₀
and seconds (the first run compiles). ``--port`` also runs the port's
``chip_smoke.fleet_controller`` with ``device="cpu"`` on the same setup.
``--parallel``: both controllers with ``sw_parallel=True`` (the
log-depth sweeps). ``--batteries M --horizon N``: another fleet of the
same make (default 8 and 96; 40 and 24 give ``fleet_b160``'s b = 160,
``chip_smoke.FLEET_B160_REF_OBJ``).
A reading, not a gate: the search order may differ between the packages.
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
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--parallel", action="store_true")
    ap.add_argument("--batteries", type=int, default=None)
    ap.add_argument("--horizon", type=int, default=None)
    a = ap.parse_args(argv)

    import numpy as np

    import chip_smoke as cs
    from pyhybridcontrol_tpu.control.mpc import MpcController
    from pyhybridcontrol_tpu.mld.compose import aggregate_mld
    from pyhybridcontrol_tpu.models.battery import (
        BatteryParams, battery_model, battery_weights)
    from pyhybridcontrol_tpu.models.grid import default_tou_profile
    from pyhybridcontrol_tpu.ops.condense import MpcWeights
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    M = cs.FLEET_M if a.batteries is None else a.batteries
    N = cs.FLEET_N if a.horizon is None else a.horizon
    p = BatteryParams()
    one = battery_model(p)
    F1, f5, A_v, b_e, price, x0 = cs.fleet_arrays(
        M, N, M * one.info.nv, default_tou_profile(N), p.Ts_h)
    model = aggregate_mld([battery_model(p) for _ in range(M)],
                          coupling_F1=F1, coupling_f5=f5)
    bw = battery_weights()
    w = MpcWeights(Qx=np.tile(bw.Qx, M), x_ref=np.tile(bw.x_ref, M),
                   Ru=np.tile(bw.Ru, M))
    c = MpcController(model, N, w, solver="stagewise",
                      bnb_spec=BnbSpec(**cs.FLEET_SPEC),
                      sw_parallel=a.parallel)
    c.set_extra_constraints(A_v, b_e)
    c.build()
    for _ in range(a.reps):
        t0 = time.perf_counter()
        r = c.feedback(x0, price_seq=price)
        obj = float(r.obj)
        print(json.dumps(dict(package="jax", parallel=a.parallel,
                              batteries=M, horizon=N, obj=obj,
                              nodes=int(r.nodes), found=bool(r.found),
                              u0=np.asarray(r.u).tolist(),
                              s=time.perf_counter() - t0)), flush=True)
    if a.port:
        tc, tprice, tx0, _ = cs.fleet_controller(M, N, "cpu",
                                                 parallel=a.parallel)
        t0 = time.perf_counter()
        r = tc.feedback(tx0, price_seq=tprice)
        print(json.dumps(dict(package="port (cpu)", obj=float(r.obj),
                              nodes=int(r.nodes), found=bool(r.found),
                              u0=r.u.numpy().tolist(),
                              s=time.perf_counter() - t0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
