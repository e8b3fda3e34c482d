"""The JAX package's objectives on config 2, the numbers ``chip_smoke.py``
prints beside the port's (``CFG2_REF_OBJ``); a development tool of the
reference side, run on the CPU:

    JAX_PLATFORMS=cpu python tools/config2_reference.py [--skip-2b]

Twin of ``tools/config6_reference.py``. Three readings, each one JSON line:

- the bench's config-2 call (bench.py:453-512): the PWA spring (hull),
  N=20, the repair seed at 400 iterations, the probe prep at ρ=10, capacity
  1024, wave 128, 16 waves, 200 + 600 iterations, gap 1e-3,
  probe_patience 3, from x0 = [1.5, 0];
- config 2b's call (bench.py:861-928): the same with rel_gap 0.02,
  capacity 8192 and 128 waves (about 2.5 minutes on the CPU);
- the served config-2 states of ``chip_smoke.phase_config2_serve``: the
  reference's own serve controller (``serve._build_controller`` for
  ``--config pwa_actuator --solver bnb``: the warm-up solve at x = 0, then
  [1.5, 0], [-1, 0.5] and [0.8, -1.2] in that order, as the stdin loop
  sends them).

Objectives, nodes, waves, found, the certified relative gap and the seconds
of each solve (compiled before where the bench compiles before). A reading,
not a gate: search order may differ legitimately between the packages.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

X0 = [1.5, 0.0]
SERVED = ([1.5, 0.0], [-1.0, 0.5], [0.8, -1.2])
BASE = dict(wave_size=128, qp_iters=200, probe_iters=600, gap=1e-3,
            probe_patience=3)
CALLS = {"config2_call": dict(BASE, capacity=1024, max_waves=16),
         "config2b_call": dict(BASE, capacity=8192, max_waves=128,
                               rel_gap=0.02)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--skip-2b", action="store_true")
    a = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu.serve import _build_controller
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
    from pyhybridcontrol_tpu.solver.repair import (
        prepare_repair, root_repair_incumbent)

    model = pwa_spring_mld(on_off=True, formulation="hull")
    c = CondensedMpc(model, 20, pwa_weights())
    qp, admm = c.device_qp(), prepare_admm_mpc(c)
    admm_p = prepare_admm_mpc(c, rho=10.0)
    rspec = prepare_repair(model, pwa_weights())

    def gap_of(obj, bo):
        return ((obj - bo) / max(1.0, abs(obj))
                if np.isfinite(bo) and bo < obj else 0.0)

    for path, kw in CALLS.items():
        if a.skip_2b and path == "config2b_call":
            continue
        spec = BnbSpec(**kw)

        @jax.jit
        def fb(x0):
            f, h = qp.assemble(x0)
            seed = root_repair_incumbent(admm, qp, rspec, x0, f, h,
                                         qp_iters=400)
            return solve_miqp_bnb(admm, qp, f, h, spec, init_incumbent=seed,
                                  admm_probe=admm_p)

        x0 = jnp.asarray(X0)
        jax.block_until_ready(fb(x0))                   # compile
        t0 = time.perf_counter()
        r = jax.block_until_ready(fb(x0))
        obj, bo = float(r.obj), float(r.best_open_bound)
        print(json.dumps({
            "path": path, "objective": obj, "nodes": int(r.nodes_solved),
            "waves": int(r.waves), "found": bool(r.found),
            "certified_rel_gap": gap_of(obj, bo),
            "s": round(time.perf_counter() - t0, 2)}), flush=True)

    ctrl, _ = _build_controller(argparse.Namespace(config="pwa_actuator",
                                                   solver="bnb"))
    for x in SERVED:
        t0 = time.perf_counter()
        sol = ctrl.feedback(jnp.asarray(x, jnp.float32))
        print(json.dumps({
            "path": "config2_serve", "x0": x, "objective": float(sol.obj),
            "found": bool(sol.found),
            "gap": float(getattr(sol, "gap", 0.0)),
            "s": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
