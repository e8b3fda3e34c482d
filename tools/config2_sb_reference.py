"""The JAX package's readings of the search options on config 2, the
numbers ``chip_smoke.py`` prints beside the port's (``CFG2_ARMS_REF``); a
development tool of the reference side, run on the CPU:

    JAX_PLATFORMS=cpu python tools/config2_sb_reference.py [--arms a,b,...]

Config 2 as ``scripts/config2_sb_ab.py``'s config-2 arm builds it: the PWA
spring (hull), N=20, the repair seed at 400 iterations, the probe prep at
ρ=10, from x0 = [1.5, 0]; capacity 2048, wave 128, 64 waves, 200 + 600
iterations, gap 1e-3, probe_patience 3, rel_gap 0.02. The arms:

    a  none                         d  root_iters=3200 + c + dive_slots=16
    b  sb_iters=400                 e  depth_tiebreak=1e-2
    c  b + sb_fix                   f  branching="flipdelta"
    cut  arm d on the split-cut frame (with_split_cuts over the trust box
         [0.5, -1]–[2.5, 1] around the nominal x0, the defaults)

For each arm it prints one JSON line: objective, nodes, waves, found, best
open bound, the certified relative gap and the seconds of the solve
(compiled before, so the time is the search's). A reading, not a gate:
the port may walk another tree (search order may differ).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

BASE = dict(capacity=2048, wave_size=128, max_waves=64, qp_iters=200,
            probe_iters=600, gap=1e-3, probe_patience=3, rel_gap=0.02)
SB = dict(sb_iters=400)
ARMS = {"a": {}, "b": SB, "c": dict(SB, sb_fix=True),
        "d": dict(SB, sb_fix=True, root_iters=3200, dive_slots=16),
        "e": dict(depth_tiebreak=1e-2), "f": dict(branching="flipdelta"),
        "cut": dict(SB, sb_fix=True, root_iters=3200, dive_slots=16)}
X0 = [1.5, 0.0]
TRUST_BOX = ([0.5, -1.0], [2.5, 1.0])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default=",".join(ARMS))
    a = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from pyhybridcontrol_tpu.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu.ops.cuts import with_split_cuts
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec, solve_miqp_bnb
    from pyhybridcontrol_tpu.solver.repair import (
        prepare_repair, root_repair_incumbent)

    model = pwa_spring_mld(on_off=True, formulation="hull")
    c = CondensedMpc(model, 20, pwa_weights())
    rspec = prepare_repair(model, pwa_weights())
    x0 = jnp.asarray(X0)
    frames = {}

    def frame(cut):
        if cut not in frames:
            cc = c
            if cut:
                t0 = time.perf_counter()
                cc, d = with_split_cuts(c, *TRUST_BOX, X0,
                                        return_diagnostics=True)
                print(json.dumps({
                    "cuts": d.n_cuts, "rounds": d.rounds,
                    "root_bound_before": d.root_bound_before,
                    "root_bound_after": d.root_bound_after,
                    "s": round(time.perf_counter() - t0, 2)}), flush=True)
            frames[cut] = (cc.device_qp(), prepare_admm_mpc(cc),
                           prepare_admm_mpc(cc, rho=10.0))
        return frames[cut]

    for arm in a.arms.split(","):
        qp, admm, probe = frame(arm == "cut")
        spec = BnbSpec(**BASE, **ARMS[arm])

        @jax.jit
        def run(x0):
            f, h = qp.assemble(x0)
            seed = root_repair_incumbent(admm, qp, rspec, x0, f, h,
                                         qp_iters=400)
            return solve_miqp_bnb(admm, qp, f, h, spec, init_incumbent=seed,
                                  admm_probe=probe)

        jax.block_until_ready(run(x0))                  # compile
        t0 = time.perf_counter()
        r = jax.block_until_ready(run(x0))
        s = time.perf_counter() - t0
        obj, bo = float(r.obj), float(r.best_open_bound)
        gap = ((obj - bo) / max(1.0, abs(obj))
               if np.isfinite(bo) and bo < obj else 0.0)
        print(json.dumps({
            "arm": arm, "objective": obj, "nodes": int(r.nodes_solved),
            "waves": int(r.waves), "found": bool(r.found),
            "best_open_bound": bo, "certified_rel_gap": gap,
            "s": round(s, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
