"""The JAX package's result on config 6's long arm, the number that
``chip_smoke.py`` holds the port to (``CFG6_REF_OBJ``); a development tool
of the reference side, run on the CPU:

    JAX_PLATFORMS=cpu python tools/config6_reference.py [--reps R]
        [--parallel]

Builds config 6 as the reference bench does (bench.py:742-816): the
double integrator with a velocity disturbance, the S=2, N=4 tree drawn
from default_rng(11), then the S=8, N=120 tree branching at steps 1, 40
and 80 on tree-consistent paths of the same generator, one horizon-coupled
row Σ_k u_k ≤ 60, the bench's spec (capacity 64, wave 8, 6 waves, 150
relaxation and 1000 probe iterations at ρ·10, gap 1e-3), from x0 = [2, 0];
solves it R times with ``solve_tree_miqp_stagewise`` and prints the
objective (full precision), nodes, waves, found and seconds per solve.
``--parallel``: the solves with ``parallel_sweeps=True`` (the log-depth
sweeps), as ``MpcController(sw_parallel=True)`` runs them.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--parallel", action="store_true")
    a = ap.parse_args(argv)

    import jax.numpy as jnp

    from pyhybridcontrol_tpu.mld.info import MldInfo
    from pyhybridcontrol_tpu.mld.model import MldModel
    from pyhybridcontrol_tpu.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu.ops.scenario_tree import (
        ScenarioTree, tree_consistent_paths)
    from pyhybridcontrol_tpu.ops.stagewise_tree import (
        assemble_stagewise_tree, assemble_stagewise_tree_ext,
        prepare_stagewise_tree, solve_tree_miqp_stagewise)
    from pyhybridcontrol_tpu.solver.bnb import BnbSpec

    base = switched_double_integrator()
    m = base.numpy_mats()
    model = MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    w = default_weights()
    rng = np.random.default_rng(11)
    rng.normal(0.0, 0.3, size=(2, 4, 1))           # the parity arm's tree
    N, S, steps = 120, 8, (1, 40, 80)
    tree = ScenarioTree.from_branching(
        tree_consistent_paths(rng, S, N, steps, sd=0.2), branch_steps=steps)
    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    extra = (A_v, np.array([60.0]), None, None)
    swt, swtp = (prepare_stagewise_tree(model, tree, w, rho=r, extra=extra)
                 for r in (1.0, 10.0))
    x0 = jnp.asarray([2.0, 0.0], jnp.float32)
    q, l, u = assemble_stagewise_tree(swt, x0)
    ext_u = assemble_stagewise_tree_ext(swt, x0)
    spec = BnbSpec(capacity=64, wave_size=8, max_waves=6, qp_iters=150,
                   probe_iters=1000, gap=1e-3)
    for _ in range(a.reps):
        t0 = time.perf_counter()
        r = solve_tree_miqp_stagewise(swt, q, l, u, spec, swt_probe=swtp,
                                      ext_u=ext_u,
                                      parallel_sweeps=a.parallel)
        r.obj.block_until_ready()
        print(f"objective {float(r.obj)!r}, nodes {int(r.nodes_solved)}, "
              f"found {bool(r.found)}, {time.perf_counter() - t0:.2f} s",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
