"""Config 4c's pooled rep-map search against single-instance dense-tree
searches, instance by instance (a development tool, not part of the
package):

    python tools/tree_search_ab.py                 # on the card
    python tools/tree_search_ab.py --oracle 0 160  # fp64 oracle, on the host

On the card: the reference bench's config-4c call (``chip_smoke.py``
phase 18: 256 trees, ``feedback_batch(engine="pooled")``, rep-map
branching) once, then ``feedback`` (per-coordinate branching, K2) on the
16 instances phase 18 holds, with the bench's spec (64 waves) and with
1024 waves. Prints, per instance, the single search's objective, its
certified relative gap, nodes and waves, the pooled objective and their
difference beside ``serve_limit``.

``--oracle I [J ...]``: the fp64 optimum of those instances of the same
call (``chip_smoke.oracle_bnb``: branch and bound on the port's fp64 QP
oracle, minutes an instance), on the host; no card needed.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def states():
    """(tree, frame, the call's 256 states) of config 4c."""
    tree, rng = cs.config4c_tree()
    _, _, c = cs.bench_frame("config4c")
    return tree, c, rng.normal(size=(cs.CFG4C_B, 2)).astype(np.float32)


def oracle(indices):
    tree, c, x0s = states()
    W = tree.omega_paths.reshape(-1, 1)
    for i in indices:
        t0 = time.perf_counter()
        obj, nodes = cs.oracle_bnb(c, *c.assemble_np(x0s[i], W))
        print(f"instance {i}: fp64 optimum {obj!r} ({nodes} oracle nodes, "
              f"{time.perf_counter() - t0:.1f} s)", flush=True)


def on_card():
    import torch

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    tree, c, x0s = states()
    model, w, _ = cs.bench_frame("config4c")

    def controller(**kw):
        ct = MpcController(model, cs.CFG4C_N, w, device=dev)
        ct.set_scenario_tree(tree)
        ct.bnb_spec = BnbSpec(**dict(cs.CFG4C_SPEC, **kw))
        return ct

    xs = torch.as_tensor(x0s, device=dev)
    t0 = time.perf_counter()
    res = controller().feedback_batch(xs, engine="pooled", pooled_wave=1024,
                                      pool_slots=8 * cs.CFG4C_B)
    pooled = res.obj.double().cpu().numpy()
    print(f"pooled call: {time.perf_counter() - t0:.2f} s", flush=True)
    for max_waves in (cs.CFG4C_SPEC["max_waves"], 1024):
        ct = controller(max_waves=max_waves)
        rows = []
        for i in cs.CFG4C_HELD:
            ca.reset_launch_counts()
            r = ct.feedback(xs[i])
            torch.cuda.synchronize()
            waves = (ca.LAUNCHES["admm_k2_resident"]
                     + ca.LAUNCHES["admm_k1_resident"])
            rows.append((i, float(r.obj), float(r.gap), int(r.nodes), waves))
        ref = np.array([r[1] for r in rows])
        p = pooled[list(cs.CFG4C_HELD)]
        rel = np.abs(p - ref) / np.maximum(1.0, np.abs(ref))
        print(f"single searches, max_waves={max_waves}: pooled lower on "
              f"{int((p < ref).sum())} of {len(rows)}, worst relative "
              f"|Δobj| {rel.max():.2e}, within serve_limit on "
              f"{int((np.abs(p - ref) <= cs.serve_limit(ref)).sum())}",
              flush=True)
        for (i, obj, gap, nodes, waves), pi in zip(rows, p):
            print(f"  instance {i}: single {obj:.6f} (gap {gap:.2e}, {nodes} "
                  f"nodes, {waves} waves), pooled {pi:.6f}, Δ "
                  f"{pi - obj:+.3e}, serve_limit "
                  f"{float(cs.serve_limit(obj)):.2e}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--oracle", type=int, nargs="+", metavar="I")
    a = ap.parse_args(argv)
    if a.oracle:
        oracle(a.oracle)
    else:
        on_card()
    return 0


if __name__ == "__main__":
    sys.exit(main())
