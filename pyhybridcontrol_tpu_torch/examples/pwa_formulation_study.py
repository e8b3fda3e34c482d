"""Formulation study: big-M against hull (disaggregated) PWA→MLD
encodings on the config-2 plant (PWA spring + on/off actuator).

The two encodings describe the SAME MIQP, but their QP relaxations
differ: big-M relaxes to a loose bound (root bound 0 while the optimum is
~62), so branch-and-bound cannot prune and ships whatever incumbent the
heuristics found; the hull encoding is locally ideal (each step's
relaxation is the convex hull of the region disjunction), so bounds
engage, incumbents improve, and the solver reports a certified
optimality gap (mld/pwa.py). Counterpart of
``examples/pwa_formulation_study.py``.

Run:  python -m pyhybridcontrol_tpu_torch.examples.pwa_formulation_study
      [--device cpu] [--N 12] [--waves 12]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--N", type=int, default=12)
    ap.add_argument("--waves", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
    from pyhybridcontrol_tpu_torch.solver.repair import (
        prepare_repair, root_repair_incumbent)
    from pyhybridcontrol_tpu_torch.utils.device import resolve_device
    from pyhybridcontrol_tpu_torch.utils.profiling import wall_timer

    dev = resolve_device(args.device)
    x0 = torch.tensor([1.5, 0.0], device=dev)
    w = pwa_weights()
    results = {}
    for form in ("bigm", "hull"):
        model = pwa_spring_mld(on_off=True, formulation=form)
        c = CondensedMpc(model, args.N, w)
        qp, admm = c.device_qp(dev), prepare_admm_mpc(c, device=dev)
        probe = prepare_admm_mpc(c, rho=10.0, device=dev)
        rspec = prepare_repair(model, w, device=dev)
        f, h = qp.assemble(x0)
        seed = root_repair_incumbent(admm, qp, rspec, x0, f, h,
                                     qp_iters=400)
        spec = BnbSpec(capacity=1024, wave_size=64,
                       max_waves=args.waves, qp_iters=200,
                       probe_iters=1000, gap=1e-3)
        with wall_timer(form, sync=dev) as t:
            r = solve_miqp_bnb(admm, qp, f, h, spec,
                               init_incumbent=seed, admm_probe=probe)
        obj = float(r.obj)
        bo = float(r.best_open_bound)
        gap = ((obj - bo) / max(1.0, abs(obj))
               if np.isfinite(bo) and bo < obj else 0.0)
        results[form] = obj
        print(f"{form:5s}: incumbent {obj:10.4f}   certified gap "
              f"{'inf' if gap > 1e6 else f'{100 * gap:6.2f}%'}   "
              f"nodes {int(r.nodes_solved):5d}   "
              f"{t['seconds']:.1f}s  (nv={c.H.shape[0]}, "
              f"m={c.G.shape[0]})")
    better = results["bigm"] - results["hull"]
    print(f"hull incumbent better by {better:.4f} "
          f"({100 * better / abs(results['bigm']):.1f}% of big-M)")
    print(f"hull <= bigm: {results['hull'] <= results['bigm'] + 1e-6}")
    return results


if __name__ == "__main__":
    main()
