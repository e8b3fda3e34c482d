"""Stochastic MPC with a scenario tree: hedging against uncertain
disturbances. Counterpart of ``examples/scenario_tree_study.py``.

A double integrator with an additive velocity disturbance faces S
equally likely disturbance futures that diverge after ``--branch``
steps. The scenario-tree controller optimizes all S futures jointly
under non-anticipativity (decisions before the branch point are shared)
and is compared against a certainty-equivalent (CE) controller that
plans for the MEAN disturbance. With a Δu penalty (``--rdu``) early
decisions are costly to reverse, so the hedged first input beats CE on
average realized cost; with cheap control (``--rdu 0``) reversals are
free and hedging buys nothing. (The evaluator gives both plans
clairvoyant tails after step 0, so the cheap-control case can even tip
slightly negative.)

Run:  python -m pyhybridcontrol_tpu_torch.examples.scenario_tree_study
      [--device cpu] [--scenarios 4] [--horizon 6]
"""

import argparse


def omega_model():
    """The switched double integrator with a velocity disturbance
    channel (B4 = [0, 1]ᵀ)."""
    import numpy as np

    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        switched_double_integrator)

    base = switched_double_integrator()
    m = base.numpy_mats()
    return MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--scenarios", type=int, default=4)
    ap.add_argument("--horizon", type=int, default=6)
    ap.add_argument("--branch", type=int, default=1)
    ap.add_argument("--rdu", type=float, default=6.0)
    ap.add_argument("--omega-scale", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights)
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    S, N, K = args.scenarios, args.horizon, args.branch
    model = omega_model()
    rng = np.random.default_rng(args.seed)
    # disturbance futures: identical until the branch step, then diverge
    omega = np.zeros((S, N, 1), np.float32)
    omega[:, K:] = rng.normal(size=(S, N - K, 1)) * args.omega_scale
    tree = ScenarioTree.from_branching(omega, branch_steps=(K,))

    spec = BnbSpec(capacity=512, wave_size=64, qp_iters=400, max_waves=48)
    x0 = np.array([0.0, 0.3], np.float32)
    w = default_weights()
    if args.rdu > 0:
        w.Rdu = np.array([args.rdu])   # reversals cost → hedging matters

    tree_ctrl = MpcController(model, N, w, bnb_spec=spec,
                              device=args.device)
    tree_ctrl.set_scenario_tree(tree)
    hedged = tree_ctrl.feedback(x0)

    # certainty-equivalent: plan for the MEAN disturbance path
    ce_ctrl = MpcController(model, N, w, bnb_spec=spec, device=args.device)
    ce = ce_ctrl.feedback(x0, omega_forecast=omega.mean(axis=0))

    print(f"scenarios={S} horizon={N} branch_at={K}")
    print(f"tree  first input u0 = {float(hedged.u[0]):+.4f}  "
          f"(expected cost {float(hedged.obj):.4f}, "
          f"found={bool(hedged.found)})")
    print(f"CE    first input u0 = {float(ce.u[0]):+.4f}  "
          f"(mean-path cost {float(ce.obj):.4f}, found={bool(ce.found)})")

    # evaluate BOTH first-stage plans against every realized scenario:
    # apply u0, then replan with perfect scenario knowledge (u_prev
    # carried so the Δu cost stays consistent); realized cost =
    # stage-0 cost + optimal remaining cost (standard hedging value)
    tail_ctrl = MpcController(model, N - 1, w, bnb_spec=spec,
                              device=args.device)
    dev = tail_ctrl.device
    sim = model.to(dev)
    x0_t = torch.as_tensor(x0, device=dev)

    def realized(u, d, z):
        costs = []
        for s in range(S):
            x1 = sim.step(x0_t, u, d, z,
                          torch.as_tensor(omega[s, 0], device=dev))
            tail = tail_ctrl.feedback(x1, omega_forecast=omega[s, 1:],
                                      u_prev=u)
            stage0 = (np.sum(np.asarray(w.Qx) * x0 ** 2)
                      + np.sum(np.asarray(w.Ru)
                               * u.double().cpu().numpy() ** 2))
            costs.append(float(stage0) + float(tail.obj))
        return float(np.mean(costs))

    jt = realized(hedged.u, hedged.delta, hedged.z)
    jc = realized(ce.u, ce.delta, ce.z)
    print(f"avg realized cost over scenarios: tree {jt:.4f} vs CE {jc:.4f}")
    print(f"hedging value (CE - tree): {jc - jt:+.4f}")
    ok = bool(hedged.found) and bool(ce.found)
    print(f"study ok: {ok}")
    return dict(tree=jt, ce=jc, ok=ok, hedged_obj=float(hedged.obj),
                ce_obj=float(ce.obj))


if __name__ == "__main__":
    main()
