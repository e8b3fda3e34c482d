"""Closed-loop study: the switched double integrator (benchmark config 1).

Regulates x = [position, velocity] to the origin with a binary gear
choice per step (MIQP feedback): build model → controller → simulate →
inspect the log. Counterpart of ``examples/double_integrator_study.py``.

Run:  python -m pyhybridcontrol_tpu_torch.examples.double_integrator_study
      [--device cpu] [--steps 30] [--plot]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--plot", action="store_true")
    ap.add_argument("--steps", type=int, default=30)
    args = ap.parse_args(argv)

    import numpy as np

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.loop import closed_loop, make_mpc_step
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
    from pyhybridcontrol_tpu_torch.utils.profiling import wall_timer

    model = switched_double_integrator()
    ctrl = MpcController(
        model, N=10, weights=default_weights(), solver="bnb",
        bnb_spec=BnbSpec(capacity=256, wave_size=32, qp_iters=200),
        device=args.device)
    ctrl.build()
    step = make_mpc_step(model, ctrl.device_qp, ctrl.admm, method="bnb",
                         bnb_spec=ctrl.bnb_spec, repair=ctrl.repair)

    x0 = np.array([3.0, 1.0], np.float32)
    with wall_timer("closed loop", sync=ctrl.device) as t:
        res = closed_loop(model, step, x0, args.steps)

    xs = res.xs.cpu().numpy()
    vs = res.vs.cpu().numpy()
    print(f"T={args.steps} steps, {t['seconds']*1e3/args.steps:.2f} "
          f"ms/control step")
    print(f"|x_T| = {np.linalg.norm(xs[-1]):.4f} "
          f"(from {np.linalg.norm(x0):.2f})")
    print(f"gear usage: {vs[:, 1].mean()*100:.0f}% high-gear steps")
    print(f"all steps solved: {bool(res.found.all())}")
    print("k :  pos     vel     u      gear")
    for k in range(0, args.steps, max(1, args.steps // 10)):
        print(f"{k:2d}: {xs[k,0]:7.3f} {xs[k,1]:7.3f} "
              f"{vs[k,0]:6.3f} {vs[k,1]:5.1f}")

    if args.plot:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig, axes = plt.subplots(3, 1, sharex=True, figsize=(7, 7))
        axes[0].plot(xs[:, 0], label="position")
        axes[0].plot(xs[:, 1], label="velocity")
        axes[0].legend(); axes[0].set_ylabel("state")
        axes[1].step(range(len(vs)), vs[:, 0])
        axes[1].set_ylabel("u")
        axes[2].step(range(len(vs)), vs[:, 1])
        axes[2].set_ylabel("gear δ"); axes[2].set_xlabel("k")
        fig.savefig("double_integrator_study.png", dpi=120)
        print("wrote double_integrator_study.png")
    return res


if __name__ == "__main__":
    main()
