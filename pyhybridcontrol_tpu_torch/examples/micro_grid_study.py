"""Micro-grid coordination study: M DEWH agents under a shared TOU
tariff with an aggregate grid power limit — one centralized MIQP a step,
its inputs distributed to the agents. Counterpart of
``examples/micro_grid_study.py``.

Run:  python -m pyhybridcontrol_tpu_torch.examples.micro_grid_study
      [--device cpu] [--agents 3] [--steps 12]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--agents", type=int, default=3)
    ap.add_argument("--steps", type=int, default=12)
    args = ap.parse_args(argv)

    import numpy as np

    from pyhybridcontrol_tpu_torch.agents.micro_grid import (
        MicroGridCoordinator)
    from pyhybridcontrol_tpu_torch.models.dewh import DewhParams
    from pyhybridcontrol_tpu_torch.models.grid import (
        GridParams, default_tou_profile)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    M = args.agents
    params = [DewhParams() for _ in range(M)]
    grid = GridParams(P_max=(M - 1) * 3000.0,   # one heater must wait
                      tou_prices=default_tou_profile())
    mg = MicroGridCoordinator(
        params, grid, N=4, solver="bnb",
        bnb_spec=BnbSpec(capacity=256, wave_size=32, qp_iters=200),
        device=args.device)
    mg.reset([np.array([52.0 + i, 0.0]) for i in range(M)])

    rng = np.random.default_rng(0)
    print(f"{M} agents, P_max {grid.P_max/1000:.0f} kW "
          f"({M}×3 kW heaters — coupling binds)")
    print("k : total_kW  " + "  ".join(f"T{i}(u{i})" for i in range(M)))
    sols = []
    for k in range(args.steps):
        draws = (rng.uniform(0, 1, M) < 0.2) * 0.5
        sol = mg.sim_step(omega_k=draws)
        sols.append(sol)
        temps = [float(a.x[0]) for a in mg.agents]
        us = [int(float(pa.u[0])) for pa in sol.per_agent]
        row = "  ".join(f"{t:5.1f}({u})" for t, u in zip(temps, us))
        print(f"{k:2d}: {sol.total_power/1000:7.1f}   {row}")

    hist = mg.agents[0].history(Ts=params[0].Ts)
    cols = [c for c in ("x0", "u0", "delta0", "omega0") if c in hist]
    print("\nagent 0 history:")
    if hasattr(hist, "describe"):             # a pandas DataFrame
        print(hist[cols].describe().loc[["mean", "min", "max"]])
    else:
        for c in cols:
            v = np.asarray(hist[c], float)
            print(f"{c}: mean {v.mean():.3f} min {v.min():.3f} "
                  f"max {v.max():.3f}")
    return mg, sols


if __name__ == "__main__":
    main()
