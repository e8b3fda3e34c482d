"""DEWH demand-side-management study: a domestic electric water heater
under a time-of-use tariff, stochastic hot-water draws, a soft comfort
band and startup penalties — a closed loop of ``--hours`` at 15-minute
periods. Counterpart of ``examples/dewh_dsm_study.py``.

Run:  python -m pyhybridcontrol_tpu_torch.examples.dewh_dsm_study
      [--device cpu] [--hours 24]
"""

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--hours", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.loop import closed_loop, make_mpc_step
    from pyhybridcontrol_tpu_torch.models.dewh import (
        DewhParams, dewh_energy_price_seq, dewh_model, dewh_weights)
    from pyhybridcontrol_tpu_torch.models.grid import default_tou_profile
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    p = DewhParams()
    model = dewh_model(p)
    N = 12
    T = int(args.hours * 3600 / p.Ts)
    ctrl = MpcController(model, N, weights=dewh_weights(T_set=60.0),
                         solver="bnb",
                         bnb_spec=BnbSpec(capacity=256, wave_size=32,
                                          qp_iters=250),
                         device=args.device)
    nc = model.info.ncons
    ctrl.set_soft_constraints(
        [k * nc + r for k in range(N) for r in (0, 1)],
        lin_pen=5.0, quad_pen=1.0)
    ctrl.build()
    step = make_mpc_step(model, ctrl.device_qp, ctrl.admm, method="bnb",
                         bnb_spec=ctrl.bnb_spec, repair=ctrl.repair)

    rng = np.random.default_rng(args.seed)
    # morning/evening-weighted draw profile
    t_of_day = (np.arange(T + N) * p.Ts / 3600.0) % 24.0
    p_draw = np.where((t_of_day > 6) & (t_of_day < 9), 0.5,
                      np.where((t_of_day > 18) & (t_of_day < 22), 0.4,
                               0.08))
    draws = (0.6 * (rng.uniform(0, 1, T + N) < p_draw)
             ).astype(np.float32)[:, None]
    tou = default_tou_profile(int(24 * 3600 / p.Ts))
    prices_day = np.array([tou[int(t / 24.0 * len(tou)) % len(tou)]
                           for t in t_of_day])
    price_seq = dewh_energy_price_seq(prices_day, p, nv=model.info.nv
                                      ).astype(np.float32)

    res = closed_loop(model, step, np.array([58.0, 0.0], np.float32), T,
                      omega_traj=draws, price_traj=price_seq)

    temps = res.xs[:, 0].cpu().numpy()
    us = res.vs[:, 0].cpu().numpy()
    energy_kwh = us.sum() * p.P_h * p.Ts / 3.6e6
    cost = float(np.sum(us * prices_day[:T] * p.P_h * p.Ts / 3.6e6))
    on_peak = us[(t_of_day[:T] >= 7) & (t_of_day[:T] < 23)].sum()
    off_peak = us.sum() - on_peak
    print(f"{args.hours:.0f}h simulation, {T} control steps")
    print(f"temperature: min {temps.min():.1f} / mean {temps.mean():.1f} "
          f"/ max {temps.max():.1f} °C (band {p.T_min}-{p.T_max})")
    print(f"energy: {energy_kwh:.1f} kWh  cost: ${cost:.2f}")
    print(f"heater-on steps: {int(us.sum())} "
          f"(on-peak {int(on_peak)}, off-peak {int(off_peak)})")
    print(f"draws served: {int(draws[:T].sum() / 0.6)}")
    print(f"all MIQPs solved: {bool(res.found.all())}")
    return res


if __name__ == "__main__":
    main()
