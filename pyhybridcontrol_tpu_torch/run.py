"""CLI runner:  python -m pyhybridcontrol_tpu_torch.run --config <name>
[--steps T] [--batch B] [--log out.jsonl] [--checkpoint ckpt.bin]
[--checkpoint-every K] [--resume] [--solver bnb|enumerate]
[--device cuda|cpu]

Counterpart of ``pyhybridcontrol_tpu/run.py``. Runs one benchmark config
end to end on ``--device`` (default ``cuda``; without a card it exits
non-zero, it never carries on on the CPU) and prints one JSON line of
metrics; optionally writes a JSONL log (single-state studies) and a final
checkpoint of the result. The controller takes the config's soft rows,
its move blocking and, for ``thermal_uc``, the min-up rows, as the
reference's runner does (the serving loop applies no blocking).

Three branches, as in the reference:

* one state (B = 1): one closed loop of T steps from a seeded state; the
  line carries ``ms_per_control_step``, ``found_frac``, ``total_cost``,
  ``mean_nodes``;
* long studies: ``--checkpoint ckpt --checkpoint-every K`` snapshots the
  loop state (x, u_prev, the carried plan and whether it was found) every
  K control steps; re-running with ``--resume`` continues from the
  snapshot on the trajectory of the uninterrupted study (the line carries
  ``resumed_from``), and a study already complete is a no-op;
* B > 1 (``--batch`` or the config's batch): B seeded states in one
  batched closed loop. The reference vmaps the single-state loop, so each
  instance runs its own search with the config's ``wave_size``,
  ``capacity`` and ``max_waves``. Here the B instances share ONE pooled
  B&B (solver/bnb_pooled.py): the global wave is B·wave_size, the pool
  B·capacity slots and the wave cap stays ``max_waves``, so each instance
  keeps its node budget while every wave is one K2 launch over all of
  them. The line adds ``global_wave``, ``pool_slots`` and ``pool_bytes``
  (the pool's packed node and meta rows). ``--solver enumerate`` batches
  the enumeration over the B states.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="pyhybridcontrol_tpu_torch.run")
    ap.add_argument("--config", required=True)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--solver", default="bnb",
                    choices=["bnb", "enumerate"])
    ap.add_argument("--log", default=None)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="snapshot loop state every K steps (needs "
                         "--checkpoint; enables --resume)")
    ap.add_argument("--resume", action="store_true",
                    help="continue from the --checkpoint snapshot")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap.parse_args(argv)


def pool_bytes(P: int, n_binary: int, n: int, m_total: int) -> int:
    """Bytes of a pooled search's node pool: ``P`` slots plus the dump
    row, each a packed node row (fix-encodings, x, z, y: nb + n + 2·mt
    fp32) and a meta row (8 fp32) — solver/bnb_pooled.py's layout."""
    return 4 * (P + 1) * (n_binary + n + 2 * m_total + 8)


def build_controller(cfg, solver: str, device):
    """The config's controller on ``device``, built: its soft rows
    (penalties 5.0 linear, 1.0 quadratic), its move blocking and, for
    thermal_uc, the min-up rows of two steps."""
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.models.dewh import min_up_down_rows

    model, ckw = cfg.build()
    ctrl = MpcController(model, cfg.N, solver=solver, bnb_spec=cfg.bnb,
                         qp_iters=cfg.bnb.qp_iters, device=device, **ckw)
    if cfg.soft_rows:
        ctrl.set_soft_constraints(list(cfg.soft_rows), lin_pen=5.0,
                                  quad_pen=1.0)
    if cfg.move_blocking:
        ctrl.set_move_blocking(list(cfg.move_blocking))
    if cfg.name == "thermal_uc":
        A_v, b = min_up_down_rows(cfg.N, model.info.nv, min_up=2)
        if len(b):
            ctrl.set_extra_constraints(A_v, b)
    return ctrl.build()


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_study(args):
    """Run the study ``args`` asks for. Returns (metrics dict, result):
    the ClosedLoopResult, or None for a resumed study already complete."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.configs import get_config
    from pyhybridcontrol_tpu_torch.loop import (
        closed_loop, closed_loop_batch, make_mpc_step, make_mpc_step_batch)

    cfg = get_config(args.config)
    T = args.steps or cfg.T
    B = args.batch or cfg.batch
    ctrl = build_controller(cfg, args.solver, args.device)
    model, dev = ctrl.model, ctrl.device
    qp, admm = ctrl.device_qp, ctrl.admm

    rng = np.random.default_rng(0)
    nx = model.info.nx
    if cfg.name.startswith("thermal"):
        x0 = np.tile([55.0, 0.0], nx // 2)[:nx]
    else:
        x0 = rng.uniform(-2, 2, size=nx)
    x0 = np.asarray(x0, np.float32)

    t0 = time.perf_counter()
    if B > 1:
        x0s = rng.uniform(-2, 2, size=(B, nx)).astype(np.float32)
        P = B * cfg.bnb.capacity
        pspec = dataclasses.replace(cfg.bnb, wave_size=B * cfg.bnb.wave_size,
                                    capacity=P)
        step = make_mpc_step_batch(
            model, qp, admm, bnb_spec=pspec, pool_slots=P,
            admm_probe=ctrl.admm_probe, method=args.solver,
            qp_iters=cfg.bnb.qp_iters, repair=ctrl.repair)
        res = closed_loop_batch(model, step, x0s, T)
        _sync(dev)
        wall = time.perf_counter() - t0
        metrics = {
            "config": cfg.name, "batch": B, "steps": T,
            "wall_s": round(wall, 3),
            "miqp_solves_per_s": round(B * T / wall, 1),
            "found_frac": float(res.found.float().mean()),
        }
        if args.solver == "bnb":
            metrics.update(global_wave=pspec.wave_size, pool_slots=P,
                           pool_bytes=pool_bytes(P, qp.n_binary, qp.n,
                                                 admm.m_total))
        return metrics, res

    info = model.info
    step = make_mpc_step(model, qp, admm, method=args.solver,
                         bnb_spec=cfg.bnb, qp_iters=cfg.bnb.qp_iters,
                         repair=ctrl.repair, admm_probe=ctrl.admm_probe)
    if not (args.checkpoint_every and args.checkpoint):
        res = closed_loop(model, step, x0, T)
        _sync(dev)
        wall = time.perf_counter() - t0
        return {
            "config": cfg.name, "steps": T, "wall_s": round(wall, 3),
            "ms_per_control_step": round(1e3 * wall / T, 2),
            "found_frac": float(res.found.float().mean()),
            "total_cost": float(res.objs.double().sum()),
            "mean_nodes": float(res.nodes.double().mean()),
        }, res

    from pyhybridcontrol_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)
    from pyhybridcontrol_tpu_torch.loop.closed_loop import ClosedLoopResult

    n_plan = step.n_dec if step.carries_plan else 0
    k0, u_prev, plan = 0, None, None
    if args.resume and os.path.exists(args.checkpoint):
        target = {"u_prev": torch.zeros(info.nu),
                  "x": torch.zeros(info.nx),
                  "plan": torch.zeros(n_plan),
                  "plan_ok": torch.tensor(False)}
        state, k0, _meta = load_checkpoint(args.checkpoint, target)
        x0, u_prev = state["x"], state["u_prev"]
        if n_plan:
            plan = (state["plan"], state["plan_ok"])
    if k0 >= T:
        return {"config": cfg.name, "steps": 0, "resumed_from": k0,
                "note": "study already complete"}, None
    chunks = []
    k = k0
    while k < T:
        kk = min(args.checkpoint_every, T - k)
        r = closed_loop(model, step, x0, kk, u_prev0=u_prev, prev_plan=plan)
        chunks.append(r)
        x0 = r.xs[-1]
        u_prev = r.vs[-1][info.u_slice]
        if n_plan:
            plan = (r.plan, r.plan_ok)
        k += kk
        save_checkpoint(args.checkpoint,
                        {"u_prev": u_prev, "x": x0, "plan": r.plan,
                         "plan_ok": r.plan_ok}, step=k,
                        metadata={"config": cfg.name, "T": T})
    res = ClosedLoopResult(
        xs=torch.cat([chunks[0].xs] + [r.xs[1:] for r in chunks[1:]]),
        vs=torch.cat([r.vs for r in chunks]),
        ys=torch.cat([r.ys for r in chunks]),
        objs=torch.cat([r.objs for r in chunks]),
        found=torch.cat([r.found for r in chunks]),
        nodes=torch.cat([r.nodes for r in chunks]),
        plan=chunks[-1].plan, plan_ok=chunks[-1].plan_ok)
    _sync(dev)
    wall = time.perf_counter() - t0
    return {
        "config": cfg.name, "steps": T - k0, "resumed_from": k0,
        "wall_s": round(wall, 3),
        "found_frac": float(res.found.float().mean()),
        "total_cost": float(res.objs.double().sum()),
        "mean_nodes": float(res.nodes.double().mean()),
    }, res


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("pyhybridcontrol_tpu_torch.run: --device cuda but no "
                  "CUDA device is available (use --device cpu to run on "
                  "the CPU)", file=sys.stderr)
            return 2
    from pyhybridcontrol_tpu_torch.configs import BENCHMARK_CONFIGS

    if args.config not in BENCHMARK_CONFIGS:
        print(f"pyhybridcontrol_tpu_torch.run: unknown config "
              f"{args.config!r}; available: {sorted(BENCHMARK_CONFIGS)}",
              file=sys.stderr)
        return 2
    metrics, res = run_study(args)
    print(json.dumps(metrics), flush=True)
    if res is None:
        return 0
    if args.log:
        from pyhybridcontrol_tpu_torch.io.logging import StructuredLog

        log = StructuredLog(args.log, run_name=args.config)
        if res.xs.ndim == 2:               # one state, not a batch
            log.log_closed_loop(res)
        log.close()
    if args.checkpoint and not args.checkpoint_every:
        # (with --checkpoint-every the file holds the RESUME snapshot,
        # which the result must not overwrite)
        from pyhybridcontrol_tpu_torch.io.checkpoint import save_checkpoint

        save_checkpoint(args.checkpoint, res, step=metrics["steps"],
                        metadata={"config": args.config})
    return 0


if __name__ == "__main__":
    sys.exit(main())
