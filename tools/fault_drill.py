"""Fault drill of the multi-rank closed loop: a study whose every control
step solves its MIQP with the B&B pool sharded over two ranks
(parallel/sharded_bnb.py) loses rank 1 mid-study, and a relaunch resumes
from the per-step checkpoint (io/checkpoint.py).

    python tools/fault_drill.py [--device cuda|cpu]

Three runs of the N=6 switched double integrator from [2, 0], T=5 steps,
capacity 64 and wave 8 per rank, 400 iterations (the reference's
scripts/fault_injection.py): an uninterrupted two-rank study; the same
study with rank 1 exiting (code 17) after step 2, whose launcher reports
the lost rank and kills the survivor; a relaunch that resumes from the
checkpoint rank 0 wrote after step 2. The resumed trajectory must equal
the uninterrupted one bitwise (the sharded solve is deterministic), and
its final state must be within 1e-3 of a single-process study through the
unsharded loop (the reference's hold; the two searches differ). Prints
PASS and exits 0, or exits 1. The ranks run on the card (over gloo where
they share one), or over gloo on the CPU with ``--device cpu``, where it
takes about 30 s.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

T_TOTAL = 5
FAULT_STEP = 2
FAULT_CODE = 17
SPEC = dict(capacity=64, wave_size=8, qp_iters=400)
X0 = (2.0, 0.0)


def build(device):
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    model = switched_double_integrator().to(device)
    c = CondensedMpc(model, 6, default_weights())
    return model, c.device_qp(device), prepare_admm_mpc(c, device=device)


def advance(model, qp, x, res):
    """The plant's next state under the plan's first input."""
    info = model.info
    v0 = qp.full_v(res.x)[0]
    return model.step(x, v0[info.u_slice], v0[info.delta_slice],
                      v0[info.z_slice])


def study(ckpt: str, device_type: str, fault: bool, resume: bool):
    """Rank body: the two-rank study, resumed from ``ckpt`` when asked;
    returns the trajectory (T+1, nx) as a host array."""
    import torch
    import torch.distributed as dist

    from pyhybridcontrol_tpu_torch.io.checkpoint import (
        load_checkpoint, save_checkpoint)
    from pyhybridcontrol_tpu_torch.parallel import make_mesh
    from pyhybridcontrol_tpu_torch.parallel.mesh import rank_device
    from pyhybridcontrol_tpu_torch.parallel.sharded_bnb import (
        solve_miqp_bnb_sharded)
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    rank = dist.get_rank()
    dev = rank_device(rank, device_type)
    model, qp, admm = build(dev)
    mesh = make_mesh([("pool", 2)], device_type)
    traj = torch.zeros(T_TOTAL + 1, 2, device=dev)
    traj[0] = torch.tensor(X0)
    k0 = 0
    if resume:
        # rank 0's file (``…-proc000``): every rank resumes from it
        (traj,), k0, _ = load_checkpoint(ckpt, (traj,), process_index=0)
        print(f"[rank {rank}] resuming from step {k0}", flush=True)
    for k in range(k0, T_TOTAL):
        f, h = qp.assemble(traj[k])
        res = solve_miqp_bnb_sharded(admm, qp, f, h, BnbSpec(**SPEC), mesh)
        traj[k + 1] = advance(model, qp, traj[k], res)
        if rank == 0:
            save_checkpoint(ckpt, (traj,), step=k + 1, process_index=0)
        dist.barrier()            # the step's checkpoint is on disk
        if fault and rank == 1 and k + 1 == FAULT_STEP:
            print(f"[rank 1] exiting after step {k + 1}", flush=True)
            os._exit(FAULT_CODE)
    return traj.cpu().numpy()


def single_process(device):
    """The same study in this process through the unsharded loop."""
    import torch

    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

    model, qp, admm = build(device)
    x = torch.tensor(X0, device=device)
    for _ in range(T_TOTAL):
        f, h = qp.assemble(x)
        x = advance(model, qp, x, solve_miqp_bnb(admm, qp, f, h,
                                                 BnbSpec(**SPEC)))
    return x.cpu().numpy()


def main(argv=None) -> int:
    import numpy as np

    from pyhybridcontrol_tpu_torch.parallel import RankFailed, spawn

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="fault_drill_") as tmp:
        ref = spawn(study, 2, (os.path.join(tmp, "ref.ckpt"), args.device,
                               False, False), args.device, timeout=300)[0]
        ckpt = os.path.join(tmp, "study.ckpt")
        try:
            spawn(study, 2, (ckpt, args.device, True, False), args.device,
                  timeout=300)
            print("the fault was not injected", flush=True)
            return 1
        except RankFailed as e:
            print(f"lost rank 1 as planned (exit codes {e.exitcodes})",
                  flush=True)
            if e.exitcodes.get(1) != FAULT_CODE:
                return 1
        from pyhybridcontrol_tpu_torch.io.checkpoint import load_checkpoint

        _, step, _ = load_checkpoint(ckpt, process_index=0)
        print(f"checkpoint at step {step}", flush=True)
        if step != FAULT_STEP:
            return 1
        resumed = spawn(study, 2, (ckpt, args.device, False, True),
                        args.device, timeout=300)[0]
    single = single_process(args.device)
    same = bool(np.array_equal(resumed, ref))
    near = bool(np.max(np.abs(resumed[-1] - single)) <= 1e-3)
    print(f"resumed final {resumed[-1].tolist()}, uninterrupted "
          f"{ref[-1].tolist()} (bitwise equal: {same}), single process "
          f"{single.tolist()} (within 1e-3: {near})", flush=True)
    print("PASS" if same and near else "FAIL", flush=True)
    return 0 if same and near else 1


if __name__ == "__main__":
    sys.exit(main())
