"""Exhaustive MIQP enumeration on the device: all 2^nb binary assignments
as one batched ADMM solve (σ-form ``admm_solve``) and an argmin.

Counterpart of ``pyhybridcontrol_tpu/solver/enumerate.py``; it doubles as
the on-device parity reference for the B&B engine.
"""

from __future__ import annotations

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.ops.admm import BIG, BoxQP, admm_solve
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.utils.select import first_arg


def _all_assignments(nb: int) -> np.ndarray:
    """(2^nb, nb) float array of all binary assignments."""
    codes = np.arange(2 ** nb, dtype=np.uint32)
    return ((codes[:, None] >> np.arange(nb)[None, :]) & 1).astype(np.float32)


def solve_miqp_enumerate_device(spec: BoxQP, qp: DeviceQP, f, h,
                                iters: int = 100, feas_tol: float = 1e-3):
    """Exact-enumeration MIQP. Returns (x*, obj*, bits*, feasible_mask);
    f/h from ``qp.assemble``."""
    assignments = torch.as_tensor(_all_assignments(qp.n_binary),
                                  device=f.device)
    bidx = torch.as_tensor(qp.binary_idx, dtype=torch.long, device=f.device)
    B = assignments.shape[0]
    lb = qp.lb.expand(B, qp.n).clone()
    ub = qp.ub.expand(B, qp.n).clone()
    lb[:, bidx] = assignments
    ub[:, bidx] = assignments
    res = admm_solve(spec, f.expand(B, qp.n), h.expand(B, qp.m), lb, ub,
                     iters=iters)
    feasible = res.r_prim_rel < feas_tol
    objs = torch.where(feasible, res.obj, BIG)
    k = first_arg(objs, largest=False)     # first minimum, as jnp.argmin
    return res.x[k], objs[k], assignments[k], feasible
