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
    f/h from ``qp.assemble``. A leading batch axis on f/h, (B, n) and
    (B, m), enumerates B instances in one batched solve of B·2^nb QPs;
    every result then carries it."""
    assignments = torch.as_tensor(_all_assignments(qp.n_binary),
                                  device=f.device)
    bidx = torch.as_tensor(qp.binary_idx, dtype=torch.long, device=f.device)
    K = assignments.shape[0]
    lead = tuple(f.shape[:-1])
    B = int(np.prod(lead, dtype=np.int64))
    lb = qp.lb.expand(K, qp.n).clone()
    ub = qp.ub.expand(K, qp.n).clone()
    lb[:, bidx] = assignments
    ub[:, bidx] = assignments
    fb = f.reshape(B, 1, qp.n).expand(B, K, qp.n).reshape(B * K, qp.n)
    hb = h.reshape(B, 1, qp.m).expand(B, K, qp.m).reshape(B * K, qp.m)
    res = admm_solve(spec, fb, hb, lb.repeat(B, 1), ub.repeat(B, 1),
                     iters=iters)
    feasible = (res.r_prim_rel < feas_tol).reshape(lead + (K,))
    objs = torch.where(feasible, res.obj.reshape(lead + (K,)), BIG)
    k = first_arg(objs, largest=False)     # first minimum, as jnp.argmin
    x = res.x.reshape(lead + (K, qp.n))
    pick = k[..., None, None].expand(lead + (1, qp.n))
    return (torch.gather(x, -2, pick)[..., 0, :],
            torch.gather(objs, -1, k[..., None])[..., 0], assignments[k],
            feasible)
