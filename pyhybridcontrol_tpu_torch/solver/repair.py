"""Greedy rollout-repair incumbent heuristic for the MIQP engine.

Counterpart of ``pyhybridcontrol_tpu/solver/repair.py``: simulate the
trajectory forward; at each step k enumerate the 2^{nb_step} per-step
binary patterns and solve, for each, a tiny stage QP in the continuous
variables (u, z)

    min ‖u − ū_k‖² + stage_cost(u, δ, z)
    s.t. E x_k + F1 u + F2 δ + F3 z + F4 ω_k ≤ f5,  u ∈ box

where ū_k is the relaxation's continuous input and x_k the exact state
reached so far; the best feasible candidate (scored with a one-step
state-cost lookahead) advances the state. The result satisfies every
stage constraint and is offered to the B&B as an incumbent. The
reference's ``lax.scan`` over the horizon is a Python loop here; each
step's candidates are one batched ``admm_solve``. Not valid under move
blocking. The reference's soft-row variant waits for the soft-constraint
transform (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import (
    BIG,
    BoxQP,
    admm_solve,
    prepare_admm,
)
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights, _sq, _vec


@dataclasses.dataclass
class RepairSpec:
    """Prepared per-model repair data (fp32 tensors on one device)."""

    admm: BoxQP                 # stage QP over w = [u; z]
    candidates: torch.Tensor    # (2^nbs, nbs) binary patterns
    F2E: torch.Tensor           # (nc, nbs) binary columns of [F1_b | F2]
    Fw_cont: torch.Tensor       # (nc, nu_c + nz) continuous columns
    E: torch.Tensor             # (nc, nx)
    F4: torch.Tensor            # (nc, nw)
    f5: torch.Tensor            # (nc,)
    A: torch.Tensor
    B_cont: torch.Tensor        # (nx, nu_c + nz)
    B_bin: torch.Tensor         # (nx, nbs)
    B4: torch.Tensor
    b5: torch.Tensor
    Rw: torch.Tensor            # (nw_c, nw_c) quad on w
    rw: torch.Tensor            # (nw_c,)
    r_bin: torch.Tensor         # (nbs,) linear cost of binaries
    Qx_la: torch.Tensor         # (nx, nx) one-step-lookahead state weight
    qx_la: torch.Tensor         # (nx,) lookahead linear (incl x_ref)
    cont_idx: torch.Tensor      # (nu_c + nz,) positions in v
    bin_idx: torch.Tensor       # (nbs,) positions in v
    u_cont_idx: torch.Tensor    # (nu_c,) positions of continuous u in w
    proximity: float
    nbs: int


def prepare_repair(model: MldModel, weights: Optional[MpcWeights] = None,
                   proximity: float = 1.0, rho: float = 1.0,
                   max_step_binaries: int = 10,
                   device="cpu") -> Optional[RepairSpec]:
    """Build the repair data; None if the model has no per-step binaries
    or too many to enumerate (2^nbs candidates)."""
    w = weights or MpcWeights()
    info = model.info
    m = model.numpy_mats()
    nbs = info.nv_binary
    if nbs == 0 or nbs > max_step_binaries:
        return None
    vb = info.v_binary_mask
    cont_mask = ~vb
    nv = info.nv

    Fv = np.hstack([m.F1, m.F2, m.F3])
    Bv = np.hstack([m.B1, m.B2, m.B3])
    F_bin, F_cont = Fv[:, vb], Fv[:, cont_mask]
    B_bin, B_cont = Bv[:, vb], Bv[:, cont_mask]

    # stage cost over v (same convention as condense: J = vᵀRv + rᵀv)
    Rv = np.zeros((nv, nv))
    Rv[info.u_slice, info.u_slice] = _sq(w.Ru, info.nu)
    Rv[info.delta_slice, info.delta_slice] = _sq(w.Qdelta, info.ndelta)
    Rv[info.z_slice, info.z_slice] = _sq(w.Rz, info.nz)
    rv = np.concatenate([_vec(w.ru, info.nu), _vec(w.qdelta, info.ndelta),
                         _vec(w.rz, info.nz)])
    # one-step lookahead: score candidates by x_{k+1}ᵀQx x_{k+1} too
    Qx_la = _sq(w.Qx, info.nx)
    qx_la = _vec(w.qx, info.nx)
    if w.x_ref is not None:
        qx_la = qx_la - 2.0 * (Qx_la @ _vec(w.x_ref, info.nx))

    nw_c = int(cont_mask.sum())
    Rw = 2.0 * Rv[np.ix_(cont_mask, cont_mask)]
    u_cont_in_w = np.nonzero(np.arange(nv)[cont_mask] < info.nu)[0]
    for i in u_cont_in_w:
        Rw[i, i] += 2.0 * proximity
    admm = prepare_admm(F_cont, Rw + 1e-6 * np.eye(nw_c), rho=rho,
                        device=device)

    codes = np.arange(2 ** nbs, dtype=np.uint32)
    cand = ((codes[:, None] >> np.arange(nbs)[None, :]) & 1
            ).astype(np.float32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    def i64(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.long,
                               device=device)

    return RepairSpec(
        admm=admm, candidates=f32(cand), F2E=f32(F_bin), Fw_cont=f32(F_cont),
        E=f32(m.E), F4=f32(m.F4), f5=f32(m.f5[:, 0]), A=f32(m.A),
        B_cont=f32(B_cont), B_bin=f32(B_bin), B4=f32(m.B4),
        b5=f32(m.b5[:, 0]), Rw=f32(Rw), rw=f32(rv[cont_mask]),
        r_bin=f32(rv[vb]), Qx_la=f32(Qx_la), qx_la=f32(qx_la),
        cont_idx=i64(np.nonzero(cont_mask)[0]), bin_idx=i64(np.nonzero(vb)[0]),
        u_cont_idx=i64(u_cont_in_w), proximity=float(proximity), nbs=nbs)


def repair_sequence(spec: RepairSpec, x0, u_ref_seq, W=None,
                    price_seq=None, qp_iters: int = 60,
                    feas_tol: float = 1e-3):
    """Greedy forward repair. u_ref_seq: (N, nu_c+nz) target continuous
    parts (w-frame). Returns (v_seq (N, nv), ok (bool tensor)).
    price_seq: (N, nv) per-step linear cost."""
    N = u_ref_seq.shape[0]
    C = spec.candidates.shape[0]
    nw_c = spec.Fw_cont.shape[1]
    nv = len(spec.cont_idx) + len(spec.bin_idx)
    dev = x0.device

    if W is None:
        W = torch.zeros((N, spec.B4.shape[1]), device=dev)
    if price_seq is None:
        price_seq = torch.zeros((N, nv), device=dev)
    free = torch.full((C, nw_c), BIG, device=dev)
    cand = spec.candidates

    x = x0
    vs, oks = [], []
    for k in range(N):
        u_ref, w_k, price = u_ref_seq[k], W[k], price_seq[k]
        # rhs per candidate: f5 − E x − F4 ω − F_bin δc
        base = spec.f5 - spec.E @ x - spec.F4 @ w_k
        h = base[None, :] - cand @ spec.F2E.T                    # (C, nc)
        if nw_c == 0:
            # all-binary stage: no stage QP, rows checked exactly
            feas = (h >= -feas_tol).all(dim=-1)
            cont_obj = h.new_zeros(C)
            w_sol = h.new_zeros((C, 0))
        else:
            qv = torch.zeros(nw_c, device=dev)
            qv[spec.u_cont_idx] = u_ref[spec.u_cont_idx]
            q = -2.0 * spec.proximity * qv + spec.rw + price[spec.cont_idx]
            res = admm_solve(spec.admm, q.expand(C, nw_c), h, -free, free,
                             iters=qp_iters)
            feas = res.r_prim_rel < feas_tol
            cont_obj = res.obj
            w_sol = res.x[:, :nw_c]
        bin_cost = cand @ (spec.r_bin + price[spec.bin_idx])
        # one-step-lookahead state cost per candidate
        x_next_c = ((spec.A @ x)[None, :] + w_sol @ spec.B_cont.T
                    + cand @ spec.B_bin.T
                    + (spec.B4 @ w_k)[None, :] + spec.b5[None, :])
        la = (((x_next_c @ spec.Qx_la) * x_next_c).sum(-1)
              + x_next_c @ spec.qx_la)
        total = torch.where(feas, cont_obj + bin_cost + la, BIG)
        j = torch.argmin(total)
        wk, ck = w_sol[j], cand[j]
        v = torch.zeros(nv, device=dev)
        v[spec.cont_idx] = wk
        v[spec.bin_idx] = ck
        x = (spec.A @ x + spec.B_cont @ wk + spec.B_bin @ ck
             + spec.B4 @ w_k + spec.b5)
        vs.append(v)
        oks.append(feas[j])
    return torch.stack(vs), torch.stack(oks).all()


def root_repair_incumbent(admm, qp, rspec: RepairSpec, x0, f, h,
                          W=None, price_seq=None, qp_iters: int = 150,
                          feas_tol: float = 1e-3, stage_iters: int = 150):
    """Root relaxation + greedy repair → B&B incumbent seed
    ``(obj, V, ok)``; the decision V is the full per-step v sequence."""
    relax = admm_solve(admm, f, h, qp.lb, qp.ub, iters=qp_iters)
    v_seq_rel = qp.full_v(relax.x)                      # (N, nv)
    u_ref = v_seq_rel[:, rspec.cont_idx]
    v_seq, ok = repair_sequence(rspec, x0, u_ref, W=W, price_seq=price_seq,
                                qp_iters=stage_iters, feas_tol=feas_tol)
    V = v_seq.reshape(-1)
    # validate against the FULL constraint system
    resid = (qp.G @ V - h).max()
    ok = ok & (resid <= feas_tol)
    obj = 0.5 * torch.dot(V, qp.H @ V) + torch.sum(f * V)
    return obj, V, ok
