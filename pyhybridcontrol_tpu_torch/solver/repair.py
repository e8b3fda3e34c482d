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
step's candidates are one batched ``admm_solve``. A leading batch
dimension of B instances (the reference vmaps) runs each stage as one
(B·C, ·) ``admm_solve`` with a per-instance argmin and per-instance
state: no Python loop over instances. Not valid under move blocking.
Stage rows the controller softened (``soft_rows``) may be violated at a
penalty: they get slacks in the stage QP, and the seed fills the soft
frame's slack columns from the row violations (``layout="soft"``).
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
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyhybridcontrol_tpu_torch.utils.select import first_arg


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
    # soft-row handling (stage-local): hard-row mask + penalties
    hard_mask: torch.Tensor     # (nc,) bool — rows enforced exactly
    soft_lin: torch.Tensor      # (nc,) linear penalty (0 on hard rows)
    soft_quad: torch.Tensor     # (nc,)
    slack_lin: torch.Tensor     # (ns,) linear penalty in slack order
    proximity: float
    nbs: int
    n_slack: int


def prepare_repair(model: MldModel, weights: Optional[MpcWeights] = None,
                   proximity: float = 1.0, rho: float = 1.0,
                   max_step_binaries: int = 10,
                   soft_rows=None, soft_lin: float = 5.0,
                   soft_quad: float = 1.0,
                   device=DEFAULT_DEVICE) -> Optional[RepairSpec]:
    """Build the repair data; None if the model has no per-step binaries
    or too many to enumerate (2^nbs candidates).

    ``soft_rows``: stage-LOCAL constraint-row indices that the controller
    softened — the repair then allows (and penalizes) their violation
    too, instead of declaring such candidates infeasible."""
    device = resolve_device(device)
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

    nc = info.ncons
    soft = np.zeros(nc, dtype=bool)
    if soft_rows is not None:
        soft[np.asarray(list(soft_rows), int)] = True
    lam = np.where(soft, soft_lin, 0.0)
    mu = np.where(soft, soft_quad, 0.0)

    nw_c = int(cont_mask.sum())
    Rw = 2.0 * Rv[np.ix_(cont_mask, cont_mask)]
    u_cont_in_w = np.nonzero(np.arange(nv)[cont_mask] < info.nu)[0]
    for i in u_cont_in_w:
        Rw[i, i] += 2.0 * proximity
    # slack variables for the soft rows extend the stage QP
    ns = int(soft.sum()) if nw_c > 0 else 0
    if ns:
        Ssel = np.zeros((nc, ns))
        Ssel[np.nonzero(soft)[0], np.arange(ns)] = 1.0
        Rw_ext = np.zeros((nw_c + ns, nw_c + ns))
        Rw_ext[:nw_c, :nw_c] = Rw
        Rw_ext[nw_c:, nw_c:] = 2.0 * np.diag(mu[soft])
        admm = prepare_admm(np.hstack([F_cont, -Ssel]),
                            Rw_ext + 1e-6 * np.eye(nw_c + ns), rho=rho,
                            device=device)
    else:
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
        u_cont_idx=i64(u_cont_in_w),
        hard_mask=torch.as_tensor(~soft, device=device),
        soft_lin=f32(lam), soft_quad=f32(mu),
        slack_lin=f32(lam[soft] if ns else np.zeros(0)),
        proximity=float(proximity), nbs=nbs, n_slack=ns)


def repair_sequence(spec: RepairSpec, x0, u_ref_seq, W=None,
                    price_seq=None, qp_iters: int = 60,
                    feas_tol: float = 1e-3):
    """Greedy forward repair. x0 (nx,) and u_ref_seq (N, nu_c+nz), the
    target continuous parts (w-frame) — or both with a leading batch
    dimension B, with W (B, N, nω). Returns (v_seq (N, nv), ok) or their
    batched forms ((B, N, nv), (B,)). price_seq: (N, nv) per-step linear
    cost, shared by the batch."""
    single = x0.ndim == 1
    if single:
        x0, u_ref_seq = x0[None], u_ref_seq[None]
        W = None if W is None else W[None]
    B, N = u_ref_seq.shape[:2]
    C = spec.candidates.shape[0]
    nw_c = spec.Fw_cont.shape[1]
    nv = len(spec.cont_idx) + len(spec.bin_idx)
    dev = x0.device

    if W is None:
        W = torch.zeros((B, N, spec.B4.shape[1]), device=dev)
    if price_seq is None:
        price_seq = torch.zeros((N, nv), device=dev)
    # stage-QP box: free continuous parts, slacks ≥ 0
    nw_tot = nw_c + spec.n_slack
    hi = torch.full((nw_tot,), BIG, device=dev)
    lo = -hi
    lo[nw_c:] = 0.0
    cand = spec.candidates
    inst = torch.arange(B, device=dev)

    x = x0
    vs, oks = [], []
    for k in range(N):
        u_ref, w_k, price = u_ref_seq[:, k], W[:, k], price_seq[k]
        # rhs per candidate: f5 − E x − F4 ω − F_bin δc
        base = spec.f5 - x @ spec.E.T - w_k @ spec.F4.T          # (B, nc)
        h = base[:, None, :] - cand @ spec.F2E.T                 # (B, C, nc)
        if nw_c == 0:
            # all-binary stage: no stage QP — hard rows checked exactly,
            # soft rows penalized
            viol = torch.clamp_min(-h, 0.0)                      # (B, C, nc)
            feas = torch.where(spec.hard_mask, h >= -feas_tol,
                               True).all(dim=-1)
            cont_obj = viol @ spec.soft_lin + (viol * viol) @ spec.soft_quad
            w_sol = h.new_zeros((B, C, 0))
        else:
            qv = torch.zeros((B, nw_c), device=dev)
            qv[:, spec.u_cont_idx] = u_ref[:, spec.u_cont_idx]
            q = -2.0 * spec.proximity * qv + spec.rw + price[spec.cont_idx]
            if spec.n_slack:
                q = torch.cat([q, spec.slack_lin.expand(B, -1)], dim=1)
            res = admm_solve(
                spec.admm,
                q[:, None, :].expand(B, C, nw_tot).reshape(-1, nw_tot),
                h.reshape(B * C, -1), lo, hi, iters=qp_iters)
            feas = (res.r_prim_rel < feas_tol).view(B, C)
            cont_obj = res.obj.view(B, C)
            w_sol = res.x[:, :nw_c].view(B, C, nw_c)
        bin_cost = cand @ (spec.r_bin + price[spec.bin_idx])     # (C,)
        # one-step-lookahead state cost per candidate
        x_next_c = ((x @ spec.A.T)[:, None, :] + w_sol @ spec.B_cont.T
                    + cand @ spec.B_bin.T
                    + (w_k @ spec.B4.T)[:, None, :] + spec.b5)
        la = (((x_next_c @ spec.Qx_la) * x_next_c).sum(-1)
              + x_next_c @ spec.qx_la)
        total = torch.where(feas, cont_obj + bin_cost + la, BIG)
        j = first_arg(total, dim=1, largest=False)   # first min, as argmin
        wk, ck = w_sol[inst, j], cand[j]
        v = torch.zeros((B, nv), device=dev)
        v[:, spec.cont_idx] = wk
        v[:, spec.bin_idx] = ck
        x = (x @ spec.A.T + wk @ spec.B_cont.T + ck @ spec.B_bin.T
             + w_k @ spec.B4.T + spec.b5)
        vs.append(v)
        oks.append(feas[inst, j])
    v_seq, ok = torch.stack(vs, dim=1), torch.stack(oks, dim=1).all(dim=1)
    return (v_seq[0], ok[0]) if single else (v_seq, ok)


def root_repair_incumbent(admm, qp, rspec: RepairSpec, x0, f, h,
                          W=None, price_seq=None, qp_iters: int = 150,
                          layout: str = "plain", feas_tol: float = 1e-3,
                          stage_iters: int = 150):
    """Root relaxation + greedy repair → B&B incumbent seed
    ``(obj, V, ok)`` in the solver's decision frame. x0, f, h (and W) may
    carry a leading batch dimension: the seeds of B instances at once.

    ``layout``: "plain" (decision == full per-step v) or "soft" (decision
    == [v_flat; slacks], slacks filled from the row violations). Move-
    blocked problems cannot be seeded this way (repaired sequences are not
    blocked): callers must not ask for a repair there."""
    if layout not in ("plain", "soft"):
        raise ValueError(f"repair cannot seed layout {layout!r}")
    relax = admm_solve(admm, f, h, qp.lb, qp.ub, iters=qp_iters)
    v_seq_rel = qp.full_v(relax.x)                      # (..., N, nv)
    u_ref = v_seq_rel[..., rspec.cont_idx]
    v_seq, ok = repair_sequence(rspec, x0, u_ref, W=W, price_seq=price_seq,
                                qp_iters=stage_iters, feas_tol=feas_tol)
    V = v_seq.reshape(v_seq.shape[:-2] + (-1,))
    if layout == "soft":
        # soft rows carry −I on the slack block: s_r = max(0, violation)
        nvf = V.shape[-1]
        viol = torch.clamp_min(V @ qp.G[:, :nvf].T - h, 0.0)
        V = torch.cat([V, viol @ -qp.G[:, nvf:]], dim=-1)
    # validate against the FULL constraint system (incl. horizon-coupled
    # rows the per-step repair does not see)
    resid = (V @ qp.G.T - h).amax(dim=-1)
    ok = ok & (resid <= feas_tol)
    obj = 0.5 * (V * (V @ qp.H.T)).sum(-1) + (f * V).sum(-1)
    return obj, V, ok
