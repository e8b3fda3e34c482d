"""Wave-parallel branch-and-bound MIQP engine on the device.

Counterpart of ``pyhybridcontrol_tpu/solver/bnb.py`` (``BnbSpec``,
``CondensedBackend``, ``_bnb_loop``, ``solve_miqp_bnb``). A fixed-capacity
node pool with an active mask; each wave

  1. selects the W best-bound active nodes,
  2. solves their relaxations AND the dive probes (binaries fixed to the
     rounded relaxation) in one K2 launch (ops/cuda_admm.py),
  3. clamps each feasible probe with its certified dual bound and takes
     the best as incumbent,
  4. prunes (infeasible / bound ≥ incumbent − gap / integral / leaf),
     fixes binaries from the Falk certificate (node presolve),
  5. branches the survivors by pseudo-cost: child-0 overwrites the parent
     slot, child-1 takes a free slot (best-bound children win on
     overflow, which is reported).

Port decisions:
- The reference runs the wave loop as one ``lax.while_loop``. Here it is
  a Python loop with ONE host read per wave (the ``alive`` continue
  test); everything else stays on the device. CUDA graphs of a
  wave come later.
- JAX scatters drop out-of-bounds indices (``mode="drop"``); torch does
  not. Every pool tensor has a dump row at index ``capacity`` (the
  pseudo-cost tables one at index ``nb``): dropped writes land there and
  the dump row is never selected.
- ``lax.top_k`` breaks ties by the lower index and ``jnp.argsort`` is
  stable; the port selects with ``torch.sort(..., stable=True)`` and
  slices, so CPU and CUDA runs search alike.
- The pool is updated in place (the loop owns it).
- The search runs config 1's options: pseudo-cost branching, the
  certificate-backed node presolve (``presolve_fix``), warm starts,
  flip-delta child bounds and an always-on dive probe. Any other
  ``BnbSpec`` setting raises ``NotImplementedError``; the multi-device
  hooks wait for ROADMAP queue 1, item 8.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pyhybridcontrol_tpu_torch.ops.admm import (
    BIG,
    BoxQP,
    admm_dual_bound,
    admm_node_cert,
)
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
    admm_solve_auto,
    admm_wave_auto,
)


@dataclasses.dataclass
class CondensedBackend:
    """Condensed DeviceQP + batched ADMM. ``admm_probe``: optional stiff-ρ
    prep (same Ruiz frame) for the first half of every dive probe."""

    admm: BoxQP
    qp: DeviceQP
    admm_probe: Optional[BoxQP] = None

    def __post_init__(self):
        # warm starts pass between the two preps: both must equilibrate the
        # same (H, A, q0)
        a, p = self.admm, self.admm_probe
        if p is not None and not (
                a.n == p.n and a.m_ineq == p.m_ineq
                and all(torch.equal(getattr(a, k), getattr(p, k))
                        for k in ("A", "E", "D", "cost_scale"))):
            raise ValueError("the probe prep does not share the base "
                             "prep's Ruiz frame")

    @property
    def n(self):
        return self.qp.n

    @property
    def lb(self):
        return self.qp.lb

    @property
    def ub(self):
        return self.qp.ub

    @property
    def binary_idx(self):
        return self.qp.binary_idx

    @property
    def warm_size(self):
        return self.admm.m_total

    def solve(self, f, h, lb, ub, iters, warm=None):
        return admm_solve_auto(self.admm, f, h, lb, ub, iters=iters,
                               warm=warm)

    def solve_wave(self, f, h, lb, ub, iters, probe_iters, warm=None):
        """Fused relaxation + dive probe (K2). Returns
        ``(relax, probe, lb_probe, ub_probe)``."""
        return admm_wave_auto(self.admm, self.admm_probe, self.binary_idx,
                              f, h, lb, ub, iters=iters,
                              probe_iters=probe_iters, warm=warm)

    def node_bound(self, res, f, h, lb, ub):
        return admm_dual_bound(self.admm, f, h, lb, ub, res)

    def node_cert(self, res, f, h, lb, ub):
        return admm_node_cert(self.admm, f, h, lb, ub, res, self.binary_idx)

    def broadcast_data(self, f, h, W):
        return f.expand(W, -1), h.expand(W, -1)


@dataclasses.dataclass(frozen=True)
class BnbSpec:
    """Static B&B configuration (fields and defaults as in the reference;
    see its docstrings for each option)."""

    capacity: int = 512          # node-pool slots
    wave_size: int = 64          # nodes relaxed per wave
    max_waves: int = 64
    qp_iters: int = 100
    feas_tol: float = 1e-3       # "converged" primal-residual tolerance
    infeas_tol: float = 0.5      # residual fallback for "clearly infeasible"
    int_tol: float = 1e-3        # integrality tolerance on relaxed binaries
    gap: float = 1e-4            # absolute pruning gap margin
    inc_tol: float = 0.0         # incumbent acceptance tolerance; 0 → feas_tol
    probe_iters: int = 0         # dive-probe iterations; 0 → qp_iters
    # the reference's other options; only their defaults are ported
    warm_start: bool = True      # children inherit parent ADMM iterates
    rel_gap: float = 0.0         # relative MIPGap termination
    probe_patience: int = 0      # probe gating
    branching: str = "pseudocost"
    presolve_fix: bool = True    # certificate-backed node presolve
    pool_norm: str = "none"      # pooled engine only
    depth_tiebreak: float = 0.0
    sb_iters: int = 0            # root strong branching
    sb_fix: bool = False
    dive_slots: int = 0          # diving lane
    root_iters: int = 0          # root pre-solve

    def __post_init__(self):
        if self.wave_size > self.capacity:
            raise ValueError(
                f"wave_size ({self.wave_size}) cannot exceed pool "
                f"capacity ({self.capacity})")
        if self.capacity < 2 or self.wave_size < 1:
            raise ValueError("need capacity >= 2 and wave_size >= 1")
        if self.branching not in ("pseudocost", "most_frac", "flipdelta"):
            raise ValueError(f"unknown branching {self.branching!r}")
        if self.rel_gap < 0 or self.probe_patience < 0:
            raise ValueError("rel_gap and probe_patience must be >= 0")
        if self.sb_iters < 0:
            raise ValueError("sb_iters must be >= 0")
        if self.depth_tiebreak < 0:
            raise ValueError("depth_tiebreak must be >= 0")
        if not 0 <= self.dive_slots < self.wave_size:
            raise ValueError("need 0 <= dive_slots < wave_size")
        if self.pool_norm not in ("none", "relgap"):
            raise ValueError(f"unknown pool_norm {self.pool_norm!r}")
        ported = dict(warm_start=True, rel_gap=0.0, probe_patience=0,
                      branching="pseudocost", presolve_fix=True,
                      pool_norm="none", depth_tiebreak=0.0, sb_iters=0,
                      sb_fix=False, dive_slots=0, root_iters=0)
        bad = [k for k, v in ported.items() if getattr(self, k) != v]
        if bad:
            raise NotImplementedError(
                f"BnbSpec option(s) {bad} are not ported to "
                "pyhybridcontrol_tpu_torch yet (ROADMAP queue 1, item "
                "'BnbSpec options'); leave them at their defaults")


@dataclasses.dataclass
class BnbState:
    """Node pool (C+1 rows: row C is the dump row) and search scalars."""

    fix_mask: torch.Tensor     # (C+1, nb) bool
    fix_val: torch.Tensor      # (C+1, nb) f32
    x_pool: torch.Tensor       # (C+1, n) parent primal (original units)
    z_pool: torch.Tensor       # (C+1, m̄) parent z (scaled frame)
    y_pool: torch.Tensor       # (C+1, m̄) parent dual (scaled frame)
    bound: torch.Tensor        # (C+1,) parent relaxation lower bound
    active: torch.Tensor       # (C+1,) bool
    branch_var: torch.Tensor   # (C+1,) i64 — binary branched on (−1: root)
    branch_dir: torch.Tensor   # (C+1,) i64 — 0 / 1
    branch_frac: torch.Tensor  # (C+1,) f32 — parent's relaxed value
    pc_sum: torch.Tensor       # (nb+1, 2) pseudo-cost sums (row nb: dump)
    pc_cnt: torch.Tensor       # (nb+1, 2)
    inc_obj: torch.Tensor      # () incumbent objective
    inc_x: torch.Tensor        # (n,) incumbent solution
    inc_found: torch.Tensor    # () bool
    nodes_solved: torch.Tensor  # () i64
    overflow: torch.Tensor     # () bool
    alive: torch.Tensor        # () bool — any active node
    dropped_min: torch.Tensor  # () f32 — min bound over overflow drops


@dataclasses.dataclass
class BnbResult:
    x: torch.Tensor
    obj: torch.Tensor
    found: torch.Tensor
    waves: int
    nodes_solved: torch.Tensor
    overflow: torch.Tensor
    best_open_bound: torch.Tensor   # min bound over still-open nodes


def _init_state(backend, spec: BnbSpec, dtype, m_total: int,
                device) -> BnbState:
    C, nb, n = spec.capacity, len(backend.binary_idx), backend.n

    def full(shape, v, dt=dtype):
        return torch.full(shape, v, dtype=dt, device=device)

    active = torch.zeros(C + 1, dtype=torch.bool, device=device)
    active[0] = True
    return BnbState(
        fix_mask=torch.zeros((C + 1, nb), dtype=torch.bool, device=device),
        fix_val=full((C + 1, nb), 0.0),
        x_pool=full((C + 1, n), 0.0),
        z_pool=full((C + 1, m_total), 0.0),
        y_pool=full((C + 1, m_total), 0.0),
        bound=full((C + 1,), -BIG),
        active=active,
        branch_var=full((C + 1,), -1, torch.long),
        branch_dir=full((C + 1,), 0, torch.long),
        branch_frac=full((C + 1,), 0.5),
        pc_sum=full((nb + 1, 2), 0.0),
        pc_cnt=full((nb + 1, 2), 0.0),
        inc_obj=full((), BIG),
        inc_x=full((n,), 0.0),
        inc_found=torch.zeros((), dtype=torch.bool, device=device),
        nodes_solved=full((), 0, torch.long),
        overflow=torch.zeros((), dtype=torch.bool, device=device),
        alive=torch.ones((), dtype=torch.bool, device=device),
        dropped_min=full((), BIG),
    )


def _first_k(values, k: int, descending: bool = False):
    """Indices of the k smallest (largest) values, ties by lower index —
    the ``lax.top_k`` order, identical on CPU and CUDA."""
    return torch.sort(values, descending=descending, stable=True)[1][:k]


def _bnb_loop(backend, f, h, spec: BnbSpec,
              init_incumbent=None) -> BnbResult:
    """The B&B wave loop (single device). ``init_incumbent``: optional
    ``(obj, V, ok)`` heuristic seed (e.g. rollout repair)."""
    nb = len(backend.binary_idx)
    dev = f.device
    if nb == 0:
        res = backend.solve(f, h, backend.lb, backend.ub, spec.qp_iters)
        one = torch.ones((), dtype=torch.long, device=dev)
        return BnbResult(res.x, res.obj, res.r_prim_rel < spec.feas_tol, 0,
                         one, torch.zeros((), dtype=torch.bool, device=dev),
                         res.obj)
    bidx = torch.as_tensor(backend.binary_idx, dtype=torch.long, device=dev)
    W, C = spec.wave_size, spec.capacity
    dtype = f.dtype
    s = _init_state(backend, spec, dtype, backend.warm_size, dev)
    if init_incumbent is not None:
        obj0, x0V, ok0 = init_incumbent
        s.inc_obj = torch.where(ok0, obj0.to(dtype), s.inc_obj)
        s.inc_x = torch.where(ok0, x0V.to(dtype), s.inc_x)
        s.inc_found = s.inc_found | ok0

    def node_bounds(fm, fv):
        """(Wb, n) lb/ub for nodes given fixed-binary masks/values."""
        Wb = fm.shape[0]
        lb = backend.lb.expand(Wb, backend.n).clone()
        ub = backend.ub.expand(Wb, backend.n).clone()
        lb[:, bidx] = torch.where(fm, fv, 0.0)
        ub[:, bidx] = torch.where(fm, fv, 1.0)
        return lb, ub

    fb, hb = backend.broadcast_data(f, h, W)
    piters = spec.probe_iters or spec.qp_iters
    acc_tol = spec.inc_tol or spec.feas_tol
    waves = 0
    # the continue test is the loop's one host read per wave
    while waves < spec.max_waves and bool(s.alive):
        _wave(backend, s, spec, fb, hb, bidx, node_bounds, piters, acc_tol)
        waves += 1
    act = s.active[:C]
    best_open = torch.minimum(torch.where(act, s.bound[:C], BIG).min(),
                              s.dropped_min)
    return BnbResult(x=s.inc_x, obj=s.inc_obj, found=s.inc_found,
                     waves=waves, nodes_solved=s.nodes_solved,
                     overflow=s.overflow, best_open_bound=best_open)


def _wave(backend, s: BnbState, spec: BnbSpec, fb, hb, bidx, node_bounds,
          piters, acc_tol):
    """One wave; updates the pool ``s`` in place."""
    W, C = spec.wave_size, spec.capacity
    nb = bidx.shape[0]

    # -- 1. best-first selection --------------------------------------------
    sel = _first_k(torch.where(s.active[:C], s.bound[:C], BIG), W)
    valid = s.active[sel]
    fm = s.fix_mask[sel]
    fv = s.fix_val[sel]
    parent_bound = s.bound[sel]

    # -- 2. relaxations + fused dive probe (K2) -----------------------------
    lb, ub = node_bounds(fm, fv)
    warm = (s.x_pool[sel], s.z_pool[sel], s.y_pool[sel])
    relax, probe, lb_p, ub_p = backend.solve_wave(
        fb, hb, lb, ub, spec.qp_iters, piters, warm=warm)
    probe_ok = (probe.r_prim_rel < acc_tol) & valid
    # clamp with the leaf's certified dual bound: a feas_tol-feasible but
    # unconverged probe can report an objective below the leaf optimum
    pcert = backend.node_bound(probe, fb, hb, lb_p, ub_p)
    pobj = torch.where(torch.isfinite(pcert),
                       torch.maximum(probe.obj, pcert), probe.obj)
    probe_obj = torch.where(probe_ok, pobj, BIG)

    converged = relax.r_prim_rel < spec.feas_tol
    infeasible = relax.infeas_cert | (relax.r_prim_rel > spec.infeas_tol)
    # certified dual bound + per-binary presolve data (Falk certificate)
    cert, flip_delta, retain_side, imp_lo, imp_hi = backend.node_cert(
        relax, fb, hb, lb, ub)
    cert_fin = torch.isfinite(cert)
    cert = torch.where(cert_fin, cert, parent_bound)
    lower = torch.where(valid & ~infeasible,
                        torch.maximum(parent_bound, cert), BIG)

    xb = relax.x[:, bidx]
    rounded = torch.round(torch.clamp(xb, 0.0, 1.0))
    frac = torch.where(fm, 0.0, torch.abs(xb - rounded))
    integral = frac.amax(dim=1) < spec.int_tol
    fully_fixed = fm.all(dim=1)

    # -- 2b. pseudo-cost observation (dump row nb takes the misses) ---------
    bv = s.branch_var[sel]
    bdir = s.branch_dir[sel]
    bf = torch.clamp(s.branch_frac[sel], 0.0, 1.0)
    obs = valid & converged & (bv >= 0)
    gain = torch.clamp_min(lower - parent_bound, 0.0)
    denom = torch.where(bdir == 1, 1.0 - bf, bf)
    contrib = torch.where(obs, gain / torch.clamp_min(denom, 1e-3), 0.0)
    bv_safe = torch.where(obs, bv, nb)
    s.pc_sum.index_put_((bv_safe, bdir), contrib, accumulate=True)
    s.pc_cnt.index_put_((bv_safe, bdir), obs.to(s.pc_cnt.dtype),
                        accumulate=True)

    # -- 3. incumbent update (probe candidates only) ------------------------
    k = torch.argmin(probe_obj)
    better = probe_obj[k] < s.inc_obj
    s.inc_obj = torch.where(better, probe_obj[k], s.inc_obj)
    s.inc_x = torch.where(better, probe.x[k], s.inc_x)
    s.inc_found = s.inc_found | (better & probe_ok[k])
    inc_obj, inc_found = s.inc_obj, s.inc_found

    # -- 4. prune ------------------------------------------------------------
    bound_prune = lower >= inc_obj - spec.gap
    prune = (~valid | infeasible | fully_fixed | bound_prune
             | (converged & integral))
    expand = valid & ~prune

    # -- 4b. node presolve (certificate-backed binary fixing) ---------------
    # reduced-cost fixing: flipping binary j provably cannot beat the
    # incumbent → fix j to the tangent-retained side; implied-integrality
    # fixing: the node's implied box excludes one integral value
    unfixed = ~fm
    ok_node = (valid & ~infeasible)[:, None]
    flip_bound = torch.maximum(
        parent_bound[:, None],
        torch.where(cert_fin[:, None], cert[:, None] + flip_delta, -BIG))
    rc = unfixed & ok_node & inc_found & (flip_bound >= inc_obj - spec.gap)
    imp1 = unfixed & ok_node & (imp_lo > 1e-2)
    imp0 = unfixed & ok_node & (imp_hi < 1.0 - 1e-2)
    newv = torch.where(imp1, 1.0, torch.where(
        imp0, 0.0, torch.where(rc, retain_side, fv)))
    fm2 = fm | rc | imp0 | imp1
    fv2 = torch.where(fm, fv, newv)

    # -- 5. branch -----------------------------------------------------------
    child_bound = torch.where(expand, torch.maximum(parent_bound, lower),
                              parent_bound)
    xbc = torch.clamp(xb, 0.0, 1.0)
    # pseudo-cost product rule; vars without observations use the global
    # per-direction mean (1.0 before any → f·(1−f), most fractional)
    pcs, pcc = s.pc_sum[:nb], s.pc_cnt[:nb]
    cnt_tot = pcc.sum(0)                                         # (2,)
    gavg = torch.where(cnt_tot > 0,
                       pcs.sum(0) / torch.clamp_min(cnt_tot, 1.0), 1.0)
    avg = pcs / torch.clamp_min(pcc, 1.0)                        # (nb,2)
    est = torch.where(pcc > 0, avg, gavg[None, :])
    sc = (torch.clamp_min(est[None, :, 0] * xbc, 1e-8)
          * torch.clamp_min(est[None, :, 1] * (1.0 - xbc), 1e-8))
    score = torch.where(fm2, -1.0, sc * torch.clamp_min(frac, 1e-4))
    jstar = torch.argmax(score, dim=1)
    # presolve may fix everything: the node becomes its own leaf
    has_branch = (~fm2).any(dim=1)
    branch_hot = (torch.nn.functional.one_hot(jstar, nb).bool()
                  & has_branch[:, None])
    cfm = fm2 | branch_hot
    cfv0 = torch.where(branch_hot, 0.0, fv2)
    cfv1 = torch.where(branch_hot, 1.0, fv2)
    cbf = torch.gather(xbc, 1, jstar[:, None])[:, 0]
    cbv = torch.where(has_branch, jstar, -1)
    # flip-delta child bound: the certified extra bound of the child fixed
    # to the tangent-disfavoured side of jstar
    fd_j = torch.gather(flip_delta, 1, jstar[:, None])[:, 0]
    rs_j = torch.gather(retain_side, 1, jstar[:, None])[:, 0]
    flip_to1 = rs_j < 0.5
    cb_extra = torch.where(cert_fin & has_branch,
                           cert + torch.clamp_min(fd_j, 0.0), -BIG)
    child0_bound = torch.where(
        ~flip_to1, torch.maximum(child_bound, cb_extra), child_bound)
    child1_bound = torch.where(
        flip_to1, torch.maximum(child_bound, cb_extra), child_bound)

    # child-0 into the parent slot (sel holds distinct slots)
    e1 = expand[:, None]
    s.fix_mask[sel] = torch.where(e1, cfm, fm)
    s.fix_val[sel] = torch.where(e1, cfv0, fv)
    s.bound[sel] = torch.where(expand, child0_bound, child_bound)
    s.branch_var[sel] = torch.where(expand, cbv, bv)
    s.branch_dir[sel] = torch.where(expand, 0, bdir)
    s.branch_frac[sel] = torch.where(expand, cbf, s.branch_frac[sel])
    s.active[sel] = expand
    s.x_pool[sel] = relax.x
    s.z_pool[sel] = relax.z
    s.y_pool[sel] = relax.y

    # child-1 → free slots; the i-th best child takes the i-th free slot;
    # writes with no slot go to the dump row C
    clive = expand & has_branch
    free_slots = _first_k(torch.where(s.active[:C], -1.0, 1.0), W,
                          descending=True)
    slot_free = ~s.active[free_slots]
    src = _first_k(torch.where(clive, child1_bound, BIG), W)
    write_ok = slot_free & clive[src]
    tgt = torch.where(write_ok, free_slots, C)
    s.fix_mask[tgt] = cfm[src]
    s.fix_val[tgt] = cfv1[src]
    s.bound[tgt] = child1_bound[src]
    s.branch_var[tgt] = cbv[src]
    s.branch_dir[tgt] = 1
    s.branch_frac[tgt] = cbf[src]
    s.active[tgt] = True
    s.x_pool[tgt] = relax.x[src]
    s.z_pool[tgt] = relax.z[src]
    s.y_pool[tgt] = relax.y[src]
    s.active[C] = False
    drop_mask = clive[src] & ~slot_free
    s.overflow = s.overflow | drop_mask.any()
    s.dropped_min = torch.minimum(
        s.dropped_min, torch.where(drop_mask, child1_bound[src], BIG).min())

    s.alive = s.active[:C].any()
    s.nodes_solved = s.nodes_solved + valid.sum()


def solve_miqp_bnb(admm: BoxQP, qp: DeviceQP, f, h,
                   spec: BnbSpec = BnbSpec(),
                   init_incumbent=None,
                   admm_probe: Optional[BoxQP] = None) -> BnbResult:
    """Solve  min ½VᵀHV + fᵀV  s.t. GV ≤ h, lb ≤ V ≤ ub, V[bidx] ∈ {0,1}
    on the device of ``f``. f, h from ``qp.assemble(x0, …)``.
    ``init_incumbent``: optional (obj, V, ok) heuristic seed.
    ``admm_probe``: optional stiff-ρ prep for the dive probes."""
    return _bnb_loop(CondensedBackend(admm, qp, admm_probe), f, h, spec,
                     init_incumbent=init_incumbent)
