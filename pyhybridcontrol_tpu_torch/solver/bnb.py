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
  a Python loop with ONE host read per wave: a two-flag tensor computed at
  the end of wave k that holds the continue test (``alive`` and the
  ``rel_gap`` stop) and the probe gate of wave k+1 (``probe_patience``;
  the reference's ``lax.cond`` becomes a host branch). Everything else
  stays on the device. CUDA graphs of a wave come later.
- JAX scatters drop out-of-bounds indices (``mode="drop"``); torch does
  not. Every pool tensor has a dump row at index ``capacity`` (the
  pseudo-cost tables one at index ``nb``): dropped writes land there and
  the dump row is never selected.
- ``lax.top_k`` and ``jnp.argmax``/``argmin`` break ties by the lower
  index and ``jnp.argsort`` is stable; the port selects with
  ``utils/select.py`` (stable sorts, first-index arg-max/min), so CPU and
  CUDA runs walk the same tree.
- The pool is updated in place (the loop owns it).
- Backend hooks are read as the reference reads them: a backend without
  ``solve_wave`` (the consensus tree's ``TreeBackend``) runs solve →
  round → ``solve_probe``; without ``node_bound`` its node bounds are
  uncertified (the relaxation's objective where it converged, else the
  parent's); ``node_cert`` runs only with ``presolve_fix``.
- Every ``BnbSpec`` option of the reference is ported: pseudo-cost,
  most-fractional and flip-delta branching, the certificate-backed node
  presolve (``presolve_fix``) and its absence, warm starts on or off,
  flip-delta child bounds, always-on or gated dive probes
  (``probe_patience``), ``rel_gap`` termination, ``root_iters``, the
  carried-plan ``init_node``, the depth tie-break (``depth_tiebreak``),
  the diving lane (``dive_slots``), root strong branching
  (``sb_iters``/``sb_fix``), and ``pool_norm`` for the pooled engine
  (solver/bnb_pooled.py, which refuses the four search options the
  reference's pooled engine ignores).
- The multi-device hooks of the reference (``exchange_children``,
  ``reduce_incumbent``, ``global_any_active``, ``reduce_min``) are
  ``_bnb_loop``'s ``hooks`` (``LoopHooks``) and its ``root_device_pred``
  is ``root_here``, with its semantics; parallel/sharded_bnb.py fills
  them with collectives over a mesh axis. The continue test reads the reduced flags, so every rank
  takes the same number of waves; the probe gate reads the rank's own
  ``probe_stale``, as each device's ``lax.cond`` does in the reference
  (no collective depends on it). Without hooks the loop is what it was.
- The diving lane: the reference points short-frontier picks at the
  out-of-bounds slot so that their scatters drop; here they select the
  dump row C with ``valid`` false (``bnb_pooled.SCATTER_HOOK`` sees
  these scatters as "bnb_parent" and "bnb_child1").
- Root strong branching runs its 2·nb candidate children as one batch
  padded to a grain of 8 (the reference's grain off the TPU), through
  ``solve_cert``, which is ``solve`` here: on the card one K1 launch.
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
from pyhybridcontrol_tpu_torch.utils.select import first_arg, first_k


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

    def solve_cert(self, f, h, lb, ub, iters, warm=None):
        """Certificate-grade batched solve: root strong branching fixes
        binaries and lifts the root bound off these certificates. The
        reference keeps it off its Pallas kernel, which sums the
        certificate in plain fp32; K1 sums it in fp64, as its plain
        version does, so here it is ``solve``: K1 on the card."""
        return self.solve(f, h, lb, ub, iters, warm=warm)

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        """Dive probe on its own (the unfused composition): stiff-ρ for
        the first half of the iterations when there is a probe prep, then
        base-ρ, warm-chained."""
        if self.admm_probe is None:
            return self.solve(f, h, lb, ub, iters, warm=warm)
        k = iters // 2
        r1 = admm_solve_auto(self.admm_probe, f, h, lb, ub, iters=k,
                             warm=warm)
        return self.solve(f, h, lb, ub, iters - k, warm=(r1.x, r1.z, r1.y))

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
    warm_start: bool = True      # children inherit parent ADMM iterates
    rel_gap: float = 0.0         # relative MIPGap termination
    probe_patience: int = 0      # probe gating: 0 → probe every wave; k>0
    # → after k waves without a better incumbent, probe every (k+1)-th
    # wave only; leaves met on a gated wave wait for the next probing wave
    branching: str = "pseudocost"   # or "most_frac", or "flipdelta"
    # (the Falk certificate's flip delta × fractionality; needs
    # presolve_fix, else most-fractional)
    presolve_fix: bool = True    # certificate-backed node presolve
    pool_norm: str = "none"      # pooled engine only: "none" | "relgap"
    depth_tiebreak: float = 0.0  # selection priority bound − dt·depth:
    # diving on bound plateaus (search order only)
    sb_iters: int = 0            # root strong branching: all 2·nb
    # candidate children solved as one batch of sb_iters iterations, warm
    # from the root; seeds the pseudo-costs
    sb_fix: bool = False         # + fix binaries from the candidates'
    # infeasibility certificates (or the incumbent) and lift the root
    # bound to max_j min(cert_j0, cert_j1)
    dive_slots: int = 0          # wave slots for the deepest active nodes
    # not picked best-first (the diving lane; search order only)
    root_iters: int = 0          # root pre-solve: root_iters − qp_iters
    # extra iterations stored as the root's warm start (needs warm_start)

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


@dataclasses.dataclass(frozen=True)
class LoopHooks:
    """The multi-device seams of the wave loop (None: single device).

      exchange_children(dict) — permute the child-1 batch across ranks
        before its scatter into the pool (load balancing);
      reduce_incumbent(obj, x, found) — the best incumbent over ranks;
      global_any_active(bool) — OR of "any node active" over ranks;
      reduce_min(x) — min over ranks of the best open bound, so that the
        ``rel_gap`` stop and the final bound read the global one.
    """

    exchange_children: Optional[object] = None
    reduce_incumbent: Optional[object] = None
    global_any_active: Optional[object] = None
    reduce_min: Optional[object] = None


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
    depth: torch.Tensor        # (C+1,) i64
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
    probe_stale: torch.Tensor  # () i64 — waves since a probe improved
    best_open: torch.Tensor    # () f32 — min bound over open nodes


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
        depth=full((C + 1,), 0, torch.long),
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
        probe_stale=full((), 0, torch.long),
        best_open=full((), -BIG),
    )


def _loop_flags(spec: BnbSpec, live, found_all, probe_stale, next_wave: int):
    """The loop's one host read per wave: ``(continue, probe gate of the
    next wave)`` as Python bools, from one two-element tensor. ``live`` is
    the continue test on the device; ``found_all`` says whether every
    instance has an incumbent (the gate probes until then)."""
    if spec.probe_patience == 0:
        return bool(live), True
    retry = next_wave % (spec.probe_patience + 1) == 0
    probe = ~found_all | (probe_stale < spec.probe_patience)
    live, probe = torch.stack([live, probe]).tolist()
    return live, probe or retry


def _bnb_loop(backend, f, h, spec: BnbSpec, init_incumbent=None,
              init_node=None, hooks: LoopHooks = LoopHooks(),
              root_here: bool = True) -> BnbResult:
    """The B&B wave loop. ``init_incumbent``: optional ``(obj, V, ok)``
    heuristic seed (e.g. rollout repair). ``init_node``: optional
    ``(bvals, ok, x_warm|None)`` binary assignment injected as a
    fully-fixed node in slot 1 (it rides wave 1 beside the root).
    ``hooks``: the multi-device seams; ``root_here``: whether this rank's
    pool starts with the root (and the ``init_node``), the reference's
    ``root_device_pred``."""
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
    if not root_here:
        # SPMD: only the root rank's pool starts with the root node
        s.active[0] = False
    if init_incumbent is not None:
        obj0, x0V, ok0 = init_incumbent
        s.inc_obj = torch.where(ok0, obj0.to(dtype), s.inc_obj)
        s.inc_x = torch.where(ok0, x0V.to(dtype), s.inc_x)
        s.inc_found = s.inc_found | ok0
    if spec.root_iters > spec.qp_iters and spec.warm_start:
        # pre-converge the root relaxation; wave 1 finishes it from there
        r0 = backend.solve(f, h, backend.lb, backend.ub,
                           spec.root_iters - spec.qp_iters)
        s.x_pool[0], s.z_pool[0], s.y_pool[0] = r0.x, r0.z, r0.y
    if init_node is not None:
        bv0, okn, xw = init_node
        s.active[1] = okn & root_here
        s.fix_mask[1] = True
        s.fix_val[1] = bv0.to(dtype)
        if spec.warm_start and xw is not None:
            s.x_pool[1] = xw.to(dtype)

    def node_bounds(fm, fv):
        """(Wb, n) lb/ub for nodes given fixed-binary masks/values."""
        Wb = fm.shape[0]
        lb = backend.lb.expand(Wb, backend.n).clone()
        ub = backend.ub.expand(Wb, backend.n).clone()
        lb[:, bidx] = torch.where(fm, fv, 0.0)
        ub[:, bidx] = torch.where(fm, fv, 1.0)
        return lb, ub

    if spec.sb_iters > 0 and getattr(backend, "node_bound", None) is not None:
        _root_strong_branching(backend, s, spec, f, h, bidx, node_bounds)
    fb, hb = backend.broadcast_data(f, h, W)
    piters = spec.probe_iters or spec.qp_iters
    acc_tol = spec.inc_tol or spec.feas_tol
    waves = 0
    live, probe = True, True      # wave 0: root active, retry wave
    while waves < spec.max_waves and live:
        _wave(backend, s, spec, fb, hb, bidx, node_bounds, piters, acc_tol,
              probe, hooks)
        waves += 1
        cont = s.alive
        if spec.rel_gap > 0:
            tol = spec.rel_gap * torch.clamp_min(s.inc_obj.abs(), 1.0)
            cont = cont & ~(s.inc_found & (s.inc_obj - s.best_open <= tol))
        live, probe = _loop_flags(spec, cont, s.inc_found, s.probe_stale,
                                  waves)
    act = s.active[:C]
    best_open = torch.minimum(torch.where(act, s.bound[:C], BIG).min(),
                              s.dropped_min)
    if hooks.reduce_min is not None:
        best_open = hooks.reduce_min(best_open)
    return BnbResult(x=s.inc_x, obj=s.inc_obj, found=s.inc_found,
                     waves=waves, nodes_solved=s.nodes_solved,
                     overflow=s.overflow, best_open_bound=best_open)


def _probe_candidates(backend, relax, probe, lb_p, ub_p, fb, hb, valid,
                      acc_tol):
    """(candidate objective or BIG, accepted) per probe. With a
    ``node_bound`` the objective is clamped with the leaf's certified dual
    bound: a feas_tol-feasible but unconverged probe can report an
    objective below the leaf optimum."""
    ok = (probe.r_prim_rel < acc_tol) & valid
    pobj = probe.obj
    node_bound = getattr(backend, "node_bound", None)
    if node_bound is not None:
        pcert = node_bound(probe, fb, hb, lb_p, ub_p)
        pobj = torch.where(torch.isfinite(pcert),
                           torch.maximum(pobj, pcert), pobj)
    return torch.where(ok, pobj, BIG), ok


def _relax_then_probe(backend, fb, hb, lb, ub, iters, piters, warm,
                      rounded_bounds):
    """The unfused wave: the relaxation, then the dive probe on the node
    bounds ``rounded_bounds(relax)`` returns, warm from the relaxation.
    Returns ``(relax, probe, lb_probe, ub_probe)`` as ``solve_wave``."""
    relax = backend.solve(fb, hb, lb, ub, iters, warm=warm)
    lb_p, ub_p = rounded_bounds(relax)
    probe = backend.solve_probe(fb, hb, lb_p, ub_p, piters,
                                warm=(relax.x, relax.z, relax.y))
    return relax, probe, lb_p, ub_p


def _wave(backend, s: BnbState, spec: BnbSpec, fb, hb, bidx, node_bounds,
          piters, acc_tol, probe_ran: bool = True,
          hooks: LoopHooks = LoopHooks()):
    """One wave; updates the pool ``s`` in place. ``probe_ran``: the probe
    gate, decided before the wave (K2 on probing waves, K1 on gated ones).
    ``hooks``: the multi-device seams."""
    W, C = spec.wave_size, spec.capacity
    nb = bidx.shape[0]

    # -- 1. best-first selection (+ the diving lane) ------------------------
    sel, valid = _select(s, spec)
    fm = s.fix_mask[sel]
    fv = s.fix_val[sel]
    parent_bound = s.bound[sel]

    # -- 2. relaxations + fused dive probe (K2) -----------------------------
    lb, ub = node_bounds(fm, fv)
    warm = ((s.x_pool[sel], s.z_pool[sel], s.y_pool[sel])
            if spec.warm_start else None)
    # the hooks a backend may lack (as the reference reads them): without
    # ``solve_wave`` the wave runs solve → round → solve_probe; without
    # ``node_bound`` the node bound is uncertified (relax.obj where
    # converged, else the parent's); ``node_cert`` only with presolve_fix
    solve_wave = getattr(backend, "solve_wave", None)
    node_bound = getattr(backend, "node_bound", None)
    node_cert = (getattr(backend, "node_cert", None)
                 if spec.presolve_fix else None)
    if probe_ran:
        if solve_wave is not None:
            relax, probe, lb_p, ub_p = solve_wave(
                fb, hb, lb, ub, spec.qp_iters, piters, warm=warm)
        else:
            def rounded_bounds(r):
                pv = torch.where(fm, fv, torch.round(
                    torch.clamp(r.x[:, bidx], 0.0, 1.0)))
                return node_bounds(torch.ones_like(fm), pv)

            relax, probe, lb_p, ub_p = _relax_then_probe(
                backend, fb, hb, lb, ub, spec.qp_iters, piters, warm,
                rounded_bounds)
        probe_obj, probe_ok = _probe_candidates(
            backend, relax, probe, lb_p, ub_p, fb, hb, valid, acc_tol)
        probe_x = probe.x
    else:
        relax = backend.solve(fb, hb, lb, ub, spec.qp_iters, warm=warm)
        probe_obj = torch.full_like(relax.obj, BIG)
        probe_ok = torch.zeros_like(valid)
        probe_x = torch.zeros_like(relax.x)

    converged = relax.r_prim_rel < spec.feas_tol
    infeasible = relax.infeas_cert | (relax.r_prim_rel > spec.infeas_tol)
    # certified dual bound (+ per-binary presolve data with presolve_fix)
    presolve = node_cert is not None
    certified = presolve or node_bound is not None
    if presolve:
        cert, flip_delta, retain_side, imp_lo, imp_hi = node_cert(
            relax, fb, hb, lb, ub)
    elif certified:
        cert = node_bound(relax, fb, hb, lb, ub)
    if certified:
        cert_fin = torch.isfinite(cert)
        cert = torch.where(cert_fin, cert, parent_bound)
        lower = torch.where(valid & ~infeasible,
                            torch.maximum(parent_bound, cert), BIG)
    else:
        # uncertified: relax.obj only where converged, else the parent's
        lower = torch.where(valid & converged, relax.obj,
                            torch.where(valid & ~infeasible, parent_bound,
                                        BIG))

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
    k = first_arg(probe_obj, largest=False)
    better = probe_obj[k] < s.inc_obj
    s.inc_obj = torch.where(better, probe_obj[k], s.inc_obj)
    s.inc_x = torch.where(better, probe_x[k], s.inc_x)
    s.inc_found = s.inc_found | (better & probe_ok[k])
    if probe_ran:
        s.probe_stale = torch.where(better, 0, s.probe_stale + 1)
    if hooks.reduce_incumbent is not None:
        s.inc_obj, s.inc_x, s.inc_found = hooks.reduce_incumbent(
            s.inc_obj, s.inc_x, s.inc_found)
    inc_obj, inc_found = s.inc_obj, s.inc_found

    # -- 4. prune; on a gated wave leaf candidates wait for the next probe --
    bound_prune = lower >= inc_obj - spec.gap
    if not certified:
        bound_prune = bound_prune & converged
    leaf = fully_fixed | (converged & integral)
    if probe_ran:
        prune = ~valid | infeasible | bound_prune | leaf
    else:
        prune = ~valid | infeasible | bound_prune
    expand = valid & ~prune

    # -- 4b. node presolve (certificate-backed binary fixing) ---------------
    # reduced-cost fixing: flipping binary j provably cannot beat the
    # incumbent → fix j to the tangent-retained side; implied-integrality
    # fixing: the node's implied box excludes one integral value
    if presolve:
        fm2, fv2 = _presolve_fix(
            fm, fv, valid & ~infeasible, parent_bound, cert, cert_fin,
            flip_delta, retain_side, imp_lo, imp_hi, inc_found, inc_obj,
            spec.gap)
    else:
        fm2, fv2 = fm, fv

    # -- 5. branch -----------------------------------------------------------
    # certified bounds hold at any iterate; the uncertified one only where
    # the relaxation converged
    if certified:
        child_bound = torch.where(expand, torch.maximum(parent_bound, lower),
                                  parent_bound)
    else:
        child_bound = torch.maximum(
            parent_bound, torch.where(converged, lower, parent_bound))
    xbc = torch.clamp(xb, 0.0, 1.0)
    # pseudo-cost product rule; vars without observations use the global
    # per-direction mean (1.0 before any → f·(1−f), most fractional)
    if spec.branching == "pseudocost":
        score = _pseudocost_score(s.pc_sum[:nb], s.pc_cnt[:nb], xbc, frac)
    elif spec.branching == "flipdelta" and presolve:
        # the certified flip delta of the tangent-disfavoured child, blended
        # with fractionality; without presolve data: most fractional
        score = flip_delta * torch.clamp_min(frac, 1e-4)
    else:
        score = frac
    jstar = first_arg(torch.where(fm2, -1.0, score), dim=1)
    # presolve may fix everything: the node becomes its own leaf
    has_branch = (~fm2).any(dim=1)
    branch_hot = (torch.nn.functional.one_hot(jstar, nb).bool()
                  & has_branch[:, None])
    cfm = fm2 | branch_hot
    cfv0 = torch.where(branch_hot, 0.0, fv2)
    cfv1 = torch.where(branch_hot, 1.0, fv2)
    cbf = torch.gather(xbc, 1, jstar[:, None])[:, 0]
    cbv = torch.where(has_branch, jstar, -1)
    cdepth = s.depth[sel] + 1
    # flip-delta child bound: the certified extra bound of the child fixed
    # to the tangent-disfavoured side of jstar
    if presolve:
        child0_bound, child1_bound = _flip_delta_bounds(
            child_bound, cert, cert_fin, has_branch, flip_delta,
            retain_side, jstar)
    else:
        child0_bound = child1_bound = child_bound

    # child-0 into the parent slot (sel holds distinct slots, but for the
    # diving lane's short-frontier picks, which all select the dump row C)
    _watch("bnb_parent", sel, C)
    e1 = expand[:, None]
    s.fix_mask[sel] = torch.where(e1, cfm, fm)
    s.fix_val[sel] = torch.where(e1, cfv0, fv)
    s.bound[sel] = torch.where(expand, child0_bound, child_bound)
    s.depth[sel] = cdepth
    s.branch_var[sel] = torch.where(expand, cbv, bv)
    s.branch_dir[sel] = torch.where(expand, 0, bdir)
    s.branch_frac[sel] = torch.where(expand, cbf, s.branch_frac[sel])
    s.active[sel] = expand
    if spec.warm_start:
        s.x_pool[sel] = relax.x
        s.z_pool[sel] = relax.z
        s.y_pool[sel] = relax.y

    # child-1 → free slots; the i-th best child takes the i-th free slot;
    # writes with no slot go to the dump row C. Across ranks the batch is
    # exchanged first: a received child with ``live`` false is a dead one
    # and takes the dump row like any other
    c1 = dict(fm=cfm, fv=cfv1, bound=child1_bound, depth=cdepth,
              live=expand & has_branch, bv=cbv, bf=cbf)
    if spec.warm_start:
        c1.update(xw=relax.x, zw=relax.z, yw=relax.y)
    if hooks.exchange_children is not None:
        c1 = hooks.exchange_children(c1)
    clive, cb1 = c1["live"], c1["bound"]
    free_slots = first_k(torch.where(s.active[:C], -1.0, 1.0), W,
                         descending=True)
    slot_free = ~s.active[free_slots]
    src = first_k(torch.where(clive, cb1, BIG), W)
    write_ok = slot_free & clive[src]
    tgt = torch.where(write_ok, free_slots, C)
    _watch("bnb_child1", tgt, C)
    s.fix_mask[tgt] = c1["fm"][src]
    s.fix_val[tgt] = c1["fv"][src]
    s.bound[tgt] = cb1[src]
    s.depth[tgt] = c1["depth"][src]
    s.branch_var[tgt] = c1["bv"][src]
    s.branch_dir[tgt] = 1
    s.branch_frac[tgt] = c1["bf"][src]
    s.active[tgt] = True
    if spec.warm_start:
        s.x_pool[tgt] = c1["xw"][src]
        s.z_pool[tgt] = c1["zw"][src]
        s.y_pool[tgt] = c1["yw"][src]
    s.active[C] = False
    drop_mask = clive[src] & ~slot_free
    s.overflow = s.overflow | drop_mask.any()
    s.dropped_min = torch.minimum(
        s.dropped_min, torch.where(drop_mask, cb1[src], BIG).min())

    act = s.active[:C]
    s.alive = act.any()
    if hooks.global_any_active is not None:
        s.alive = hooks.global_any_active(s.alive)
    s.best_open = torch.minimum(torch.where(act, s.bound[:C], BIG).min(),
                                s.dropped_min)
    if hooks.reduce_min is not None:
        s.best_open = hooks.reduce_min(s.best_open)
    s.nodes_solved = s.nodes_solved + valid.sum()


def _select(s: BnbState, spec: BnbSpec):
    """(slots, valid) of one wave: the W best-priority active nodes, the
    priority bound − depth_tiebreak·depth, ties by lower slot. With
    ``dive_slots`` = k the last k picks are the deepest active nodes not
    picked best-first (ties: best bound); where fewer remain, the surplus
    picks select the dump row C with ``valid`` false."""
    W, C = spec.wave_size, spec.capacity
    active, bound = s.active[:C], s.bound[:C]
    pri = bound
    if spec.depth_tiebreak > 0:
        pri = pri - spec.depth_tiebreak * s.depth[:C]
    pri = torch.where(active, pri, BIG)
    if spec.dive_slots == 0:
        sel = first_k(pri, W)
        return sel, s.active[sel]
    k = spec.dive_slots
    sel_b = first_k(pri, W - k)
    taken = torch.zeros_like(active)
    taken[sel_b] = True
    dive_pri = torch.where(
        active & ~taken,
        s.depth[:C].to(bound.dtype) - torch.clamp(bound, -BIG, BIG) * 1e-9,
        -BIG)
    sel_d = first_k(dive_pri, k, descending=True)
    real = dive_pri[sel_d] > -BIG
    sel_d = torch.where(real, sel_d, C)
    sel = torch.cat([sel_b, sel_d])
    return sel, torch.cat([s.active[sel_b], s.active[sel_d] & real])


def _root_strong_branching(backend, s: BnbState, spec: BnbSpec, f, h, bidx,
                           node_bounds):
    """Batched root strong branching (``sb_iters``): the root relaxation,
    then all 2·nb candidate children (binary j fixed to 0, then to 1) as
    one batch of ``sb_iters`` iterations warm from the root, padded to a
    grain of 8 (the padding rows re-solve candidate 0 and are dropped).
    Their certified bounds seed the pseudo-costs; with ``sb_fix`` a side
    whose child is certified infeasible (or cannot beat the incumbent)
    fixes the binary to the other side at the root, and the root bound
    rises to max_j min(cert_j0, cert_j1). Only the dual infeasibility
    certificate fixes: a large residual is just unconverged."""
    nb = bidx.shape[0]
    node_bound = backend.node_bound
    lb, ub = backend.lb, backend.ub
    warm0 = ((s.x_pool[0], s.z_pool[0], s.y_pool[0])
             if spec.warm_start and spec.root_iters > spec.qp_iters else None)
    r_root = backend.solve(f, h, lb, ub, spec.qp_iters, warm=warm0)
    rb = node_bound(r_root, f, h, lb, ub)
    root_bound = torch.where(torch.isfinite(rb), rb, -BIG)
    xb0 = torch.clamp(r_root.x[bidx], 0.0, 1.0)
    SB = 2 * nb
    SBW = max(-(-SB // 8) * 8, 8)
    rows = torch.arange(SBW, device=bidx.device)
    fmc = torch.nn.functional.one_hot(rows % nb, nb).bool()
    one = (rows >= nb) & (rows < SB)
    fvc = torch.where(fmc & one[:, None], 1.0, 0.0).to(s.fix_val.dtype)
    lbc, ubc = node_bounds(fmc, fvc)
    fc, hc = backend.broadcast_data(f, h, SBW)
    warmc = tuple(v.expand((SBW,) + v.shape)
                  for v in (r_root.x, r_root.z, r_root.y))
    solve_c = getattr(backend, "solve_cert", backend.solve)
    rc = solve_c(fc, hc, lbc, ubc, spec.sb_iters, warm=warmc)
    certc = node_bound(rc, fc, hc, lbc, ubc)
    certc = torch.where(torch.isfinite(certc),
                        torch.maximum(certc, root_bound), root_bound)
    infc = rc.infeas_cert
    certc = torch.where(infc, BIG, certc)
    cert0, cert1 = certc[:nb], certc[nb:SB]
    inf0, inf1 = infc[:nb], infc[nb:SB]
    # pseudo-cost seeding with real per-unit degradations; an infeasible
    # child counts as the largest finite gain observed (at least 1)
    gain0 = torch.clamp_min(torch.where(inf0, 0.0, cert0) - root_bound, 0.0)
    gain1 = torch.clamp_min(torch.where(inf1, 0.0, cert1) - root_bound, 0.0)
    gmax = torch.clamp_min(torch.maximum(gain0, gain1).max(), 1.0)
    gain0 = torch.where(inf0, gmax, gain0)
    gain1 = torch.where(inf1, gmax, gain1)
    s.pc_sum[:nb, 0] += gain0 / torch.clamp_min(xb0, 1e-3)
    s.pc_sum[:nb, 1] += gain1 / torch.clamp_min(1.0 - xb0, 1e-3)
    s.pc_cnt[:nb] += 1.0
    if spec.sb_fix:
        beat = s.inc_obj - spec.gap
        lose0 = inf0 | (s.inc_found & (cert0 >= beat))
        lose1 = inf1 | (s.inc_found & (cert1 >= beat))
        fixj = lose0 | lose1
        s.fix_val[0] = torch.where(fixj, torch.where(lose0, 1.0, 0.0),
                                   s.fix_val[0])
        s.fix_mask[0] |= fixj
        lift = torch.maximum(torch.minimum(cert0, cert1).max(), root_bound)
        s.bound[0] = torch.maximum(s.bound[0], lift)
    if spec.warm_start:
        s.x_pool[0], s.z_pool[0], s.y_pool[0] = r_root.x, r_root.z, r_root.y


def _watch(name: str, idx, dump_row: int):
    """Show a pool scatter to ``bnb_pooled.SCATTER_HOOK`` (a test hook)."""
    from pyhybridcontrol_tpu_torch.solver import bnb_pooled

    if bnb_pooled.SCATTER_HOOK is not None:
        bnb_pooled.SCATTER_HOOK(name, idx, dump_row)


def _presolve_fix(fm, fv, ok_node, parent_bound, cert, cert_fin, flip_delta,
                  retain_side, imp_lo, imp_hi, inc_found, inc_obj, gap):
    """Node presolve from the Falk certificate's per-binary data: returns
    the fix mask/values the node's children inherit. ``inc_found`` /
    ``inc_obj``: the incumbent each row prunes against (scalars, or
    per-row vectors in the pooled engine)."""
    unfixed = ~fm
    ok_node = ok_node[:, None]
    if inc_obj.ndim == 1:
        inc_found, inc_obj = inc_found[:, None], inc_obj[:, None]
    flip_bound = torch.maximum(
        parent_bound[:, None],
        torch.where(cert_fin[:, None], cert[:, None] + flip_delta, -BIG))
    rc = unfixed & ok_node & inc_found & (flip_bound >= inc_obj - gap)
    imp1 = unfixed & ok_node & (imp_lo > 1e-2)
    imp0 = unfixed & ok_node & (imp_hi < 1.0 - 1e-2)
    newv = torch.where(imp1, 1.0, torch.where(
        imp0, 0.0, torch.where(rc, retain_side, fv)))
    return fm | rc | imp0 | imp1, torch.where(fm, fv, newv)


def _pseudocost_score(pc_sum, pc_cnt, xbc, frac):
    """Pseudo-cost product rule; binaries without observations use the
    global per-direction mean (1.0 before any → f·(1−f), most fractional)."""
    cnt_tot = pc_cnt.sum(0)                                      # (2,)
    gavg = torch.where(cnt_tot > 0,
                       pc_sum.sum(0) / torch.clamp_min(cnt_tot, 1.0), 1.0)
    avg = pc_sum / torch.clamp_min(pc_cnt, 1.0)                  # (nb,2)
    est = torch.where(pc_cnt > 0, avg, gavg[None, :])
    sc = (torch.clamp_min(est[None, :, 0] * xbc, 1e-8)
          * torch.clamp_min(est[None, :, 1] * (1.0 - xbc), 1e-8))
    return sc * torch.clamp_min(frac, 1e-4)


def _flip_delta_bounds(child_bound, cert, cert_fin, has_branch, flip_delta,
                       retain_side, jstar):
    """(child-0 bound, child-1 bound): the child fixed to the
    tangent-disfavoured side of jstar leads by its certified flip delta."""
    fd_j = torch.gather(flip_delta, 1, jstar[:, None])[:, 0]
    rs_j = torch.gather(retain_side, 1, jstar[:, None])[:, 0]
    flip_to1 = rs_j < 0.5
    cb_extra = torch.where(cert_fin & has_branch,
                           cert + torch.clamp_min(fd_j, 0.0), -BIG)
    lifted = torch.maximum(child_bound, cb_extra)
    return (torch.where(~flip_to1, lifted, child_bound),
            torch.where(flip_to1, lifted, child_bound))


def solve_miqp_bnb(admm: BoxQP, qp: DeviceQP, f, h,
                   spec: BnbSpec = BnbSpec(),
                   init_incumbent=None, init_node=None,
                   admm_probe: Optional[BoxQP] = None) -> BnbResult:
    """Solve  min ½VᵀHV + fᵀV  s.t. GV ≤ h, lb ≤ V ≤ ub, V[bidx] ∈ {0,1}
    on the device of ``f``. f, h from ``qp.assemble(x0, …)``.
    ``init_incumbent``: optional (obj, V, ok) heuristic seed.
    ``init_node``: optional (bvals, ok, x_warm|None) candidate binary
    assignment injected as a fully-fixed wave-1 node.
    ``admm_probe``: optional stiff-ρ prep for the dive probes."""
    return _bnb_loop(CondensedBackend(admm, qp, admm_probe), f, h, spec,
                     init_incumbent=init_incumbent, init_node=init_node)
