"""Pooled multi-instance branch-and-bound: B independent MIQPs (same
condensed matrices, per-instance f/h — a batch of scenarios or a batched
control step) solved in ONE global node pool.

Counterpart of ``pyhybridcontrol_tpu/solver/bnb_pooled.py``. All
instances' open nodes live in one (P,)-slot pool
tagged with an instance id; each wave selects the globally best
``wave_size`` nodes (instances that finished simply stop contributing)
and relaxes and probes them as a single (W, n) batch: one K2 launch per
probing wave, one K1 launch per probe-gated wave (ops/cuda_admm.py).
Per-instance state (incumbent, best open bound) is kept as (B,) vectors
updated with scatter-min; bounds and pruning are exact per instance — the
pooling changes only the schedule, not the search semantics. Pseudo-cost
statistics are shared across instances.

Packed pool layout, as in the reference (it is what makes a wave few
device operations):

- ``meta`` (P+1, 8) f32: [bound, depth, branch_var, branch_dir,
  branch_frac, inst, active, pad] — one gather, one parent scatter and one
  child scatter per wave. The integer ids (inst, branch_var, depth) are
  stored as f32, exact up to 2^24, and converted with ``.long()`` only
  after the gather.
- ``node`` (P+1, nbr+n+2·mt) f32: fixenc ‖ x ‖ z ‖ y, where fixenc is
  −1 = unfixed, 0/1 = fixed value, one per branching group (nbr = nb
  without a ``branch_map``).
- ``pc`` (nbr+1, 2 dirs, 2): [..., 0] the sum of per-unit degradations,
  [..., 1] the observation count — one scatter-add per wave.
- ``inc_xf`` (B+1, n+1): incumbent plan with ``found`` as the trailing
  0/1 column — one winner scatter.

Port decisions:
- JAX scatters drop out-of-bounds indices; here every scattered tensor
  has one dump row (index P, nbr or B) that takes the dropped writes and
  is never read. A non-accumulating ``index_put_`` with duplicate indices
  is nondeterministic on CUDA, so duplicates may only ever land on a dump
  row: selected slots are distinct, the incumbent winner is unique per
  instance (lowest wave row), child-1 targets are distinct free slots.
  ``SCATTER_HOOK`` lets a test watch every such scatter, and the
  pseudo-cost scatter-add ("pc", where duplicates are the normal case).
- Scatter-min is ``scatter_reduce_(..., "amin", include_self=True)``;
  duplicate indices are the normal case there (many wave rows of one
  instance).
- Selection uses ``utils/select.py`` (``lax.top_k`` ties by lower index,
  stable ``argsort``, first-index ``argmax``) over a pool in which most
  priorities are equal (``BIG``, ±1).
- The loop is a Python loop with one host read per wave, which carries
  the continue test (``alive``, the ``rel_gap`` all-done stop) and the
  next wave's probe gate (``probe_patience``), computed at the end of the
  wave before.
- A backend without ``solve_wave`` runs the unfused relax → probe
  composition (``solve`` then ``solve_probe``), as the reference does;
  ``CondensedBackend`` has the fused wave, and on a CUDA tensor it
  launches K2 — there is no batch gate.
- ``branch_map`` (scenario-tree instances of the dense joint frame,
  ops/scenario_tree.py): the pool stores one fix-encoding per
  information-set group and one branching decision fixes every member
  binary (``rep_of`` gathers the group's value into each member's box).
  Member relaxation values are averaged per group (``Mavg``, exact fp32)
  before fractionality and probe rounding, which rounds half to even as
  ``jnp.round`` does. Under a branch map the wave runs the unfused
  composition — on the card a K1 relaxation and the two-part probe, K1
  at ρ·10 then at ρ (K2 rounds per coordinate) — and no node presolve
  fixing (per-coordinate flip deltas do not certify a group flip); the
  certified node bound is kept.
- The single-instance loop's search options ``dive_slots``,
  ``sb_iters``/``sb_fix``, ``depth_tiebreak`` and
  ``branching="flipdelta"`` raise ``NotImplementedError`` here: the
  reference's pooled engine silently ignores the first three and runs
  flip-delta as most-fractional.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.ops.admm import BIG, BoxQP
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.solver.bnb import (
    BnbResult,
    BnbSpec,
    CondensedBackend,
    _flip_delta_bounds,
    _loop_flags,
    _presolve_fix,
    _probe_candidates,
    _pseudocost_score,
    _relax_then_probe,
)
from pyhybridcontrol_tpu_torch.utils.select import first_arg, first_k

# meta column indices
_BOUND, _DEPTH, _BVAR, _BDIR, _BFRAC, _INST, _ACTIVE, _PAD = range(8)

# the reference's alias: CondensedBackend itself dispatches every solve by
# the tensor's device
KernelCondensedBackend = CondensedBackend

# test hook: called as SCATTER_HOOK(name, index, dump_row) before every
# non-accumulating scatter of the wave, and before the pseudo-cost
# scatter-add (name "pc": there duplicate indices are the normal case)
SCATTER_HOOK = None


def _put(dst, idx, src, name: str, accumulate: bool = False):
    """``dst[idx] = src`` (``+=`` with ``accumulate``), where a
    non-accumulating write may duplicate only the dump row (the last row
    of ``dst``)."""
    if SCATTER_HOOK is not None:
        SCATTER_HOOK(name, idx[0] if accumulate else idx, dst.shape[0] - 1)
    if accumulate:
        dst.index_put_(idx, src, accumulate=True)
    else:
        dst[idx] = src


@dataclasses.dataclass
class PooledState:
    """Packed pool (see the module docstring) and loop bookkeeping. Rows
    P, nbr and B of the scattered tensors are dump rows."""

    meta: torch.Tensor         # (P+1, 8) f32 packed per-node metadata
    node: torch.Tensor         # (P+1, nbr+n+2mt) f32: fixenc ‖ x ‖ z ‖ y
    pc: torch.Tensor           # (nbr+1, 2, 2) shared pseudo-costs
    inc_obj: torch.Tensor      # (B,) per-instance incumbent objective
    inc_xf: torch.Tensor       # (B+1, n+1) incumbent plan ‖ found
    nodes_solved: torch.Tensor  # () i64
    overflow: torch.Tensor     # () bool
    alive: torch.Tensor        # () bool
    probe_stale: torch.Tensor  # () i64 — waves since a probe improved ANY
    #                            instance's incumbent (probe gating)
    best_open: torch.Tensor    # (B,) min open bound per instance
    dropped_min: torch.Tensor  # (B+1,) min bound over overflow-dropped
    #                            children per instance


def _init_pool(backend, f, nb: int, P: int) -> PooledState:
    """B roots in slots 0..B-1; ``nb`` fix-encodings a node."""
    B, n = f.shape
    mt = backend.warm_size
    dev, dtype = f.device, f.dtype
    meta = torch.zeros((P + 1, 8), dtype=dtype, device=dev)
    meta[:, _BOUND] = -BIG
    meta[:, _BVAR] = -1.0
    meta[:B, _INST] = torch.arange(B, dtype=dtype, device=dev)
    meta[:B, _ACTIVE] = 1.0
    node = torch.zeros((P + 1, nb + n + 2 * mt), dtype=dtype, device=dev)
    node[:, :nb] = -1.0
    return PooledState(
        meta=meta, node=node,
        pc=torch.zeros((nb + 1, 2, 2), dtype=dtype, device=dev),
        inc_obj=torch.full((B,), BIG, dtype=dtype, device=dev),
        inc_xf=torch.zeros((B + 1, n + 1), dtype=dtype, device=dev),
        nodes_solved=torch.zeros((), dtype=torch.long, device=dev),
        overflow=torch.zeros((), dtype=torch.bool, device=dev),
        alive=torch.ones((), dtype=torch.bool, device=dev),
        probe_stale=torch.zeros((), dtype=torch.long, device=dev),
        best_open=torch.full((B,), -BIG, dtype=dtype, device=dev),
        dropped_min=torch.full((B + 1,), BIG, dtype=dtype, device=dev),
    )


def _pooled_loop(backend, f, h, spec: BnbSpec, pool_slots: int,
                 init_node=None, init_incumbent=None, branch_map=None,
                 return_state: bool = False):
    """f (B, n), h (B, m_ineq). Returns a BnbResult with (B,)-leading
    incumbent fields and global wave/node counters (and the final
    :class:`PooledState` with ``return_state``). ``branch_map``: optional
    (nb,) information-set group id of each binary (module docstring)."""
    bad = [k for k, v in (("dive_slots", spec.dive_slots > 0),
                          ("sb_iters", spec.sb_iters > 0),
                          ("sb_fix", spec.sb_fix),
                          ("depth_tiebreak", spec.depth_tiebreak > 0),
                          ("branching='flipdelta'",
                           spec.branching == "flipdelta")) if v]
    if bad:
        raise NotImplementedError(
            f"the pooled engine does not run the search option(s) {bad} "
            "(the reference's pooled engine ignores them; ROADMAP decision): "
            "solve single instances with solve_miqp_bnb")
    B, n = f.shape
    nb = len(backend.binary_idx)
    P, W, mt = pool_slots, spec.wave_size, backend.warm_size
    dtype, dev = f.dtype, f.device
    if nb == 0:
        raise ValueError("the pooled engine needs at least one binary")
    if P < 2 * B:
        raise ValueError(f"pool_slots {P} < 2*B (roots + warm nodes)")
    if W > P:
        raise ValueError(f"wave_size ({W}) cannot exceed pool_slots ({P})")
    bidx = torch.as_tensor(backend.binary_idx, dtype=torch.long, device=dev)
    rows = torch.arange(W, device=dev)
    rep_of = Mavg = None
    nbr = nb
    if branch_map is not None:
        bm = np.asarray(branch_map, np.int64)
        if bm.shape != (nb,):
            raise ValueError(f"branch_map must have one group id per "
                             f"binary ({nb}), got shape {bm.shape}")
        nbr = int(bm.max()) + 1
        rep_of = torch.as_tensor(bm, device=dev)
        # column-normalised membership: xb @ Mavg are the group means
        Mavg_np = np.zeros((nb, nbr), np.float32)
        Mavg_np[np.arange(nb), bm] = 1.0
        Mavg_np /= np.maximum(Mavg_np.sum(axis=0, keepdims=True), 1.0)
        Mavg = torch.as_tensor(Mavg_np, device=dev)

    def node_bounds(enc):
        """(Wb, n) boxes of fix-encodings ``enc`` (Wb, nbr): a group's
        value is gathered into every member's box."""
        Wb = enc.shape[0]
        if rep_of is not None:
            enc = enc[:, rep_of]
        lb = backend.lb.expand(Wb, n).clone()
        ub = backend.ub.expand(Wb, n).clone()
        fixed = torch.clamp_min(enc, 0.0)
        lb[:, bidx] = fixed
        ub[:, bidx] = torch.where(enc >= 0.0, fixed, 1.0)
        return lb, ub

    def binaries(x):
        """The binaries of x (Wb, n): (Wb, nbr) group means under a
        branch map."""
        xb = x[:, bidx]
        return xb if Mavg is None else xb @ Mavg

    # ---- init: B roots in slots 0..B-1 -------------------------------------
    s = _init_pool(backend, f, nbr, P)
    if init_incumbent is not None:
        obj0, x0V, ok0 = init_incumbent
        s.inc_obj = torch.where(ok0, obj0.to(dtype), s.inc_obj)
        s.inc_xf[:B] = torch.where(
            ok0[:, None],
            torch.cat([x0V.to(dtype), x0V.new_ones((B, 1), dtype=dtype)],
                      dim=-1),
            s.inc_xf[:B])
    if spec.root_iters > spec.qp_iters and spec.warm_start:
        lb0, ub0 = node_bounds(s.node[:B, :nbr])
        r0 = backend.solve(f, h, lb0, ub0, spec.root_iters - spec.qp_iters)
        s.node[:B, nbr:] = torch.cat([r0.x, r0.z, r0.y], dim=-1).to(dtype)
    if init_node is not None:
        # carried-plan warm start per instance: fully-fixed candidate
        # assignments in slots B..2B-1 (bound −BIG → they ride wave 1;
        # their relaxation IS the fixed-binary solve and the probe turns
        # them into incumbents)
        bv0, okn, xw = init_node
        s.meta[B:2 * B, _INST] = torch.arange(B, dtype=dtype, device=dev)
        s.meta[B:2 * B, _ACTIVE] = okn.to(dtype)
        s.node[B:2 * B, :nbr] = torch.clamp(bv0.to(dtype), 0.0, 1.0)
        if spec.warm_start and xw is not None:
            s.node[B:2 * B, nbr:nbr + n] = xw.to(dtype)

    piters = spec.probe_iters or spec.qp_iters
    acc_tol = spec.inc_tol or spec.feas_tol
    # in-kernel probe rounding is per coordinate: no fused wave under a
    # branch map, nor presolve fixing (per-coordinate flip deltas)
    solve_wave = (getattr(backend, "solve_wave", None) if rep_of is None
                  else None)
    presolve = spec.presolve_fix and rep_of is None

    def wave(probe_ran: bool):
        # -- 1. global best-first selection ----------------------------------
        pool = s.meta[:P]
        pool_active = pool[:, _ACTIVE] > 0.0
        pool_bound = pool[:, _BOUND]
        if spec.pool_norm == "relgap":
            # rank by the node's relative room below its own instance's
            # incumbent; instances without an incumbent rank first
            pool_inst = pool[:, _INST].long()
            inc_i = s.inc_obj[pool_inst]
            norm = (pool_bound - inc_i) / torch.clamp_min(inc_i.abs(), 1.0)
            pri_val = torch.where(s.inc_xf[pool_inst, -1] > 0.0, norm, -BIG)
        else:
            pri_val = pool_bound
        sel = first_k(torch.where(pool_active, pri_val, BIG), W)
        m_sel = s.meta[sel]                   # ONE gather for 7 fields
        valid = m_sel[:, _ACTIVE] > 0.0
        ni = m_sel[:, _INST].long()
        parent_bound = m_sel[:, _BOUND]
        n_sel = s.node[sel]                   # ONE gather: enc ‖ x ‖ z ‖ y
        enc = n_sel[:, :nbr]
        fm = enc >= 0.0
        fv = torch.clamp_min(enc, 0.0)

        # -- 2. batched relaxations + gated fused probe ----------------------
        fb, hb = f[ni], h[ni]
        lb, ub = node_bounds(enc)
        warm = None
        if spec.warm_start:
            w_sel = n_sel[:, nbr:]
            warm = (w_sel[:, :n], w_sel[:, n:n + mt], w_sel[:, n + mt:])
        if probe_ran:
            if solve_wave is not None:
                relax, probe, lb_p, ub_p = solve_wave(
                    fb, hb, lb, ub, spec.qp_iters, piters, warm=warm)
            else:
                relax, probe, lb_p, ub_p = _relax_then_probe(
                    backend, fb, hb, lb, ub, spec.qp_iters, piters, warm,
                    lambda r: node_bounds(torch.where(fm, fv, torch.round(
                        torch.clamp(binaries(r.x), 0.0, 1.0)))))
            cand, probe_ok = _probe_candidates(
                backend, relax, probe, lb_p, ub_p, fb, hb, valid, acc_tol)
            probe_x = probe.x
        else:
            relax = backend.solve(fb, hb, lb, ub, spec.qp_iters, warm=warm)
            cand = torch.full_like(relax.obj, BIG)
            probe_ok = torch.zeros_like(valid)
            probe_x = torch.zeros_like(relax.x)

        converged = relax.r_prim_rel < spec.feas_tol
        infeasible = relax.infeas_cert | (relax.r_prim_rel > spec.infeas_tol)
        # certified dual bound (+ per-binary presolve data), valid for ANY
        # iterate; a non-finite certificate falls back to the parent bound
        if presolve:
            cert, flip_delta, retain_side, imp_lo, imp_hi = \
                backend.node_cert(relax, fb, hb, lb, ub)
        else:
            cert = backend.node_bound(relax, fb, hb, lb, ub)
        cert_fin = torch.isfinite(cert)
        cert = torch.where(cert_fin, cert, parent_bound)
        lower = torch.where(valid & ~infeasible,
                            torch.maximum(parent_bound, cert), BIG)

        xb = binaries(relax.x)
        rounded = torch.round(torch.clamp(xb, 0.0, 1.0))
        frac = torch.where(fm, 0.0, torch.abs(xb - rounded))
        integral = frac.amax(dim=1) < spec.int_tol
        fully_fixed = fm.all(dim=1)

        # -- 2b. shared pseudo-cost observation (dump row nbr) ---------------
        bv = m_sel[:, _BVAR].long()
        bdir = m_sel[:, _BDIR].long()
        bf = torch.clamp(m_sel[:, _BFRAC], 0.0, 1.0)
        obs = valid & converged & (bv >= 0)
        gain = torch.clamp_min(lower - parent_bound, 0.0)
        denom = torch.where(bdir == 1, 1.0 - bf, bf)
        contrib = torch.where(obs, gain / torch.clamp_min(denom, 1e-3), 0.0)
        _put(s.pc, (torch.where(obs, bv, nbr), bdir),
             torch.stack([contrib, obs.to(dtype)], dim=-1), "pc",
             accumulate=True)

        # -- 3. per-instance incumbent update (probe candidates only):
        # scatter-min on obj, then a unique-winner scatter for the plan
        # (the lowest wave row wins ties) ------------------------------------
        inc_old = s.inc_obj
        inc_obj = inc_old.clone().scatter_reduce_(0, ni, cand, "amin",
                                                  include_self=True)
        improved = probe_ok & (cand < inc_old[ni]) & (cand <= inc_obj[ni])
        if probe_ran:
            s.probe_stale = torch.where(improved.any(), 0,
                                        s.probe_stale + 1)
        first = torch.full((B,), W, dtype=torch.long, device=dev)
        first.scatter_reduce_(0, ni, torch.where(improved, rows, W), "amin",
                              include_self=True)
        winner = improved & (rows == first[ni])
        _put(s.inc_xf, torch.where(winner, ni, B),
             torch.cat([probe_x, probe_x.new_ones((W, 1))], dim=-1),
             "inc_xf")
        s.inc_obj = inc_obj
        inc_i = inc_obj[ni]
        inc_found_i = s.inc_xf[ni, -1] > 0.0

        # -- 4. prune (per-instance incumbent); leaf candidates met on a
        # probe-gated wave wait for the next probing wave --------------------
        bound_prune = lower >= inc_i - spec.gap
        leaf = fully_fixed | (converged & integral)
        if probe_ran:
            prune = ~valid | infeasible | bound_prune | leaf
        else:
            prune = ~valid | infeasible | bound_prune
        expand = valid & ~prune

        # -- 4b. node presolve (the per-INSTANCE incumbent gates the
        # reduced-cost test) -------------------------------------------------
        if presolve:
            fm2, fv2 = _presolve_fix(
                fm, fv, valid & ~infeasible, parent_bound, cert, cert_fin,
                flip_delta, retain_side, imp_lo, imp_hi, inc_found_i, inc_i,
                spec.gap)
        else:
            fm2, fv2 = fm, fv

        # -- 5. branch -------------------------------------------------------
        child_bound = torch.where(expand, torch.maximum(parent_bound, lower),
                                  parent_bound)
        xbc = torch.clamp(xb, 0.0, 1.0)
        if spec.branching == "pseudocost":
            score = _pseudocost_score(s.pc[:nbr, :, 0], s.pc[:nbr, :, 1],
                                      xbc, frac)
        else:
            score = frac
        jstar = first_arg(torch.where(fm2, -1.0, score), dim=1)
        # presolve may fix EVERYTHING: child-0 keeps (fm2, fv2) as its own
        # leaf, child-1 is dead
        has_branch = (~fm2).any(dim=1)
        branch_hot = (torch.nn.functional.one_hot(jstar, nbr).bool()
                      & has_branch[:, None])
        enc2 = torch.where(fm2, fv2, -1.0)    # post-presolve encoding
        cenc0 = torch.where(branch_hot, 0.0, enc2)
        cenc1 = torch.where(branch_hot, 1.0, enc2)
        cdepth = m_sel[:, _DEPTH] + 1.0
        cbf = torch.gather(xbc, 1, jstar[:, None])[:, 0]
        cbv = torch.where(has_branch, jstar, -1).to(dtype)
        if presolve:
            child0_bound, child1_bound = _flip_delta_bounds(
                child_bound, cert, cert_fin, has_branch, flip_delta,
                retain_side, jstar)
        else:
            child0_bound = child1_bound = child_bound

        # child-0 overwrites the parent slot (instance id unchanged): ONE
        # packed meta scatter and ONE packed node scatter
        zeros, ones = torch.zeros_like(cbf), torch.ones_like(cbf)
        m_child0 = torch.stack([child0_bound, cdepth, cbv, zeros, cbf,
                                m_sel[:, _INST], expand.to(dtype), zeros],
                               dim=1)
        m_closed = m_sel.clone()
        m_closed[:, _ACTIVE] = 0.0
        m_closed[:, _BOUND] = child_bound
        _put(s.meta, sel, torch.where(expand[:, None], m_child0, m_closed),
             "meta_parent")
        w_new = (torch.cat([relax.x, relax.z, relax.y], dim=-1).to(dtype)
                 if spec.warm_start else n_sel[:, nbr:])
        _put(s.node, sel,
             torch.cat([torch.where(expand[:, None], cenc0, enc), w_new],
                       dim=-1), "node_parent")

        # child-1 → globally free slots (best-bound children win); writes
        # with no slot go to the dump row P
        free_score = torch.where(s.meta[:P, _ACTIVE] > 0.0, -1.0, 1.0)
        free_slots = first_k(free_score, W, descending=True)
        slot_free = free_score[free_slots] > 0.0
        c1live = expand & has_branch
        order = first_k(torch.where(c1live, child1_bound, BIG), W)
        write_ok = slot_free & c1live[order]
        tgt = torch.where(write_ok, free_slots, P)
        m_child1 = torch.stack([child1_bound, cdepth, cbv, ones, cbf,
                                m_sel[:, _INST], ones, zeros], dim=1)
        _put(s.meta, tgt, m_child1[order], "meta_child1")
        _put(s.node, tgt, torch.cat([cenc1, w_new], dim=-1)[order],
             "node_child1")
        s.meta[P, _ACTIVE] = 0.0
        drop_mask = c1live[order] & ~slot_free
        s.overflow = s.overflow | drop_mask.any()
        s.dropped_min.scatter_reduce_(
            0, torch.where(drop_mask, ni[order], B),
            torch.where(drop_mask, child1_bound[order], BIG), "amin",
            include_self=True)

        s.alive = (s.meta[:P, _ACTIVE] > 0.0).any()
        s.best_open = _best_open(s, B, P)
        s.nodes_solved = s.nodes_solved + valid.sum()

    waves = 0
    live, probe = True, True      # wave 0: roots active, retry wave
    while waves < spec.max_waves and live:
        wave(probe)
        waves += 1
        cont = s.alive
        found = s.inc_xf[:B, -1] > 0.0
        if spec.rel_gap > 0:
            tol = spec.rel_gap * torch.clamp_min(s.inc_obj.abs(), 1.0)
            done = found & (s.inc_obj - s.best_open <= tol)
            cont = cont & ~done.all()
        live, probe = _loop_flags(spec, cont, found.all(), s.probe_stale,
                                  waves)
    res = BnbResult(x=s.inc_xf[:B, :-1], obj=s.inc_obj,
                    found=s.inc_xf[:B, -1] > 0.0, waves=waves,
                    nodes_solved=s.nodes_solved, overflow=s.overflow,
                    best_open_bound=_best_open(s, B, P))
    return (res, s) if return_state else res


def _best_open(s: PooledState, B: int, P: int):
    """(B,) min bound over each instance's open nodes and its
    overflow-dropped children."""
    pool = s.meta[:P]
    act = pool[:, _ACTIVE] > 0.0
    open_min = torch.full((B,), BIG, dtype=pool.dtype, device=pool.device)
    open_min.scatter_reduce_(0, pool[:, _INST].long(),
                             torch.where(act, pool[:, _BOUND], BIG), "amin",
                             include_self=True)
    return torch.minimum(open_min, s.dropped_min[:B])


def solve_miqp_bnb_pooled(admm: BoxQP, qp: DeviceQP, f, h,
                          spec: BnbSpec = BnbSpec(), pool_slots: int = 0,
                          init_incumbent=None, init_node=None,
                          admm_probe: Optional[BoxQP] = None,
                          branch_map=None,
                          return_state: bool = False):
    """Solve B MIQPs sharing one condensed structure in a single pooled
    B&B on the device of ``f``. f (B, n), h (B, m_ineq) from a batched
    ``qp.assemble``.

    ``pool_slots``: total pool size (0 → 32·B). ``init_incumbent``:
    optional per-instance ``(obj (B,), V (B, n), ok (B,))`` seed.
    ``init_node``: optional ``(bvals (B, nbr), ok (B,), x_warm (B, n) |
    None)`` carried-plan candidates (one value per group under a branch
    map). ``branch_map``: optional (nb,) information-set group id of each
    binary, for scenario-tree instances (ops/scenario_tree.py
    ``tree_branch_map``): one branching decision then fixes every member
    binary of its group.

    Returns a BnbResult whose x/obj/found/best_open_bound carry the (B,)
    instance axis; waves/nodes_solved are global counters. With
    ``return_state`` also the final :class:`PooledState`."""
    B = f.shape[0]
    P = pool_slots or max(32 * B, 2 * B)
    backend = KernelCondensedBackend(admm, qp, admm_probe)
    return _pooled_loop(backend, f, h, spec, P, init_node=init_node,
                        init_incumbent=init_incumbent,
                        branch_map=branch_map, return_state=return_state)
