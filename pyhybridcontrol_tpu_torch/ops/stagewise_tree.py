"""Long-horizon scenario-tree MIQP: consensus ADMM over the stagewise O(N)
frame, on one device or with the scenario axis over ranks.

Counterpart of ``pyhybridcontrol_tpu/ops/stagewise_tree.py``. The dense
joint build (ops/scenario_tree.py) is
O((S·N·nv)²) and the condensed consensus tree (ops/consensus_tree.py)
carries a dense per-scenario KKT inverse; this module composes the
consensus splitting with the stagewise block-tridiagonal frame
(ops/stagewise.py), so a tree with N in the hundreds is O(S·N·b²):

  - each scenario s runs the unweighted stagewise ADMM on its own ω path
    (probabilities ride the scaled-dual change of variables of
    ops/consensus_tree.py: in scaled duals every scenario runs the standard
    iteration and only the consensus prox sees p);
  - non-anticipativity is ``n_cons = nu + nδ`` consensus selector rows per
    stage, stage-local, so K and its sweeps are untouched; their z-update
    is the p-weighted group mean over the scenarios that share the stage-k
    information set, with the weights ``M`` handed to
    ``stagewise_admm_solve`` as a tensor (on the card K5 runs a node's
    scenarios in one block and takes the mean between two barriers);
  - B&B branches on information-set representative coordinates, and the
    backend expands their bounds to every member scenario (one gather
    through ``rep_map``).

Soft rows, move blocking (leader-only branching), terminal sets and
horizon-coupled extra rows (per scenario: the budget holds on every path)
compose. Node bounds are certified: zeroing the consensus duals drops the
coupling, so the p-weighted sum of the per-scenario dual bounds is a valid
lower bound of the tree node. ``StagewiseTreeBackend`` has no
``solve_wave`` and no ``node_cert``, so each B&B wave runs the unfused
relax → round → probe.

``scen_mesh`` ((mesh, axis), or a mesh whose axis is "scen"): each rank
holds S/P scenarios of every node (P must divide S). The group mean then
crosses ranks in every ADMM iteration: a local partial sum over the rank's
scenarios, one ``all_reduce(SUM)``, the rank's own rows. K5 keeps a
node's scenarios in one cluster and cannot hold that, so the iterations
run as the torch loop with K4 as its sweep (ops/stagewise.py). After the
solve one all_gather returns every scenario's iterates and statistics to
every rank, and the B&B loop runs replicated over the joint decision, on
data broadcast from the first rank, so every rank takes the same waves.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import AdmmResult
from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
from pyhybridcontrol_tpu_torch.ops.stagewise import (
    StagewiseQP,
    _with_box,
    assemble_stagewise,
    assemble_stagewise_ext,
    prepare_stagewise,
    stagewise_admm_solve,
    stagewise_dual_bound,
)
from pyhybridcontrol_tpu_torch.solver.bnb import BnbResult, BnbSpec, _bnb_loop
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class StagewiseTreeQP:
    """Prepared stagewise consensus-tree problem."""

    sw: StagewiseQP          # single-scenario stagewise prep, n_cons > 0
    M: torch.Tensor          # (S, S, N) p-weighted group-mean tensor
    probs: torch.Tensor      # (S,)
    omega: torch.Tensor      # (S, N, nω) tree disturbance paths
    S: int
    binary_reps: tuple       # representative coords in the (S·N·b) space
    rep_map: tuple           # (S·N·b) member → representative coord

    @property
    def N(self) -> int:
        return self.sw.N

    @property
    def n(self) -> int:
        """Flat joint decision size S·N·b."""
        return self.S * self.sw.N * self.sw.b


def prepare_stagewise_tree(model: MldModel, tree: ScenarioTree,
                           weights=None, rho: float = 1.0, soft=None,
                           blocking=None, block_deltas: bool = False,
                           terminal=None, device=DEFAULT_DEVICE,
                           **kw) -> StagewiseTreeQP:
    """Host build. ``tree.N`` sets the horizon; soft/blocking/terminal
    compose. Horizon-coupled rows pass through ``extra=(A_v, b, B_x, B_w)``
    (in ``**kw``) with per-scenario semantics: one set of bordered factors
    serves every scenario, and ``assemble_stagewise_tree_ext`` builds each
    scenario's bounds from its own ω path."""
    device = resolve_device(device)
    info = model.info
    N = tree.N
    nud = info.nu + info.ndelta
    sw = prepare_stagewise(model, N, weights, rho=rho, soft=soft,
                           blocking=blocking, block_deltas=block_deltas,
                           terminal=terminal, consensus=nud, device=device,
                           **kw)
    S = tree.S
    p = np.asarray(tree.probs, np.float64)
    g = np.asarray(tree.groups)                      # (S, N)
    M = np.zeros((S, S, N))
    for k in range(N):
        same = g[:, k][:, None] == g[:, k][None, :]
        wgt = same * p[None, :]
        M[:, :, k] = wgt / wgt.sum(axis=1, keepdims=True)

    # branching coordinates in the flat (S·N·b) joint space: the
    # single-scenario branch set (blocking-aware: leaders only), then
    # deduplicated across scenarios by information set
    b = sw.b
    blocked = set(sw.blk_cols)
    per_scen = []
    for k in range(N):
        leader = (not sw.blk_groups or k == 0
                  or sw.blk_groups[k] != sw.blk_groups[k - 1])
        for j in sw.binary_idx_v:
            if int(j) in blocked and not leader:
                continue
            per_scen.append((k, int(j)))
    rep_map = np.arange(S * N * b)
    reps = []
    seen = {}
    for (k, j) in per_scen:
        for s in range(S):
            c = s * N * b + k * b + j
            if j >= nud:                             # uncoupled binary
                reps.append(c)
                continue
            key = (int(g[s, k]), k, j)
            if key not in seen:
                seen[key] = c
                reps.append(c)
            rep_map[c] = seen[key]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    return StagewiseTreeQP(
        sw=sw, M=t(M), probs=t(p), omega=t(tree.omega_paths), S=S,
        binary_reps=tuple(int(r) for r in sorted(reps)),
        rep_map=tuple(int(r) for r in rep_map))


def assemble_stagewise_tree(swt: StagewiseTreeQP, x0, price_seq=None,
                            u_prev=None):
    """Per-scenario stagewise data: q (S, N, b), l/u (S, N, m_k); scenario s
    sees its own tree path ω_s. ``price_seq`` is unweighted (the
    probabilities live in the consensus prox and the objective sum)."""
    parts = [assemble_stagewise(swt.sw, x0, W, price_seq, u_prev)
             for W in swt.omega]
    return tuple(torch.stack(p) for p in zip(*parts))


def assemble_stagewise_tree_ext(swt: StagewiseTreeQP, x0):
    """Per-scenario extra-row bounds (S, r): scenario s's rows see its own
    path, u_ext = b + B_x·x0 + B_w·vec(ω_s). The rows must hold in every
    scenario."""
    return torch.stack([assemble_stagewise_ext(swt.sw, x0, W)
                        for W in swt.omega])


def stagewise_tree_admm_solve(swt: StagewiseTreeQP, q, l, u,
                              iters: int = 200, lb_xi=None, ub_xi=None,
                              warm=None, parallel_sweeps: bool = False,
                              scen_mesh=None, ext_u=None,
                              warm_ext=None) -> AdmmResult:
    """Consensus ADMM over (…, S, N, •) stagewise data. Returns a
    per-problem AdmmResult: x keeps the scenario axis (…, S, N, b),
    obj = Σ_s p_s J_s, the residuals are maxima over scenarios (consensus
    rows measure the non-anticipativity gap), and a node is certified
    infeasible if any scenario alone is. ``scen_mesh``: the scenario axis
    over ranks (module docstring); every rank passes the full data and
    gets the full result."""
    consensus = swt.M
    if scen_mesh is not None:
        from pyhybridcontrol_tpu_torch.parallel.mesh import (
            scenario_shard, sharded_group_mean)

        sh = scenario_shard(scen_mesh, swt.S)

        def loc(t, dim):
            return None if t is None else sh.local(t, t.ndim + dim)

        q, l, u, lb_xi, ub_xi = (loc(t, -3) for t in (q, l, u, lb_xi, ub_xi))
        if warm is not None:
            warm = tuple(loc(t, -3) for t in warm)
        if warm_ext is not None:
            warm_ext = tuple(loc(t, -2) for t in warm_ext)
        ext_u = loc(ext_u, -2)
        consensus = sharded_group_mean(sh, swt.M, swt.S)
    res = stagewise_admm_solve(
        swt.sw, q, l, u, iters=iters, lb_xi=lb_xi, ub_xi=ub_xi,
        warm=warm, parallel_sweeps=parallel_sweeps,
        consensus_M=consensus, ext_u=ext_u, warm_ext=warm_ext)
    if scen_mesh is not None:
        # every scenario's iterates and statistics, in one all_gather
        keys = [k for k in ("x", "z", "y", "obj", "r_prim", "r_prim_rel",
                            "r_dual", "infeas_cert", "z_ext", "y_ext")
                if getattr(res, k) is not None]
        full = sh.gather([getattr(res, k) for k in keys],
                         dim=res.obj.ndim - 1)
        res = dataclasses.replace(res, **dict(zip(keys, full)))
    return dataclasses.replace(
        res,
        obj=(swt.probs.double() * res.obj.double()).sum(-1).float(),
        r_prim=res.r_prim.amax(dim=-1),
        r_prim_rel=res.r_prim_rel.amax(dim=-1),
        r_dual=res.r_dual.amax(dim=-1),
        infeas_cert=res.infeas_cert.any(dim=-1))


@dataclasses.dataclass
class StagewiseTreeBackend:
    """B&B backend over the flat (S·N·b) joint decision: branches on
    information-set representatives and expands bounds to the members via
    ``rep_map`` (one gather), with O(N) node relaxations and a certified
    node bound. ``ext_u``: per-scenario extra-row bounds (S, r), or None."""

    swt: StagewiseTreeQP
    swt_probe: Optional[StagewiseTreeQP] = None
    ext_u: Optional[torch.Tensor] = None
    parallel_sweeps: bool = False
    scen_mesh: object = None

    def __post_init__(self):
        self._rep = torch.as_tensor(self.swt.rep_map, dtype=torch.long,
                                    device=self.swt.probs.device)

    @property
    def n(self):
        return self.swt.n

    @property
    def lb(self):
        return self.swt.sw.lb_xi.reshape(-1).repeat(self.swt.S)

    @property
    def ub(self):
        return self.swt.sw.ub_xi.reshape(-1).repeat(self.swt.S)

    @property
    def binary_idx(self):
        return self.swt.binary_reps

    @property
    def warm_size(self):
        # z and y each append the flattened (S·n_ext) extra-row tail
        sw = self.swt.sw
        return self.swt.S * (sw.N * sw.m_k + sw.n_ext)

    def _shapes(self, f, h, lb, ub, warm):
        swt, sw = self.swt, self.swt.sw
        S, N, b_ = swt.S, sw.N, sw.b
        batch = f.shape[:-1]
        lb = lb[..., self._rep].reshape(lb.shape[:-1] + (S, N, b_))
        ub = ub[..., self._rep].reshape(ub.shape[:-1] + (S, N, b_))
        q = f.reshape(batch + (S, N, b_))
        l = h[..., 0, :, :, :]
        u = h[..., 1, :, :, :]
        warm_ext = None
        if warm is not None:
            m_st = S * N * sw.m_k
            xw, zw, yw = warm
            if sw.n_ext:
                warm_ext = (zw[..., m_st:].reshape(batch + (S, sw.n_ext)),
                            yw[..., m_st:].reshape(batch + (S, sw.n_ext)))
            warm = (xw.reshape(batch + (S, N, b_)),
                    zw[..., :m_st].reshape(batch + (S, N, sw.m_k)),
                    yw[..., :m_st].reshape(batch + (S, N, sw.m_k)))
        return q, l, u, lb, ub, warm, warm_ext, batch

    def solve(self, f, h, lb, ub, iters, warm=None):
        sw = self.swt.sw
        q, l, u, lb_xi, ub_xi, warm, warm_ext, batch = self._shapes(
            f, h, lb, ub, warm)
        res = stagewise_tree_admm_solve(
            self.swt, q, l, u, iters=iters, lb_xi=lb_xi, ub_xi=ub_xi,
            warm=warm, parallel_sweeps=self.parallel_sweeps,
            scen_mesh=self.scen_mesh, ext_u=self.ext_u, warm_ext=warm_ext)
        m_st = self.swt.S * sw.N * sw.m_k
        z_flat = res.z.reshape(batch + (m_st,))
        y_flat = res.y.reshape(batch + (m_st,))
        if sw.n_ext:
            z_flat = torch.cat([z_flat, res.z_ext.reshape(batch + (-1,))],
                               dim=-1)
            y_flat = torch.cat([y_flat, res.y_ext.reshape(batch + (-1,))],
                               dim=-1)
        return dataclasses.replace(
            res, x=res.x.reshape(batch + (self.n,)), z=z_flat, y=y_flat,
            z_ext=None, y_ext=None)

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        if self.swt_probe is None:
            return self.solve(f, h, lb, ub, iters, warm=warm)
        return StagewiseTreeBackend(
            self.swt_probe, ext_u=self.ext_u,
            parallel_sweeps=self.parallel_sweeps,
            scen_mesh=self.scen_mesh).solve(f, h, lb, ub, iters, warm=warm)

    def node_bound(self, res, f, h, lb, ub):
        """p-weighted sum of the per-scenario dual bounds: valid because
        dropping the consensus coupling (whose duals the stagewise bound
        zeroes) relaxes the tree node."""
        swt, sw = self.swt, self.swt.sw
        q, l, u, lb_xi, ub_xi, _, _, batch = self._shapes(f, h, lb, ub, None)
        l, u = _with_box(sw, l, u, lb_xi, ub_xi)
        m_st = swt.S * sw.N * sw.m_k
        res = dataclasses.replace(
            res, x=res.x.reshape(batch + (swt.S, sw.N, sw.b)),
            y=res.y[..., :m_st].reshape(batch + (swt.S, sw.N, sw.m_k)),
            z=res.z[..., :m_st].reshape(batch + (swt.S, sw.N, sw.m_k)),
            y_ext=(res.y[..., m_st:].reshape(batch + (swt.S, sw.n_ext))
                   if sw.n_ext else None),
            z_ext=(res.z[..., m_st:].reshape(batch + (swt.S, sw.n_ext))
                   if sw.n_ext else None))
        bnd = stagewise_dual_bound(sw, q, l, u, res, ext_u=self.ext_u)
        return (swt.probs.double() * bnd.double()).sum(-1).float()

    def broadcast_data(self, f, h, W):
        return f.expand((W,) + f.shape), h.expand((W,) + h.shape)


def pack_stagewise_tree_data(q, l, u):
    """(q, l, u) from ``assemble_stagewise_tree`` → flat (f, h)."""
    return q.reshape(-1), torch.stack([l, u], dim=0)


def solve_tree_miqp_stagewise(swt: StagewiseTreeQP, q, l, u,
                              spec: BnbSpec = BnbSpec(),
                              init_incumbent=None,
                              swt_probe: Optional[StagewiseTreeQP] = None,
                              parallel_sweeps: bool = False,
                              scen_mesh=None, ext_u=None) -> BnbResult:
    """B&B over the stagewise consensus-tree MIQP on the device of ``q``.
    (q, l, u) from ``assemble_stagewise_tree``. Returns a BnbResult whose
    ``x`` is the flat (S·N·b) joint plan (reshape to (S, N, b);
    v_k = ξ_k[:nv]). ``swt_probe``: stiff-ρ prep for the dive probes.
    ``ext_u``: per-scenario extra-row bounds (S, r)
    (``assemble_stagewise_tree_ext``), required when the prep carries
    horizon-coupled rows. ``scen_mesh``: the scenario axis over ranks
    (module docstring); every rank calls it with the same arguments."""
    f, h = pack_stagewise_tree_data(q, l, u)
    if scen_mesh is not None:
        from pyhybridcontrol_tpu_torch.parallel.mesh import (
            replicated, scenario_shard)

        f, h, ext_u, init_incumbent = replicated(
            scenario_shard(scen_mesh, swt.S).comm, f, h, ext_u,
            init_incumbent)
    return _bnb_loop(
        StagewiseTreeBackend(swt, swt_probe, ext_u=ext_u,
                             parallel_sweeps=parallel_sweeps,
                             scen_mesh=scen_mesh),
        f, h, spec, init_incumbent=init_incumbent)
