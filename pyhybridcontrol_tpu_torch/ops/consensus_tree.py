"""Scenario-tree MIQP by consensus ADMM, on one device or with the
scenario axis over ranks.

Counterpart of ``pyhybridcontrol_tpu/ops/consensus_tree.py``. The
reference's ADMM here is plain XLA, so this is plain torch on the card;
the host build is its numpy float64 code.

The dense joint build (ops/scenario_tree.py) forms one O((S·N·nv)²)
condensed H. This module never forms the joint problem: each scenario
keeps its own copy of the single-scenario condensed QP (one shared KKT
inverse for all of them), and non-anticipativity is enforced inside the
ADMM splitting:

  - the single-scenario constraint block gains N·(nu+nδ) unit selector
    rows (one per shared-decision coordinate), and
  - the z-update on those rows replaces the box projection with the
    probability-weighted group mean over the scenarios that share the
    information set — the exact proximal step of the consensus constraint
    (global-variable consensus ADMM, Boyd et al. §7).

Probabilities ride a scaled-dual change of variables: scenario s uses
ρ_s = p_s·ρ and σ_s = p_s·σ, so its KKT matrix is p_s·K with K shared; in
the scaled duals ỹ = y/p_s every scenario runs the standard iteration
(ops/admm.py) and only the consensus z-update sees the probabilities.

B&B: binaries in a shared information set are one decision. The search
branches on set representatives; ``TreeBackend.solve`` expands the
representatives' bounds to every member (one gather through ``rep_map``),
so fixing a set fixes it in all scenarios at once. ``TreeBackend`` has no
``solve_wave`` and no ``node_bound``: the B&B loop (solver/bnb.py) runs
the unfused relax → probe composition and takes uncertified node bounds,
as the reference's does.

Infeasibility: per-scenario dual certificates only (a node is certified
infeasible if any scenario alone is; the sums accumulate in float64, as
everywhere in the port). Cross-scenario consensus infeasibility is not
certified — such nodes stay unconverged and are resolved by deeper
fixing, never by a wrong prune.

``scen_mesh`` ((mesh, axis), or a mesh whose axis is "scen"): each rank
holds S/P scenarios of every node (P must divide S). In every ADMM
iteration the group mean is a local partial sum over the rank's
scenarios, one ``all_reduce(SUM)`` and the rank's own rows
(parallel/mesh.py ``sharded_group_mean``); after the solve one
all_gather returns every scenario's iterates and statistics, so the
residuals are maxima and the certificate an OR over all scenarios, as on
one device. The B&B loop runs replicated on data broadcast from the
first rank.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.ops.admm import (
    BIG,
    AdmmResult,
    BoxQP,
    infeasibility_certificate,
    prepare_admm,
)
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc, DeviceQP
from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
from pyhybridcontrol_tpu_torch.solver.bnb import BnbResult, BnbSpec, _bnb_loop
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass
class TreeConsensusQP:
    """Prepared consensus-ADMM scenario-tree problem."""

    admm: BoxQP              # single-scenario ADMM prep, consensus rows
    #                          appended to the constraint block
    qp: DeviceQP             # single-scenario DeviceQP (assembly)
    M: torch.Tensor          # (S, S, N) p-weighted group-mean tensor:
    #                          mean_s[v] = Σ_t M[s,t,k]·v[t,k,:]
    probs: torch.Tensor      # (S,)
    omega: torch.Tensor      # (S, N, nω) tree disturbance paths
    S: int
    N: int
    nud: int                 # shared coordinates per step (nu + nδ)
    cons0: int               # first consensus row of the constraint block
    binary_reps: Tuple[int, ...]   # representative coords in (S·nV) space
    rep_map: Tuple[int, ...]       # (S·nV) member → representative coord

    @property
    def nV(self) -> int:
        return self.qp.n

    @property
    def ncr(self) -> int:
        return self.N * self.nud


def prepare_tree_consensus(cmpc: CondensedMpc, tree: ScenarioTree,
                           device=DEFAULT_DEVICE,
                           **admm_kw) -> TreeConsensusQP:
    """Host build. ``cmpc`` must be the plain full-v single-scenario
    condensation (the dense joint build's restriction). ``admm_kw`` goes
    to ``prepare_admm`` (e.g. ``rho``)."""
    device = resolve_device(device)
    if cmpc.T_full.shape[0] != cmpc.T_full.shape[1]:
        raise ValueError(
            "consensus tree requires the plain full-v frame (no move "
            "blocking / soft slacks on the single-scenario problem)")
    info = cmpc.info
    S, N, nv, nV = tree.S, tree.N, info.nv, cmpc.nV
    if N != cmpc.N:
        raise ValueError(f"tree N={N} != condensed N={cmpc.N}")
    nud = info.nu + info.ndelta

    # consensus selector rows appended to G: coordinate (k, j<nud)
    E_sel = np.zeros((N * nud, nV))
    for k in range(N):
        for j in range(nud):
            E_sel[k * nud + j, k * nv + j] = 1.0
    cons0 = cmpc.G.shape[0]
    G_aug = np.vstack([cmpc.G, E_sel])
    admm_kw.setdefault("q_typical", cmpc.f0)
    admm_kw.setdefault("binary_idx", cmpc.binary_idx)
    admm_kw.setdefault("boost_rows", getattr(cmpc, "z_rows", None))
    admm = prepare_admm(G_aug, cmpc.H,
                        eq_rows=np.arange(cons0, cons0 + N * nud),
                        device=device, **admm_kw)

    # p-weighted group-mean tensor
    p = np.asarray(tree.probs, np.float64)
    g = np.asarray(tree.groups)                      # (S, N)
    M = np.zeros((S, S, N))
    for k in range(N):
        same = g[:, k][:, None] == g[:, k][None, :]  # (S, S)
        wgt = same * p[None, :]
        M[:, :, k] = wgt / wgt.sum(axis=1, keepdims=True)

    # binary information sets → representatives + member→rep map
    qp = cmpc.device_qp(device)
    rep_map = np.arange(S * nV)
    reps = []
    seen = {}
    for c in qp.binary_idx:                          # per-scenario coord
        k, j = c // nv, c % nv
        if j >= nud:                                 # uncoupled binary
            for s in range(S):
                reps.append(s * nV + c)
            continue
        for s in range(S):
            key = (int(g[s, k]), k, j)
            if key not in seen:
                seen[key] = s * nV + c
                reps.append(s * nV + c)
            rep_map[s * nV + c] = seen[key]

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    return TreeConsensusQP(
        admm=admm, qp=qp, M=t(M), probs=t(p), omega=t(tree.omega_paths),
        S=S, N=N, nud=nud, cons0=cons0,
        binary_reps=tuple(int(r) for r in sorted(reps)),
        rep_map=tuple(int(r) for r in rep_map))


def assemble_tree(tqp: TreeConsensusQP, x0, price_seq=None, u_prev=None):
    """Per-scenario (f, h): scenario s sees its own tree path ω_s.
    ``price_seq`` (N, nv) is unweighted (the consensus iteration carries
    the probabilities). Returns f (S, nV) and h (S, m + ncr) with the
    consensus rows' bounds at +BIG (their z-update never clips)."""
    f, h = tqp.qp.assemble(x0, tqp.omega, u_prev, price_seq)
    f = f.expand(tqp.S, tqp.nV)
    h = h.expand(tqp.S, h.shape[-1])
    free = h.new_full((tqp.S, tqp.ncr), BIG)
    return f, torch.cat([h, free], dim=-1)


def tree_admm_solve(tqp: TreeConsensusQP, f, h, lb, ub, iters: int = 200,
                    warm=None, scen_mesh=None) -> AdmmResult:
    """Consensus ADMM over the scenario axis. f (…, S, nV), h (…, S, m̄g),
    lb/ub (…, S, nV). Returns a per-problem AdmmResult: x keeps the
    scenario axis (…, S, nV); obj = Σ_s p_s J_s; the residuals are maxima
    over scenarios (the consensus rows measure |Ax − group mean|).
    ``scen_mesh``: the scenario axis over ranks (module docstring); every
    rank passes the full data and gets the full result."""
    spec = tqp.admm
    sh = None
    if scen_mesh is not None:
        from pyhybridcontrol_tpu_torch.parallel.mesh import (
            scenario_shard, sharded_group_mean)

        sh = scenario_shard(scen_mesh, tqp.S)
        f, h, lb, ub = (sh.local(t, t.ndim - 2) for t in (f, h, lb, ub))
        if warm is not None:
            warm = tuple(sh.local(t, t.ndim - 2) for t in warm)
        mean_rows = sharded_group_mean(sh, tqp.M, tqp.S)
    rho, alpha, sigma = spec.rho_vec, spec.alpha, spec.sigma
    c = spec.cost_scale
    qh = c * spec.D * f
    m = spec.m_ineq
    lead = h.shape[:-1]
    l_ = torch.cat([h.new_full(lead + (m,), -BIG),
                    torch.clamp(lb * spec.E[m:], -BIG, BIG)], dim=-1)
    u_ = torch.cat([torch.clamp(h * spec.E[:m], -BIG, BIG),
                    torch.clamp(ub * spec.E[m:], -BIG, BIG)], dim=-1)
    batch = qh.shape[:-1]
    n, mt = spec.n, spec.m_total
    c0, c1 = tqp.cons0, tqp.cons0 + tqp.ncr

    if warm is None:
        x = qh.new_zeros(batch + (n,))
        z = torch.clamp(qh.new_zeros(batch + (mt,)), l_, u_)
        y = qh.new_zeros(batch + (mt,))
    else:
        x0w, z0w, y0w = warm
        x = x0w / spec.D
        z = torch.clamp(z0w, l_, u_)
        y = y0w

    A, AT, KinvT = spec.A, spec.A.T, spec.Kinv.T

    def group_mean(v):
        """p-weighted mean over information sets. v (…, S, ncr)."""
        vk = v.reshape(v.shape[:-1] + (tqp.N, tqp.nud))
        if sh is not None:
            return mean_rows(vk).reshape(v.shape)
        out = torch.einsum("stk,...tkj->...skj", tqp.M, vk)
        return out.reshape(v.shape)

    dy = torch.zeros_like(y)
    for _ in range(iters):
        w = rho * z - y
        xt = (sigma * x - qh + w @ A) @ KinvT
        zt = xt @ AT
        zr = alpha * zt + (1.0 - alpha) * z
        s_ = zr + y / rho
        z_new = torch.clamp(s_, l_, u_)
        z_new[..., c0:c1] = group_mean(s_[..., c0:c1])
        y_new = y + rho * (zr - z_new)
        dy = y_new - y
        x, z, y = xt, z_new, y_new

    Ax = x @ AT
    Ax_orig = Ax / spec.E
    viol = torch.abs(Ax - torch.clamp(Ax, l_, u_))
    # consensus rows: the split-variable gap (z holds the group mean) is
    # the non-anticipativity residual
    viol[..., c0:c1] = torch.abs(Ax - z)[..., c0:c1]
    viol = viol / spec.E
    # per scenario, then over scenarios (maxima and an OR are exact in any
    # order, so the split axis changes no bit of them)
    r_prim_s = viol.amax(dim=-1)
    r_rel_s = (viol / torch.clamp_min(Ax_orig.abs(), 1.0)).amax(dim=-1)
    Px = x @ spec.P.T
    dual = (Px + qh + y @ A) / (spec.D * c)
    r_dual_s = dual.abs().amax(dim=-1)
    obj_s = (0.5 * (x.double() * Px.double()).sum(-1)
             + (qh.double() * x.double()).sum(-1)) / c.double()

    # per-scenario infeasibility certificate, consensus dy masked
    dyc = dy.clone()
    dyc[..., c0:c1] = 0.0
    cert_s = infeasibility_certificate(
        dyc, (dyc @ A).abs().amax(dim=-1), l_, u_)
    x = spec.D * x
    if sh is not None:
        x, z, y, obj_s, r_prim_s, r_rel_s, r_dual_s, cert_s = sh.gather(
            [x, z, y, obj_s, r_prim_s, r_rel_s, r_dual_s, cert_s],
            dim=x.ndim - 2)
    obj = (tqp.probs.double() * obj_s).sum(-1).float()
    return AdmmResult(x=x, obj=obj, r_prim=r_prim_s.amax(dim=-1),
                      r_prim_rel=r_rel_s.amax(dim=-1),
                      r_dual=r_dual_s.amax(dim=-1),
                      infeas_cert=cert_s.any(dim=-1), y=y, z=z)


@dataclasses.dataclass
class TreeBackend:
    """B&B backend over the flat (S·nV) joint decision. The loop branches
    on information-set representative coords; ``solve`` expands their
    bounds to every member scenario (one gather through ``rep_map``), so
    one branching decision fixes a whole set. ``tqp_probe``: the stiff-ρ
    prep for dive probes — a fully fixed consensus leaf is the
    implied-equality case over S coupled scenarios, which a stiff ρ
    converges far faster."""

    tqp: TreeConsensusQP
    tqp_probe: Optional[TreeConsensusQP] = None
    scen_mesh: object = None

    def __post_init__(self):
        self._rep = torch.as_tensor(self.tqp.rep_map, dtype=torch.long,
                                    device=self.tqp.probs.device)

    @property
    def n(self):
        return self.tqp.S * self.tqp.nV

    @property
    def lb(self):
        return self.tqp.qp.lb.repeat(self.tqp.S)

    @property
    def ub(self):
        return self.tqp.qp.ub.repeat(self.tqp.S)

    @property
    def binary_idx(self):
        return self.tqp.binary_reps

    @property
    def warm_size(self):
        return self.tqp.S * self.tqp.admm.m_total

    def solve(self, f, h, lb, ub, iters, warm=None):
        tqp = self.tqp
        S, nV = tqp.S, tqp.nV
        batch = f.shape[:-1]
        lb = lb[..., self._rep].reshape(lb.shape[:-1] + (S, nV))
        ub = ub[..., self._rep].reshape(ub.shape[:-1] + (S, nV))
        fr = f.reshape(batch + (S, nV))
        hr = h.reshape(batch + (S, -1))
        if warm is not None:
            xw, zw, yw = warm
            warm = (xw.reshape(batch + (S, nV)), zw.reshape(batch + (S, -1)),
                    yw.reshape(batch + (S, -1)))
        res = tree_admm_solve(tqp, fr, hr, lb, ub, iters=iters, warm=warm,
                              scen_mesh=self.scen_mesh)
        return dataclasses.replace(
            res, x=res.x.reshape(batch + (self.n,)),
            z=res.z.reshape(batch + (self.warm_size,)),
            y=res.y.reshape(batch + (self.warm_size,)))

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        if self.tqp_probe is None:
            return self.solve(f, h, lb, ub, iters, warm=warm)
        return TreeBackend(self.tqp_probe, scen_mesh=self.scen_mesh).solve(
            f, h, lb, ub, iters, warm=warm)

    def broadcast_data(self, f, h, W):
        return f.expand(W, -1), h.expand(W, -1)


def solve_tree_miqp(tqp: TreeConsensusQP, f, h, spec: BnbSpec = BnbSpec(),
                    init_incumbent=None, scen_mesh=None,
                    tqp_probe: Optional[TreeConsensusQP] = None
                    ) -> BnbResult:
    """B&B over the consensus-tree MIQP on the device of ``f``. (f, h) from
    ``assemble_tree`` ((S, nV) / (S, m̄g), flattened here). Returns a
    BnbResult whose x is the flat (S·nV) joint plan (reshape to (S, nV)).
    ``scen_mesh``: the scenario axis over ranks (module docstring); every
    rank calls it with the same arguments."""
    f, h = f.reshape(-1), h.reshape(-1)
    if scen_mesh is not None:
        from pyhybridcontrol_tpu_torch.parallel.mesh import (
            replicated, scenario_shard)

        f, h, init_incumbent = replicated(
            scenario_shard(scen_mesh, tqp.S).comm, f, h, init_incumbent)
    return _bnb_loop(TreeBackend(tqp, tqp_probe, scen_mesh), f, h, spec,
                     init_incumbent=init_incumbent)
