"""Scenario-tree hybrid MPC: branching ω forecasts under non-anticipativity.

Counterpart of ``pyhybridcontrol_tpu/ops/scenario_tree.py``; the host code
is the reference's numpy float64 code.

A tree is S scenario paths ω_s (each a full N-step disturbance sequence)
with probabilities p_s and a branching structure: scenarios that share the
same disturbance prefix up to step k must take the SAME decision at step k
(the controller cannot act on information it does not have yet).

The joint MIQP is S probability-weighted copies of the condensed
single-scenario QP (block-diagonal H, concatenated constraint blocks,
per-scenario W) plus equality rows

    u_{s,k} = u_{s',k},  δ_{s,k} = δ_{s',k}   whenever g(s,k) = g(s',k)

encoded as consecutive-pair double inequalities in G (the ADMM form has
one-sided rows). z stays per scenario: identical prefixes force identical
z through the dynamics anyway.

The result is an ordinary ``CondensedMpc`` whose "horizon" is S·N steps,
so the whole solver stack (ADMM, the kernels, B&B, the pooled engine with
rep-map branching) applies unchanged; the applied input is scenario 0's
step 0 (all scenarios agree before the first branch).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc


@dataclasses.dataclass
class ScenarioTree:
    """S scenario paths with a group structure.

    ``groups[s][k]`` is the information-set id of scenario s at step k;
    scenarios with equal ids at step k share the step-k decision.
    ``from_branching`` builds the standard recombining-prefix structure
    from branch times, e.g. branch_steps=(0, 4) with branch factor 2
    gives 4 scenarios, sharing the k<4 decisions pairwise by prefix.
    """

    omega_paths: np.ndarray          # (S, N, nω)
    probs: np.ndarray                # (S,)
    groups: np.ndarray               # (S, N) int

    @property
    def S(self) -> int:
        return self.omega_paths.shape[0]

    @property
    def N(self) -> int:
        return self.omega_paths.shape[1]

    @classmethod
    def from_branching(cls, omega_paths, probs=None,
                       branch_steps: Sequence[int] = (1,)):
        """Scenarios are the leaves of a tree that branches at
        ``branch_steps``: scenario s's information set at step k is its
        ancestor node, i.e. s grouped by how many branchings happened at
        or before k. ``omega_paths`` are ordered depth-first (scenario
        index = leaf index).

        The default branches at step 1, not 0: a step-0 branch makes every
        scenario its own information set from the start, with no shared
        first-stage decision for ``feedback`` to return."""
        omega_paths = np.asarray(omega_paths, np.float64)
        S, N = omega_paths.shape[:2]
        if probs is None:
            probs = np.full(S, 1.0 / S)
        bs = sorted(branch_steps)
        nb = len(bs)
        # branching factor per level: S^(1/nb) must be an integer
        bf = round(S ** (1.0 / nb)) if nb else 1
        if bf ** nb != S:
            raise ValueError(
                f"S={S} scenarios need an integer branch factor for "
                f"{nb} branch steps")
        groups = np.zeros((S, N), dtype=int)
        for k in range(N):
            levels = sum(1 for b in bs if b <= k)
            # group = leading `levels` digits of s in base bf
            groups[:, k] = np.arange(S) // bf ** (nb - levels)
        return cls(omega_paths=omega_paths, probs=np.asarray(probs),
                   groups=groups)


def build_scenario_tree_qp(cmpc: CondensedMpc, tree: ScenarioTree,
                           tie_eps: float = 0.0) -> CondensedMpc:
    """Joint condensed problem over the tree: a CondensedMpc whose decision
    is the concatenation of S scenario copies (N·nv each; the input must be
    the plain full-v frame — no move blocking or soft slacks).

    Feedback-time data: ``assemble_np`` / ``DeviceQP.assemble`` take
    W = the tree's disturbances stacked scenario-major, (S·N, nω), and
    price_seq (S·N, nv) (``tree_price_seq`` weights it by probability).
    """
    if cmpc.T_full.shape[0] != cmpc.T_full.shape[1]:
        raise ValueError("scenario tree requires the plain full-v frame "
                         "(no move blocking / soft slacks on the input; "
                         "apply them to the joint problem instead)")
    S, N = tree.S, tree.N
    info = cmpc.info
    nv = info.nv
    nV = cmpc.nV
    p = tree.probs

    def bd(mats, scale=None):
        out = np.zeros((S * mats.shape[0], S * mats.shape[1]))
        for s in range(S):
            m = mats if scale is None else scale[s] * mats
            out[s * mats.shape[0]:(s + 1) * mats.shape[0],
                s * mats.shape[1]:(s + 1) * mats.shape[1]] = m
        return out

    joint = cmpc._clone()
    joint.H = bd(cmpc.H, p)
    joint.f0 = np.concatenate([p[s] * cmpc.f0 for s in range(S)])
    joint.Fx = np.vstack([p[s] * cmpc.Fx for s in range(S)])
    joint.Fup = np.vstack([p[s] * cmpc.Fup for s in range(S)])
    joint.Fw = bd(cmpc.Fw, p)
    joint.G = bd(cmpc.G)
    joint.h0 = np.tile(cmpc.h0, S)
    joint.Hx = np.vstack([cmpc.Hx] * S)
    joint.Hw = bd(cmpc.Hw)
    joint.lb = np.tile(cmpc.lb, S)
    joint.ub = np.tile(cmpc.ub, S)
    joint.binary_mask = np.tile(cmpc.binary_mask, S)
    joint.T_full = np.eye(S * nV)
    joint.N = S * N
    # the big-M product rows (z_rows, the ρ-boost rows of prepare_admm)
    # must cover every scenario block; the non-anticipativity rows are
    # appended after the block-diagonal G, so these offsets stay valid
    base_rows = cmpc.G.shape[0]
    zr = getattr(cmpc, "z_rows", None)
    joint.z_rows = (
        np.concatenate([s * base_rows + zr for s in range(S)])
        if zr is not None and len(zr) else np.zeros(0, dtype=int))

    # non-anticipativity: consecutive-pair equalities within each group
    # on the u and δ components (z stays free per scenario)
    nud = info.nu + info.ndelta
    rows = []
    for k in range(N):
        gids = tree.groups[:, k]
        for g in np.unique(gids):
            members = np.nonzero(gids == g)[0]
            for a, b in zip(members[:-1], members[1:]):
                for j in range(nud):
                    r = np.zeros(S * nV)
                    r[a * nV + k * nv + j] = 1.0
                    r[b * nV + k * nv + j] = -1.0
                    rows.append(r)
    if rows:
        R = np.stack(rows)
        nr = R.shape[0]
        joint.G = np.vstack([joint.G, R, -R])
        joint.h0 = np.concatenate([joint.h0, np.full(nr, tie_eps),
                                   np.full(nr, tie_eps)])
        joint.Hx = np.vstack([joint.Hx, np.zeros((2 * nr, info.nx))])
        joint.Hw = np.vstack([joint.Hw,
                              np.zeros((2 * nr, joint.Hw.shape[1]))])
    return joint


def tree_consistent_paths(rng, S: int, N: int,
                          branch_steps: Sequence[int], sd: float = 0.1,
                          nomega: int = 1) -> np.ndarray:
    """Disturbance paths that share their history within information sets
    (branching happens when new information arrives). i.i.d. paths that
    differ inside an information set make shared-δ assignments
    near-infeasible, so rounding probes never land. Returns (S, N, nomega)
    ordered depth-first, as ``ScenarioTree.from_branching`` assumes. Like
    the reference, it does not check that ``S`` is a power of the branch
    factor."""
    paths = np.zeros((S, N, nomega))
    bs = sorted(branch_steps)
    segs = [0] + list(bs) + [N]
    nb = len(bs)
    bf = round(S ** (1.0 / nb)) if nb else 1
    for lvl in range(len(segs) - 1):
        k0, k1 = segs[lvl], segs[lvl + 1]
        groups = bf ** lvl
        draw = rng.normal(0.0, sd, (groups, k1 - k0, nomega))
        for s in range(S):
            paths[s, k0:k1] = draw[s // (S // groups)]
    return paths


def tree_price_seq(tree: ScenarioTree, price_seq: np.ndarray) -> np.ndarray:
    """Probability-weighted per-step linear costs for the joint frame:
    (N, nv) single-scenario prices → (S·N, nv)."""
    return np.concatenate(
        [tree.probs[s] * np.asarray(price_seq) for s in range(tree.S)],
        axis=0)


def tree_branch_map(joint: CondensedMpc, tree: ScenarioTree) -> np.ndarray:
    """Information-set group of each binary column of the joint frame
    (``build_scenario_tree_qp``), in binary order: the key is (group, k, j)
    for a u/δ coordinate j < nu+nδ, and every other binary (z is free per
    scenario) is a group of its own. ``solve_miqp_bnb_pooled(branch_map=)``
    branches once per group."""
    info = joint.info
    nVs = joint.nV // tree.S            # single-scenario width
    nv, nud = info.nv, info.nu + info.ndelta
    groups: dict = {}
    bidx = np.nonzero(joint.binary_mask)[0]
    bm = np.empty(len(bidx), int)
    for ti, col in enumerate(bidx):
        s, off = divmod(int(col), nVs)
        k, j = divmod(off, nv)
        key = (int(tree.groups[s][k]), k, j) if j < nud else ("own", ti)
        bm[ti] = groups.setdefault(key, len(groups))
    return bm
