"""K5's grouped variant on the CPU: the group mean's member lists
(``ops/cuda_stagewise.group_members``) that the FLEX kernel sums over,
its placement of a group (``plan_admm``), and the port's tree relaxation
at the wide trees' group sizes against the JAX package.

Inputs come from numpy seeds and go to both packages. Tolerances: the
member lists expanded equal ``consensus_M`` bitwise; the kernel's mean in
member order, emulated in fp32, within 1e-6 of max |input| of the JAX
package's ``_group_mean`` (an fp32 einsum in another order); the tree
relaxation as ``test_tree_of_16_scenarios_matches_reference``
(tests/test_torch_stagewise_tree.py: objective 1e-4 relative, x 1e-3)."""

import pathlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.ops import stagewise_tree as jst
from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst
from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
    ScenarioTree, tree_consistent_paths)

torch.set_num_threads(2)

# config 6's long arm (N=120) and chip_smoke.py's wide trees: (S, branch
# steps) on tree-consistent paths of sd 0.2 from default_rng(S); config 6's
# own tree is S=8 branching at 1, 40, 80
TREES = {"config6": (8, (1, 40, 80)), "wide16": (16, (1, 30, 60, 90)),
         "wide27": (27, (1, 40, 80)),
         "wide64": (64, (1, 20, 40, 60, 80, 100))}
N6 = 120


def _omega_model():
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    return JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


ROOT = pathlib.Path(__file__).resolve().parents[1]
JM = _omega_model()
TM = convert.mld_model(JM)
JW = jdi.default_weights()
X0 = np.array([2.0, 0.0], np.float32)


def _tree_M(key):
    """The port's group-mean weights (S, S, N) of tree ``key``, as its
    stagewise tree prep builds them."""
    S, steps = TREES[key]
    tree = ScenarioTree.from_branching(
        tree_consistent_paths(np.random.default_rng(S), S, N6, steps,
                              sd=0.2), branch_steps=steps)
    swt = tst.prepare_stagewise_tree(TM, tree, tdi.default_weights(),
                                     device="cpu")
    return swt.M


def _random_M(S=9, N=7, seed=5):
    """Weights with no tree behind them: every scenario's row distinct at
    every stage, a fifth of them zero (one a −0), stages 3 and 4 equal
    (one run of two stages)."""
    rng = np.random.default_rng(seed)
    M = rng.normal(size=(S, S, N)).astype(np.float32)
    M[rng.random(M.shape) < 0.2] = 0.0
    M[0, 1, 0] = -0.0
    M[:, :, 4] = M[:, :, 3]
    return torch.from_numpy(M)


def _lists(words, S, N):
    """The member lists ``words`` (``group_members``) as, for each stage k
    and scenario s, the list of (t, weight) in its order."""
    w = words.numpy()
    out = {}
    for k in range(N):
        for s in range(S):
            o = int(w[k]) + 2 * s
            q0, q1 = int(w[o]), int(w[o + 1])
            pairs = w[q0:q1].reshape(-1, 2)
            out[k, s] = (pairs[:, 0].astype(np.int64),
                         pairs[:, 1].view(np.float32))
    return out


@pytest.mark.parametrize("key", list(TREES) + ["random"])
def test_member_lists_expand_to_consensus_M(key):
    """Each (stage, scenario) list, its weights written back at (s, t, k),
    gives consensus_M bit for bit where it is nonzero and a zero where it
    is zero; each list is in ascending t and holds no zero weight. A tree's
    lists are its nodes': as many runs as branch steps plus one, and the
    pairs no more than one list of S members a run."""
    M = _random_M() if key == "random" else _tree_M(key)
    S, _, N = M.shape
    words = cs.group_members(M)
    assert words.dtype == torch.int32 and words.device == M.device
    lists = _lists(words, S, N)
    got = np.zeros((S, S, N), np.float32)
    for (k, s), (t, wt) in lists.items():
        assert np.all(np.diff(t) > 0) and np.all(wt != 0)
        got[s, t, k] = wt
    Mn = M.numpy()
    nz = Mn != 0
    assert np.array_equal(got.view(np.uint32)[nz], Mn.view(np.uint32)[nz])
    assert np.all(got[~nz] == 0)
    runs = len(set(words[:N].tolist()))
    if key == "random":
        assert runs == N - 1
    else:
        assert runs == len(TREES[key][1]) + 1
        head = (N + 3) // 4 * 4 + 2 * S * runs
        assert words.numel() - head == 2 * S * runs


@pytest.mark.parametrize("key", ["wide27", "wide64", "random"])
def test_member_order_mean_matches_reference_group_mean(key):
    """The kernel's mean, emulated: for each scenario, stage and consensus
    row, zn = fma(w_t, v_t, zn) in fp32 over the list in its order (the
    fma's product exact in fp64, the sum rounded to fp32), on a seeded
    batch of two nodes' consensus blocks (2, S, N, 2); against the JAX
    package's ``_group_mean`` on the same weights and block, within 1e-6
    of max |input|."""
    M = _random_M() if key == "random" else _tree_M(key)
    S, _, N = M.shape
    v = np.random.default_rng(S).normal(
        size=(2, S, N, 2)).astype(np.float32)
    lists = _lists(cs.group_members(M), S, N)
    got = np.zeros_like(v)
    for (k, s), (t, wt) in lists.items():
        zn = np.zeros((2, 2), np.float32)
        for tj, wj in zip(t, wt):
            zn = (np.float64(wj) * v[:, tj, k, :].astype(np.float64)
                  + zn.astype(np.float64)).astype(np.float32)
        got[:, s, k, :] = zn
    mean = jst._group_mean(types.SimpleNamespace(M=jnp.asarray(M.numpy())))
    want = np.asarray(mean(jnp.asarray(v)))
    err = float(np.abs(got - want).max())
    print(f"{key}: max |Δ| {err:.2e} (max |v| {np.abs(v).max():.3f})")
    assert err <= 1e-6 * float(np.abs(v).max())


def _zero_rows_M(S=9, N=5, seed=11):
    """Weights where some scenarios' rows are all zero at some stages: an
    empty member list, which begins where the next new row's list does
    (scenario 1 at stage 0, between two distinct rows; scenarios 4 and 7
    at stage 2, a −0 row among them; the whole of stage 4)."""
    M = _random_M(S, N, seed).numpy()
    M[1, :, 0] = 0.0
    M[4, :, 2] = 0.0
    M[7, :, 2] = -0.0
    M[:, :, 4] = 0.0
    return torch.from_numpy(M)


def _node_first(w, k, s, s0):
    """csrc/stagewise.cu ``node_first``, mirrored: the first of the
    scenarios s0 … s whose list at stage k is scenario s's, by both of
    its words."""
    run = int(w[k])
    q0, q1 = w[run + 2 * s], w[run + 2 * s + 1]
    while w[run + 2 * s0] != q0 or w[run + 2 * s0 + 1] != q1:
        s0 += 1
    return s0


def test_node_first_mirrors_the_kernel_source():
    """The emulation's search is the kernel's: it compares a list's begin
    and end words."""
    src = (ROOT / "pyhybridcontrol_tpu_torch" / "csrc"
           / "stagewise.cu").read_text()
    assert "while (run[s0].x != q.x || run[s0].y != q.y) ++s0;" in src


@pytest.mark.parametrize("key", ["zero_rows", "wide27", "random"])
@pytest.mark.parametrize("spc", [1, 2, 4, 9])
def test_shared_node_mean_matches_reference_group_mean(key, spc):
    """The FLEX kernel's mean as a CTA of ``spc`` scenarios shares it: at
    each stage, the first scenario of a node in the CTA (``node_first``)
    sums its list in fp32 fma order, and the node's other scenarios there
    read that sum; against the JAX package's ``_group_mean`` on the same
    weights and a seeded consensus block, within 1e-6 of max |input|. An
    all-zero row's empty list, which begins where the next list does,
    is a node of its own."""
    M = {"zero_rows": _zero_rows_M, "random": _random_M,
         "wide27": lambda: _tree_M("wide27")}[key]()
    S, _, N = M.shape
    v = np.random.default_rng(spc).normal(
        size=(S, N, 2)).astype(np.float32)
    words = cs.group_members(M)
    w = words.numpy()
    lists = _lists(words, S, N)
    got = np.full_like(v, np.nan)
    for c0 in range(0, S, spc):
        sums = {}
        for s in range(c0, min(c0 + spc, S)):
            for k in range(N):
                f = _node_first(w, k, s, c0)
                if f == s:
                    zn = np.zeros(2, np.float32)
                    t, wt = lists[k, s]
                    for tj, wj in zip(t, wt):
                        zn = (np.float64(wj) * v[tj, k].astype(np.float64)
                              + zn.astype(np.float64)).astype(np.float32)
                    sums[k, s] = zn
                got[s, k] = sums[k, f]
    mean = jst._group_mean(types.SimpleNamespace(M=jnp.asarray(M.numpy())))
    want = np.asarray(mean(jnp.asarray(v[None])))[0]
    err = float(np.abs(got - want).max())
    assert err <= 1e-6 * float(np.abs(v).max()), err


def test_group_plan_stages_the_lists_where_they_fit():
    """The wide trees' waves (8 nodes): portable clusters of ⌈S/8⌉
    scenarios a CTA; their member lists staged beside the constants, and
    read from device memory where staging them would not fit, with the
    same placement; the grouped variant's earlier placement (⌈S/16⌉ a CTA,
    non-portable clusters) forced through ``spc``; a group whose slots
    would be under a warp falls back to ⌈S/16⌉, and a forced spc that gives
    no cluster of 16 raises."""
    # the words of the wide trees' lists (group_members)
    for S, words, want in ((16, 440, ("grouped", 2, 8)),
                           (27, 552, ("grouped", 4, 7)),
                           (64, 1912, ("global", 8, 8))):
        shape = (8 * S, N6, 5, 19, S, 0, 1, 2, True)
        pl = cs.plan_admm(*shape, members=words)
        assert (pl.variant, pl.spc, pl.cluster, pl.lists) == want + (words,)
        assert pl.smem == cs.flex_smem_bytes(
            N6, 5, 19, 0, 1, 2, True, pl.warps, pl.staged, pl.bmax, pl.spc,
            cs.ADMM_PLACES[pl.variant], lists=words, S=S)
        big = cs.plan_admm(*shape, members=60000)
        assert (big.variant, big.spc, big.cluster, big.lists) == want + (0,)
        assert big.smem == cs.plan_admm(*shape).smem
        spc = -(-S // 16)
        old = cs.plan_admm(*shape, members=words, variant="grouped", spc=spc)
        assert (old.variant, old.spc, old.cluster) == ("grouped", spc,
                                                       -(-S // spc))
        assert old.smem <= cs.SMEM_MAX
    pl = cs.plan_admm(8 * 200, 24, 5, 19, 200, 0, 1, 2, True)
    assert (pl.spc, pl.cluster) == (13, 16)
    with pytest.raises(ValueError, match="no cluster of at most 16"):
        cs.plan_admm(8 * 64, N6, 5, 19, 64, 0, 1, 2, True, spc=2)


@pytest.mark.parametrize("S,steps", [(27, (1, 4, 8)),
                                     (64, (1, 3, 5, 7, 9, 11))])
def test_wide_tree_relaxation_matches_reference(S, steps):
    """Trees of S=27 (a group that does not divide over the grouped
    variant's CTAs) and S=64 (N=12): the consensus relaxation, 60
    iterations on the reference's prep carried across, against the
    reference's: objective within 1e-4 relative, x within 1e-3 (the largest
    difference printed)."""
    paths = np.random.default_rng(S).normal(0.0, 0.3, size=(S, 12, 1))
    jt = JTree.from_branching(paths, branch_steps=steps)
    js = jst.prepare_stagewise_tree(JM, jt, JW)
    ts = convert.stagewise_tree_qp(js, "cpu")
    assert ts.M.shape == (S, S, 12)
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(X0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(X0))
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=60)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=60)
    got, want = np.asarray(tr.obj, np.float64), np.asarray(jr.obj, np.float64)
    assert np.max(np.abs(got - want) / np.maximum(np.abs(want), 1.0)) <= 1e-4
    dx = np.abs(tr.x.numpy() - np.asarray(jr.x))
    print(f"S={S}: objective {float(tr.obj):.9f} (reference "
          f"{float(jr.obj):.9f}), max |Δx| {float(dx.max()):.2e}")
    assert np.max(dx / np.maximum(np.abs(np.asarray(jr.x)), 1.0)) <= 1e-3
