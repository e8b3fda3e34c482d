"""The port's scenario trees on the dense joint frame (ops/scenario_tree.py,
the pooled engine's ``branch_map``, the controller's tree paths) against
the reference's, on the CPU.

Inputs are drawn from numpy seeds and go to both packages; the reference's
``ScenarioTree`` and ``MldModel`` are carried across (convert.py).
Tolerances are the reference tests' own: the host build is float64 numpy
in both packages, every field at 1e-12; controller and B&B objectives
within rtol = atol = 1e-3 (tests/test_scenario_tree.py), a shared
first-stage decision within 2e-2, the pooled tree within 1e-3 (relative,
floor 1) of the fp64 enumeration oracle on the joint frame
(tests/test_bnb_pooled.py). Results are compared on objectives and plans,
never on node counts."""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.ops import scenario_tree as jst
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as jprep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.bnb import solve_miqp_bnb as jbnb
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import scenario_tree as tst
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver import bnb_pooled
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import (
    CondensedBackend, _pooled_loop)
from pyhybridcontrol_tpu_torch.solver.oracle import (
    solve_miqp_enumeration_oracle)

torch.set_num_threads(2)

FIELDS = ("H", "f0", "Fx", "Fup", "Fw", "G", "h0", "Hx", "Hw", "lb", "ub",
          "binary_mask", "T_full", "z_rows")
SPEC = dict(capacity=512, wave_size=32, qp_iters=500, max_waves=48)
TOL = 1e-3


def _omega_models():
    """The double integrator with an additive velocity disturbance (the
    reference tests' and bench config 4c's model), in both packages."""
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    jm = JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    return jm, convert.mld_model(jm)


JM, TM = _omega_models()


def _trees(case):
    """(reference tree, port tree, N) of a named case: config 4c's tree
    (bench.py:668-673) and the reference tests' S=2 and S=4 trees."""
    if case == "config4c":
        N = 10
        paths = jst.tree_consistent_paths(np.random.default_rng(13), 4, N,
                                          (1, 5), sd=0.2)
        jt = jst.ScenarioTree.from_branching(paths, branch_steps=(1, 5))
    elif case == "S2_N4":
        N = 4
        omega = np.zeros((2, N, 1))
        omega[0, 2:], omega[1, 2:] = 0.8, -0.8
        jt = jst.ScenarioTree.from_branching(omega, branch_steps=(2,))
    else:
        N = 6
        paths = np.random.default_rng(3).normal(0.0, 0.3, size=(4, N, 1))
        jt = jst.ScenarioTree.from_branching(paths, branch_steps=(1, 3))
    return jt, convert.scenario_tree(jt), N


def _joints(case):
    jt, tt, N = _trees(case)
    jj = jst.build_scenario_tree_qp(
        JCondensed(JM, N, jdi.default_weights()), jt)
    tj = tst.build_scenario_tree_qp(
        CondensedMpc(TM, N, tdi.default_weights()), tt)
    return jt, tt, jj, tj, N


# ---- (a) the host build ----------------------------------------------------

@pytest.mark.parametrize("S,N,steps", [
    (4, 6, (0, 3)), (4, 6, (1, 3)), (4, 10, (1, 5)), (2, 4, (1,)),
    (2, 4, (2,)), (8, 5, (1, 2, 4)), (9, 4, (1, 3))])
def test_from_branching_groups_match_reference(S, N, steps):
    omega = np.random.default_rng(S * N).normal(size=(S, N, 1))
    jt = jst.ScenarioTree.from_branching(omega, branch_steps=steps)
    tt = tst.ScenarioTree.from_branching(omega, branch_steps=steps)
    np.testing.assert_array_equal(tt.groups, jt.groups)
    np.testing.assert_array_equal(tt.probs, jt.probs)
    np.testing.assert_array_equal(tt.omega_paths, jt.omega_paths)
    assert (tt.S, tt.N) == (S, N)
    if steps == (0, 3):        # the reference test's own tree
        np.testing.assert_array_equal(tt.groups[:, 0], [0, 0, 1, 1])
        np.testing.assert_array_equal(tt.groups[:, 3], [0, 1, 2, 3])
    for mod in (jst, tst):
        with pytest.raises(ValueError, match="branch factor"):
            mod.ScenarioTree.from_branching(np.zeros((3, 4, 1)),
                                            branch_steps=(1, 2))


@pytest.mark.parametrize("S,N,steps,sd,nomega", [
    (4, 10, (1, 5), 0.2, 1), (4, 6, (1, 3), 0.1, 2), (8, 6, (1, 2, 4), 0.3,
                                                      1)])
def test_tree_consistent_paths_match_reference(S, N, steps, sd, nomega):
    j = jst.tree_consistent_paths(np.random.default_rng(13), S, N, steps,
                                  sd=sd, nomega=nomega)
    t = tst.tree_consistent_paths(np.random.default_rng(13), S, N, steps,
                                  sd=sd, nomega=nomega)
    np.testing.assert_array_equal(t, j)
    # members of an information set share their history
    g = tst.ScenarioTree.from_branching(t, branch_steps=steps).groups
    for k in range(N):
        for gid in np.unique(g[:, k]):
            mem = np.nonzero(g[:, k] == gid)[0]
            assert np.all(t[mem, :k + 1] == t[mem[0], :k + 1])


@pytest.mark.parametrize("case", ["config4c", "S2_N4", "S4_N6"])
def test_joint_frame_matches_reference(case):
    """Every field of ``build_scenario_tree_qp`` at 1e-12; config 4c's
    frame is n=120, m=444 with 40 binaries."""
    jt, tt, jj, tj, N = _joints(case)
    for k in FIELDS:
        a, b = np.asarray(getattr(jj, k)), np.asarray(getattr(tj, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-12, err_msg=k)
    assert tj.N == jj.N == tt.S * N and tj.nV == tt.S * N * TM.info.nv
    np.testing.assert_array_equal(tj.binary_idx, jj.binary_idx)
    if case == "config4c":
        assert (tj.nV, tj.G.shape[0], len(tj.binary_idx)) == (120, 444, 40)
    # the fp32 device assembly of the stacked (S·N, nω) forecast
    W = tt.omega_paths.reshape(tt.S * N, 1)
    x0 = np.array([1.5, -0.5])
    f, h = tj.device_qp("cpu").assemble(
        torch.as_tensor(x0, dtype=torch.float32),
        torch.as_tensor(W, dtype=torch.float32))
    fo, ho = tj.assemble_np(x0, W)
    np.testing.assert_allclose(f.double().numpy(), fo, rtol=1e-5,
                               atol=1e-5 * np.abs(fo).max())
    np.testing.assert_allclose(h.double().numpy(), ho, rtol=1e-5,
                               atol=1e-5 * np.abs(ho).max())


def test_tree_price_seq_weighting():
    for mod in (jst, tst):
        tree = mod.ScenarioTree.from_branching(
            np.zeros((2, 3, 1)), probs=np.array([0.7, 0.3]),
            branch_steps=(1,))
        ps = mod.tree_price_seq(tree, np.ones((3, 4)))
        assert ps.shape == (6, 4)
        np.testing.assert_allclose(ps[:3], 0.7)
        np.testing.assert_allclose(ps[3:], 0.3)


# ---- (b) rep-map groups ----------------------------------------------------

def test_config4c_group_ids_match_reference(monkeypatch):
    """The branch map the reference's ``_feedback_batch_pooled`` hands its
    pool equals the port's (``tree_branch_map`` and the controller's):
    29 information-set groups over config 4c's 40 binaries (1 + 4·2 +
    5·4)."""
    import pyhybridcontrol_tpu.solver.bnb_pooled as jpooled

    jt, tt, N = _trees("config4c")
    got = {}

    def stop(tag):
        def fn(*a, branch_map=None, **kw):
            got[tag] = np.asarray(branch_map)
            raise RuntimeError("stop here")
        return fn

    monkeypatch.setattr(jpooled, "solve_miqp_bnb_pooled", stop("ref"))
    monkeypatch.setattr(
        "pyhybridcontrol_tpu_torch.control.mpc.solve_miqp_bnb_pooled",
        stop("port"))
    x0s = np.zeros((2, 2), np.float32)
    jc = JController(JM, N, jdi.default_weights())
    jc.set_scenario_tree(jt)
    tc = MpcController(TM, N, tdi.default_weights(), device="cpu")
    tc.set_scenario_tree(tt)
    for c, x in ((jc, jnp.asarray(x0s)), (tc, x0s)):
        with pytest.raises(RuntimeError, match="stop here"):
            c.feedback_batch(x, engine="pooled")
    np.testing.assert_array_equal(got["port"], got["ref"])
    np.testing.assert_array_equal(
        tst.tree_branch_map(tc.condensed, tt), got["ref"])
    assert got["port"].max() + 1 == 29 and len(got["port"]) == 40


# ---- (c) the reference tests' mirrors ---------------------------------------

def test_scenario_tree_non_anticipativity():
    """Scenarios diverging at step 2 share their decisions for k < 2; the
    port's B&B on its joint frame matches the reference's."""
    jt, tt, jj, tj, N = _joints("S2_N4")
    x0 = np.array([1.0, 0.0], np.float32)
    W = tt.omega_paths.reshape(tt.S * N, 1).astype(np.float32)
    jq = jj.device_qp()
    jf, jh = jq.assemble(jnp.asarray(x0), jnp.asarray(W))
    jr = jbnb(jprep(jj), jq, jf, jh, JSpec(**SPEC))
    tq = tj.device_qp("cpu")
    tf, th = tq.assemble(torch.as_tensor(x0), torch.as_tensor(W))
    tr = solve_miqp_bnb(prepare_admm_mpc(tj, device="cpu"), tq, tf, th,
                        BnbSpec(**SPEC))
    assert bool(tr.found) and bool(jr.found)
    np.testing.assert_allclose(float(tr.obj), float(jr.obj), rtol=TOL,
                               atol=TOL)
    V = tr.x.numpy().reshape(tt.S, N, TM.info.nv)
    np.testing.assert_allclose(V[0, :2, :2], V[1, :2, :2], atol=2e-2)
    assert not np.allclose(V[0, 2:, 0], V[1, 2:, 0], atol=1e-2)


def test_scenario_tree_matches_single_when_identical():
    """A 2-scenario tree of identical paths gives the single-scenario
    solution (rtol 5e-3), and the reference's tree objective."""
    N, S = 4, 2
    omega = np.full((S, N, 1), 0.3)
    tt = tst.ScenarioTree.from_branching(omega, branch_steps=(2,))
    c = CondensedMpc(TM, N, tdi.default_weights())
    tj = tst.build_scenario_tree_qp(c, tt)
    x0 = torch.tensor([1.5, 0.5])
    W = torch.as_tensor(omega.reshape(S * N, 1), dtype=torch.float32)
    tq = tj.device_qp("cpu")
    r_tree = solve_miqp_bnb(prepare_admm_mpc(tj, device="cpu"), tq,
                            *tq.assemble(x0, W), BnbSpec(**SPEC))
    q1 = c.device_qp("cpu")
    r_one = solve_miqp_bnb(prepare_admm_mpc(c, device="cpu"), q1,
                           *q1.assemble(x0, W[:N]), BnbSpec(**SPEC))
    assert bool(r_tree.found) and bool(r_one.found)
    np.testing.assert_allclose(float(r_tree.obj), float(r_one.obj),
                               rtol=5e-3, atol=5e-3)
    V0 = r_tree.x.numpy().reshape(S, N, -1)[0]
    V1 = r_one.x.numpy().reshape(N, -1)
    np.testing.assert_allclose(V0[:, 0], V1[:, 0], atol=3e-2)
    jj = jst.build_scenario_tree_qp(
        JCondensed(JM, N, jdi.default_weights()),
        jst.ScenarioTree.from_branching(omega, branch_steps=(2,)))
    jq = jj.device_qp()
    jr = jbnb(jprep(jj), jq, *jq.assemble(jnp.asarray(x0.numpy()),
                                          jnp.asarray(W.numpy())),
              JSpec(**SPEC))
    np.testing.assert_allclose(float(r_tree.obj), float(jr.obj), rtol=TOL,
                               atol=TOL)


def test_controller_scenario_tree_feedback():
    """``set_scenario_tree`` + ``feedback`` against the reference
    controller (and the ops-level joint solve); N-row prices are weighted
    by probability; transforms on a tree are refused."""
    jt, tt, _, tj, N = _joints("S2_N4")
    x0 = np.array([1.0, 0.0], np.float32)
    prices = np.tile([[0.1, -0.05, 0.0]], (N, 1)).astype(np.float32)
    jc = JController(JM, N, jdi.default_weights(), bnb_spec=JSpec(**SPEC))
    jc.set_scenario_tree(jt)
    tc = MpcController(TM, N, tdi.default_weights(),
                       bnb_spec=BnbSpec(**SPEC), device="cpu")
    assert tc.set_scenario_tree(tt) is tc
    for P in (None, prices):
        jr = jc.feedback(jnp.asarray(x0), price_seq=P)
        tr = tc.feedback(x0, price_seq=P)
        assert bool(tr.found) and bool(jr.found)
        np.testing.assert_allclose(float(tr.obj), float(jr.obj), rtol=TOL,
                                   atol=TOL)
        assert tuple(tr.v_seq.shape) == (tt.S * N, TM.info.nv)
        V = tr.v_seq.numpy().reshape(tt.S, N, -1)
        np.testing.assert_allclose(V[0, :2], V[1, :2], atol=2e-2)
        np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u),
                                   atol=2e-2)
    # S·N-row prices are taken as the joint frame's own
    tw = tc.feedback(x0, price_seq=tst.tree_price_seq(tt, prices))
    np.testing.assert_allclose(float(tw.obj), float(tr.obj), rtol=TOL,
                               atol=TOL)
    assert tc.repair is None                # no repair seed under a tree
    with pytest.raises(ValueError, match="price_seq"):
        tc.feedback(x0, price_seq=np.zeros((3, 3)))
    tc.set_soft_constraints([0])
    with pytest.raises(ValueError, match="transforms"):
        tc.build()


# ---- (d) the pooled tree against the fp64 oracle ---------------------------

def _pooled_vs_oracle(N, spec, wave, slots):
    """feedback_batch(engine="pooled") on S=2 trees (branching at step 1)
    against the fp64 enumeration oracle on the joint frame."""
    tree = tst.ScenarioTree.from_branching(
        np.random.default_rng(3).normal(0.0, 0.3, size=(2, N, 1)),
        branch_steps=(1,))
    tc = MpcController(TM, N, tdi.default_weights(), device="cpu")
    tc.set_scenario_tree(tree)
    tc.bnb_spec = BnbSpec(**spec)
    x0s = np.array([[2.0, 0.0], [-1.5, 1.0]], np.float32)
    res = tc.feedback_batch(x0s, engine="pooled", pooled_wave=wave,
                            pool_slots=slots)
    joint = tc.condensed
    W = tree.omega_paths.reshape(2 * N, 1)
    for i, x0 in enumerate(x0s):
        fo, ho = joint.assemble_np(x0, W)
        orc = solve_miqp_enumeration_oracle(joint.H, fo, joint.G, ho,
                                            joint.lb, joint.ub,
                                            joint.binary_idx)
        assert orc.status == "optimal" and bool(res.found[i])
        rel = abs(float(res.obj[i]) - orc.obj) / max(1.0, abs(orc.obj))
        assert rel < 1e-3, f"instance {i}: rel {rel:.2e}"
    return tc, x0s, res


def test_pooled_scenario_tree_matches_oracle_small():
    """The fast-lane case: N=2 (4 binaries in 3 groups; the oracle's
    group-inconsistent leaves are infeasible and slow to refuse), and the
    vmap engine (one dense-tree ``feedback`` per instance) on the same
    batch."""
    tc, x0s, res = _pooled_vs_oracle(
        2, dict(capacity=256, wave_size=32, qp_iters=600, probe_iters=1500,
                max_waves=32), 64, 256)
    rv = tc.feedback_batch(x0s, engine="vmap")
    assert bool(rv.found.all())
    np.testing.assert_allclose(rv.obj.numpy(), res.obj.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(rv.u.numpy(), res.u.numpy(), atol=2e-2)
    assert tuple(res.v_seq.shape) == (2, 4, TM.info.nv)


@pytest.mark.slow
def test_pooled_scenario_tree_matches_oracle():
    """tests/test_bnb_pooled.py's case at its size: N=4, the reference's
    spec, wave 128, pool 1024."""
    _pooled_vs_oracle(4, dict(capacity=512, wave_size=32, qp_iters=600,
                              probe_iters=3000, max_waves=48), 128, 1024)


# ---- (e) one decision fixes its group; every scatter to a dump row ---------

def test_one_branching_decision_fixes_every_member(monkeypatch):
    """Under a branch map every relaxation and probe sees the same box for
    all members of a group, no fused wave runs, and the pseudo-cost
    scatter's misses go to its dump row nbr."""
    jt, tt, _, tj, N = _joints("S4_N6")
    bm = tst.tree_branch_map(tj, tt)
    nbr = int(bm.max()) + 1
    assert nbr == 17 and len(bm) == 24       # 1 + 2·2 + 4·3 groups
    qp = tj.device_qp("cpu")
    bidx = np.asarray(qp.binary_idx)
    boxes, scat = [], {}

    class Recording(CondensedBackend):
        def solve(self, f, h, lb, ub, iters, warm=None):
            boxes.append((lb.clone(), ub.clone()))
            return super().solve(f, h, lb, ub, iters, warm=warm)

        def solve_wave(self, *a, **kw):
            raise AssertionError("no fused wave under a branch map")

    def hook(name, idx, dump):
        assert int(idx.min()) >= 0 and int(idx.max()) <= dump, name
        scat.setdefault(name, set()).add(dump)

    monkeypatch.setattr(bnb_pooled, "SCATTER_HOOK", hook)
    backend = Recording(prepare_admm_mpc(tj, device="cpu"), qp,
                        prepare_admm_mpc(tj, rho=10.0, device="cpu"))
    x0s = torch.tensor([[2.0, 0.0], [-1.0, 0.5], [0.5, 1.5]])
    W = torch.as_tensor(tt.omega_paths.reshape(tt.S * N, 1),
                        dtype=torch.float32)
    f, h = qp.assemble(x0s, W.expand(3, -1, -1))
    res, st = _pooled_loop(
        backend, f, h, BnbSpec(capacity=256, wave_size=32, max_waves=12,
                               qp_iters=300, probe_iters=600,
                               probe_patience=1),
        256, branch_map=bm, return_state=True)
    assert len(boxes) > 12 and bool(res.found.any())
    for lb, ub in boxes:
        for g in range(nbr):
            cols = bidx[bm == g]
            assert torch.equal(lb[:, cols], lb[:, cols[:1]].expand(
                -1, len(cols)))
            assert torch.equal(ub[:, cols], ub[:, cols[:1]].expand(
                -1, len(cols)))
    assert scat["pc"] == {nbr} and st.pc.shape == (nbr + 1, 2, 2)
    assert st.node.shape[1] == nbr + qp.n + 2 * backend.warm_size
    enc = st.node[:256, :nbr]
    assert bool(((enc == -1) | (enc == 0) | (enc == 1)).all())
    # plans of found instances keep every group integral and shared
    for i in np.nonzero(res.found.numpy())[0]:
        xb = res.x[i, bidx].numpy()
        assert np.all(np.abs(xb - np.round(xb)) < 1e-2)
        for g in range(nbr):
            assert np.ptp(np.round(xb[bm == g])) == 0
    # group means at exactly 0.5 round half to even, as jnp.round does
    half = torch.tensor([0.5, 1.5, 2.5])
    np.testing.assert_array_equal(torch.round(half).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(half))))


# ---- (h) refusals ------------------------------------------------------------

def test_scenario_tree_refusals():
    jt, tt, N = _trees("S2_N4")
    tc = MpcController(TM, N, tdi.default_weights(), device="cpu")
    # trees over ranks (tests/test_torch_sharded_scenarios.py): the mesh
    # is kept, and one without a "scen" axis is refused at the solve
    no_scen = types.SimpleNamespace(mesh_dim_names=("pool",))
    tc.set_scenario_tree(tt, consensus=True, scen_mesh=no_scen)
    with pytest.raises(ValueError, match="no axis 'scen'"):
        tc.feedback(np.array([1.0, 0.0], np.float32))
    sc = MpcController(TM, N, solver="stagewise", device="cpu")
    sc.set_scenario_tree(tt, scen_mesh=no_scen)
    with pytest.raises(ValueError, match="no axis 'scen'"):
        sc.feedback(np.array([1.0, 0.0], np.float32))
    from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tswt

    swt = sc.stagewise
    q, l, u = tswt.assemble_stagewise_tree(swt, torch.tensor([1.0, 0.0]))
    with pytest.raises(ValueError, match="no axis 'scen'"):
        tswt.stagewise_tree_admm_solve(swt, q, l, u, scen_mesh=no_scen)
    step0 = tst.ScenarioTree.from_branching(np.zeros((2, N, 1)),
                                            branch_steps=(0,))
    with pytest.raises(ValueError, match="step 0"):
        tc.set_scenario_tree(step0)
    tc.set_scenario_tree(tt, consensus=True)
    with pytest.raises(ValueError, match="pooled"):
        tc.feedback_batch(np.zeros((2, 2), np.float32), engine="pooled")
    for setter in (lambda c: c.set_move_blocking([0, 0, 1, 1]),
                   lambda c: c.set_terminal_constraint(np.eye(2),
                                                       np.ones(2))):
        c = MpcController(TM, N, tdi.default_weights(), device="cpu")
        setter(c.set_scenario_tree(tt))
        with pytest.raises(ValueError, match="transforms"):
            c.build()
    tj = tst.build_scenario_tree_qp(
        CondensedMpc(TM, N, tdi.default_weights()), tt)
    with pytest.raises(ValueError, match="full-v"):
        tst.build_scenario_tree_qp(
            CondensedMpc(TM, N, tdi.default_weights()).with_move_blocking(
                [0, 0, 1, 1]), tt)
    qp = tj.device_qp("cpu")
    f, h = qp.assemble(torch.zeros(1, 2))
    for kw in (dict(dive_slots=2), dict(sb_iters=50), dict(sb_fix=True),
               dict(depth_tiebreak=1e-2), dict(branching="flipdelta")):
        spec = BnbSpec(capacity=64, wave_size=16, max_waves=4, qp_iters=50,
                       **kw)
        with pytest.raises(NotImplementedError, match="pooled.*ROADMAP"):
            bnb_pooled.solve_miqp_bnb_pooled(
                prepare_admm_mpc(tj, device="cpu"), qp, f, h, spec,
                branch_map=tst.tree_branch_map(tj, tt))
