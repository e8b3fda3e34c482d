"""The port's scenario tree on the stagewise O(N) frame
(ops/stagewise_tree.py) and the controller's stagewise tree, against the
reference's ops/stagewise_tree.py (tests/test_stagewise_tree.py), the
port's condensed consensus tree and the port's fp64 oracle, on the CPU.

Inputs come from numpy seeds and go to both packages; trees are carried
across with ``convert.scenario_tree``. Tolerances: the information-set maps
and the group-mean tensor equal; ``stagewise_tree_admm_solve`` at fixed
iterations as tests/test_torch_stagewise.py holds the single frame
(objective 1e-4 relative, iterates 1e-3); B&B objectives within 1e-3
(relative, floor 1) of the reference's and first inputs within 3e-2; the
fp64 oracle and the condensed consensus tree in a common frame within 5e-3
(the reference's); non-anticipativity within 2e-3."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.ops import stagewise_tree as jst
from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
from pyhybridcontrol_tpu.ops.scenario_tree import (
    tree_consistent_paths as j_tree_consistent_paths,
)
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

torch.set_num_threads(2)


def _omega_models():
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    jm = JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    return jm, convert.mld_model(jm)


JM, TM = _omega_models()
JW, TW = jdi.default_weights(), tdi.default_weights()
X0 = np.array([2.0, 0.0], np.float32)


def _tree(S=4, N=6, steps=(1, 3), seed=3):
    """tests/test_stagewise_tree.py's fixture tree (S=4, N=6, branching at
    1 and 3) by default, in both packages."""
    paths = np.random.default_rng(seed).normal(0.0, 0.3, size=(S, N, 1))
    jt = JTree.from_branching(paths, branch_steps=steps)
    return jt, convert.scenario_tree(jt)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(1.0, abs(float(b)))


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))
    assert err <= tol, f"error {err:.3e} above {tol:.1e}"


def test_rep_dedup_and_group_mean_match_reference():
    """1 + 2·2 + 4·3 = 17 coupled δ representatives, as the port's condensed
    consensus tree has; the representatives, the member map and the
    p-weighted group-mean tensor equal the reference's; under move blocking
    the blocked inputs branch at leaders only."""
    from pyhybridcontrol_tpu_torch.ops.consensus_tree import (
        prepare_tree_consensus)

    jt, tt = _tree()
    js = jst.prepare_stagewise_tree(JM, jt, JW)
    ts = tst.prepare_stagewise_tree(TM, tt, TW, device="cpu")
    assert ts.binary_reps == js.binary_reps and ts.rep_map == js.rep_map
    assert len(ts.binary_reps) == 17
    np.testing.assert_allclose(ts.M.numpy(), np.asarray(js.M), rtol=1e-7)
    np.testing.assert_allclose(ts.probs.numpy(), np.asarray(js.probs))
    tq = prepare_tree_consensus(CondensedMpc(TM, 6, TW), tt, device="cpu")
    assert len(tq.binary_reps) == 17
    blk = dict(blocking=[0, 0, 1, 1, 2, 2], block_deltas=True)
    jb = jst.prepare_stagewise_tree(JM, jt, JW, **blk)
    tb = tst.prepare_stagewise_tree(TM, tt, TW, device="cpu", **blk)
    assert tb.binary_reps == jb.binary_reps and tb.rep_map == jb.rep_map
    assert len(tb.binary_reps) < 17


def test_tree_relaxation_matches_reference_and_is_nonanticipative():
    """The consensus relaxation on the reference's prep carried across:
    200 iterations against the reference's; run to 1500 it is converged and
    agrees across every information set on the shared coordinates."""
    jt, tt = _tree()
    js = jst.prepare_stagewise_tree(JM, jt, JW)
    ts = convert.stagewise_tree_qp(js, "cpu")
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(X0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(X0))
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=200)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=200)
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    for k in ("x", "z", "y"):
        _close(getattr(tr, k).numpy(), getattr(jr, k), 1e-3)
    assert bool(tr.infeas_cert) == bool(jr.infeas_cert)
    r = tst.stagewise_tree_admm_solve(ts, *td, iters=1500)
    assert float(r.r_prim_rel) < 1e-3
    V = r.x.numpy()
    g = np.asarray(tt.groups)
    for k in range(tt.N):
        for gid in np.unique(g[:, k]):
            vals = V[g[:, k] == gid, k, :2]
            assert np.ptp(vals, axis=0).max() < 2e-3


def test_tree_of_16_scenarios_matches_reference():
    """A tree of S=16 scenarios (N=24, branching at 1, 6, 12 and 18): a
    group the shared K5 variant cannot hold in one portable cluster, the
    grouped one takes on the card. Its consensus relaxation, 60 iterations
    on the reference's prep carried across, against the reference's:
    objective within 1e-4 relative, x within 1e-3 (the largest difference
    printed)."""
    jt, _ = _tree(S=16, N=24, steps=(1, 6, 12, 18), seed=16)
    js = jst.prepare_stagewise_tree(JM, jt, JW)
    ts = convert.stagewise_tree_qp(js, "cpu")
    assert ts.M.shape == (16, 16, 24)
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(X0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(X0))
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=60)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=60)
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    dx = float(np.abs(tr.x.numpy() - np.asarray(jr.x)).max())
    print(f"S=16: objective {float(tr.obj):.9f} (reference "
          f"{float(jr.obj):.9f}), max |Δx| {dx:.2e}")
    _close(tr.x.numpy(), jr.x, 1e-3)


def test_tree_backend_solve_and_node_bound_match_reference():
    """One wave of nodes through both packages' tree backends with a
    per-scenario budget row: representative bounds expanded to members,
    warm vectors with the S·n_ext tail, the p-weighted certified bound."""
    jt, tt = _tree(S=2, N=4, steps=(1,), seed=7)
    N, nv = 4, 3
    A_v = np.zeros((1, N * nv))
    A_v[0, 0::nv] = 1.0
    extra = (A_v, np.array([-0.8]))
    js = jst.prepare_stagewise_tree(JM, jt, JW, extra=extra)
    ts = convert.stagewise_tree_qp(js, "cpu")
    jq, jl, ju = jst.assemble_stagewise_tree(js, jnp.asarray(X0))
    je = jst.assemble_stagewise_tree_ext(js, jnp.asarray(X0))
    tq, tl, tu = tst.assemble_stagewise_tree(ts, torch.as_tensor(X0))
    te = tst.assemble_stagewise_tree_ext(ts, torch.as_tensor(X0))
    np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)
    jb = jst.StagewiseTreeBackend(js, ext_u=je)
    tb = tst.StagewiseTreeBackend(ts, ext_u=te)
    assert tb.warm_size == jb.warm_size == 2 * (N * ts.sw.m_k + 1)
    assert tb.binary_idx == jb.binary_idx
    jf, jh = jb.broadcast_data(*jst.pack_stagewise_tree_data(jq, jl, ju), 3)
    tf, th = tb.broadcast_data(*tst.pack_stagewise_tree_data(tq, tl, tu), 3)
    lb = np.broadcast_to(np.asarray(jb.lb), (3, tb.n)).copy()
    ub = np.broadcast_to(np.asarray(jb.ub), (3, tb.n)).copy()
    reps = list(tb.binary_idx)
    lb[1, reps[:2]] = ub[1, reps[:2]] = 1.0
    lb[2, reps[1::2]] = ub[2, reps[1::2]] = 0.0
    j1 = jb.solve(jf, jh, jnp.asarray(lb), jnp.asarray(ub), 150)
    j2 = jb.solve(jf, jh, jnp.asarray(lb), jnp.asarray(ub), 60,
                  warm=(j1.x, j1.z, j1.y))
    warm = tuple(torch.as_tensor(np.array(a)) for a in (j1.x, j1.z, j1.y))
    t2 = tb.solve(tf, th, torch.as_tensor(lb), torch.as_tensor(ub), 60,
                  warm=warm)
    for k in ("obj", "x", "z", "y"):
        _close(getattr(t2, k).numpy(), getattr(j2, k), 1e-3)
    jn = jb.node_bound(j2, jf, jh, jnp.asarray(lb), jnp.asarray(ub))
    tn = tb.node_bound(t2, tf, th, torch.as_tensor(lb), torch.as_tensor(ub))
    _close(tn.numpy(), jn, 2e-3)


# the row kinds composed on a tree (S=2, N=4) with the group mean and a warm
# start: soft stage rows with the budget row, and with move blocking and a
# terminal set too
TREE_MIXES = {
    "soft+extra": {},
    "soft+extra+blocking+terminal": dict(
        blocking=[0, 0, 1, 1],
        terminal=(np.array([[1.0, 0.0]]), np.array([1.5]))),
}


@pytest.mark.parametrize("mix", list(TREE_MIXES))
def test_tree_soft_extra_rows_and_warm_start_match_reference(mix):
    """Soft rows, a per-scenario budget row and the consensus group mean at
    once, through both packages' tree solves: 150 iterations cold, then 60
    warm from the reference's iterate (x, z, y and the extra rows' z/y)."""
    jt, tt = _tree(S=2, N=4, steps=(1,), seed=7)
    N, nv, nc = 4, 3, JM.info.ncons
    A_v = np.zeros((1, N * nv))
    A_v[0, 0::nv] = 1.0
    kw = dict(soft=(np.array([1, nc + 2, 3 * nc]), 20.0, 2.0),
              extra=(A_v, np.array([-0.8])), **TREE_MIXES[mix])
    js = jst.prepare_stagewise_tree(JM, jt, JW, **kw)
    ts = convert.stagewise_tree_qp(js, "cpu")
    assert ts.sw.has_soft and ts.sw.n_ext == 1 and ts.sw.n_cons == 2
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(X0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(X0))
    je = jst.assemble_stagewise_tree_ext(js, jnp.asarray(X0))
    te = tst.assemble_stagewise_tree_ext(ts, torch.as_tensor(X0))
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=150, ext_u=je)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=150, ext_u=te)
    for k in ("obj", "x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tr, k).numpy(), getattr(jr, k), 1e-3)
    jw = jst.stagewise_tree_admm_solve(
        js, *jd, iters=60, ext_u=je, warm=(jr.x, jr.z, jr.y),
        warm_ext=(jr.z_ext, jr.y_ext))
    w = [torch.as_tensor(np.array(a)) for a in
         (jr.x, jr.z, jr.y, jr.z_ext, jr.y_ext)]
    tw = tst.stagewise_tree_admm_solve(ts, *td, iters=60, ext_u=te,
                                       warm=tuple(w[:3]),
                                       warm_ext=tuple(w[3:]))
    for k in ("obj", "x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tw, k).numpy(), getattr(jw, k), 1e-3)
    assert bool(tw.infeas_cert) == bool(jw.infeas_cert)


def test_tree_miqp_matches_reference():
    """Bench config 6's parity arm (S=2, N=4, branching at 1, paths of
    default_rng(11)) through both packages' stagewise tree B&B."""
    rng = np.random.default_rng(11)
    jt = JTree.from_branching(rng.normal(0.0, 0.3, size=(2, 4, 1)),
                              branch_steps=(1,))
    tt = convert.scenario_tree(jt)
    spec = dict(capacity=256, wave_size=16, qp_iters=300, probe_iters=1500,
                max_waves=24)
    js, jsp = (jst.prepare_stagewise_tree(JM, jt, JW, rho=r)
               for r in (1.0, 10.0))
    jr = jst.solve_tree_miqp_stagewise(
        js, *jst.assemble_stagewise_tree(js, jnp.asarray(X0)),
        JSpec(**spec), swt_probe=jsp)
    ts, tsp = (tst.prepare_stagewise_tree(TM, tt, TW, rho=r, device="cpu")
               for r in (1.0, 10.0))
    tr = tst.solve_tree_miqp_stagewise(
        ts, *tst.assemble_stagewise_tree(ts, torch.as_tensor(X0)),
        BnbSpec(**spec), swt_probe=tsp)
    assert bool(jr.found) and bool(tr.found)
    assert _rel(tr.obj, jr.obj) <= 1e-3
    xt = tr.x.reshape(2, 4, ts.sw.b).numpy()
    xj = np.asarray(jr.x).reshape(2, 4, ts.sw.b)
    np.testing.assert_allclose(xt[:, 0, 0], xj[:, 0, 0], atol=3e-2)
    assert np.ptp(xt[:, 0, :2], axis=0).max() < 2e-3   # shared first stage


def _joint_value(joint, fo, xi, nv):
    V = xi[:, :, :nv].reshape(-1).astype(np.float64)
    return float(0.5 * V @ joint.H @ V + fo @ V)


def _chip_smoke():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_tree_extra_rows_match_the_fp64_joint_oracle():
    """A per-scenario input budget rides the shared bordered factors
    batched over the scenarios (tests/test_stagewise_tree.py's case at
    N=3): the plan, valued on the dense joint frame with the row
    block-replicated per scenario, within 5e-3 of the port's fp64 oracle
    (``chip_smoke.oracle_bnb``, a branch and bound on fp64 QP solves,
    exact as the enumeration oracle is: tests/test_torch_kernels.py); the
    budget holds per scenario and binds in one."""
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
        build_scenario_tree_qp)

    S, N, nv = 2, 3, 3
    _, tt = _tree(S=S, N=N, steps=(1,), seed=7)
    A_v = np.zeros((1, N * nv))
    A_v[0, 0::nv] = 1.0
    b_e = np.array([-0.8])
    joint = build_scenario_tree_qp(CondensedMpc(TM, N, TW), tt)
    A_joint = np.zeros((S, S * N * nv))
    for s in range(S):
        A_joint[s, s * N * nv:(s + 1) * N * nv] = A_v[0]
    joint = joint.with_extra_constraints(A_joint, np.repeat(b_e, S))
    W = np.asarray(tt.omega_paths, np.float64).reshape(S * N, 1)
    fo, ho = joint.assemble_np(X0.astype(np.float64), W)
    orc, _ = _chip_smoke().oracle_bnb(joint, fo, ho)
    assert np.isfinite(orc)

    ts, tsp = (tst.prepare_stagewise_tree(TM, tt, TW, rho=r,
                                          extra=(A_v, b_e), device="cpu")
               for r in (1.0, 10.0))
    x0 = torch.as_tensor(X0)
    ue = tst.assemble_stagewise_tree_ext(ts, x0)
    assert ue.shape == (S, 1)
    spec = BnbSpec(capacity=128, wave_size=16, max_waves=16, qp_iters=200,
                   probe_iters=1000)
    res = tst.solve_tree_miqp_stagewise(
        ts, *tst.assemble_stagewise_tree(ts, x0), spec, swt_probe=tsp,
        ext_u=ue)
    assert bool(res.found)
    xi = res.x.reshape(S, N, ts.sw.b).numpy()
    np.testing.assert_allclose(_joint_value(joint, fo, xi, nv), orc,
                               rtol=5e-3, atol=5e-3)
    sums = xi[:, :, 0].sum(axis=1)
    assert np.all(sums <= -0.8 + 2e-3) and np.any(sums >= -0.8 - 5e-2)
    assert np.ptp(xi[:, 0, 0]) < 2e-3


def test_controller_stagewise_tree_runs_the_tree_solve():
    """``MpcController(solver="stagewise").set_scenario_tree(tree)`` builds
    the stagewise tree at ρ and ρ·10 and its ``feedback`` is
    ``solve_tree_miqp_stagewise`` on the tree's own paths (the same plan and
    objective), with the first input shared by every scenario and the
    planned states; ``feedback_batch`` (vmap) repeats it per instance.
    (The tree solve itself is held to the reference's in
    ``test_tree_miqp_matches_reference``.)"""
    _, tt = _tree(S=2, N=4, steps=(1,), seed=5)
    spec = BnbSpec(capacity=128, wave_size=16, max_waves=16, qp_iters=200,
                   probe_iters=1000)
    tc = MpcController(TM, 4, TW, solver="stagewise", bnb_spec=spec,
                       device="cpu")
    tc.set_scenario_tree(tt)
    swt = tc.stagewise
    assert swt.S == 2 and swt.sw.n_cons == 2 and tc._swt_probe.sw.rho_rows[
        0, 0] == 10.0 * swt.sw.rho_rows[0, 0]
    calls = []
    orig = tst.solve_tree_miqp_stagewise

    def spy(*a, **kw):
        calls.append((a, kw, orig(*a, **kw)))
        return calls[-1][2]

    tst.solve_tree_miqp_stagewise = spy
    try:
        got = tc.feedback(X0)
    finally:
        tst.solve_tree_miqp_stagewise = orig
    (a, kw, ref), = calls
    assert a[0] is swt and kw["swt_probe"] is tc._swt_probe
    for t, want in zip(a[1:4], tst.assemble_stagewise_tree(
            swt, torch.as_tensor(X0))):
        assert torch.equal(t, want)            # the tree's own paths
    assert bool(got.found) and float(got.obj) == float(ref.obj)
    xi = ref.x.reshape(2, 4, swt.sw.b)
    assert torch.equal(got.v_seq, xi[:, :, :3].reshape(8, 3))
    assert torch.equal(got.x_seq, xi[:, :, 3:])
    assert torch.equal(got.u, xi[0, 0, :1])
    assert np.ptp(xi[:, 0, :2].numpy(), axis=0).max() < 2e-3
    assert float(got.gap) >= 0.0
    batch = tc.feedback_batch(X0[None])
    np.testing.assert_array_equal(batch.obj.numpy(), [float(got.obj)])


@pytest.mark.slow
def test_tree_miqp_matches_condensed_consensus():
    """The full fixture tree (S=4, N=6): the stagewise-frame optimum equals
    the port's condensed consensus optimum when both plans are valued in
    the condensed frame, and the first stage is shared
    (tests/test_stagewise_tree.py)."""
    from pyhybridcontrol_tpu_torch.ops.consensus_tree import (
        assemble_tree, prepare_tree_consensus, solve_tree_miqp)

    _, tt = _tree()
    x0 = torch.as_tensor(X0)
    spec = BnbSpec(capacity=256, wave_size=32, max_waves=48, qp_iters=600,
                   probe_iters=3000)
    c = CondensedMpc(TM, 6, TW)
    tqp, tqp_p = (prepare_tree_consensus(c, tt, rho=r, device="cpu")
                  for r in (1.0, 10.0))
    ref = solve_tree_miqp(tqp, *assemble_tree(tqp, x0), spec,
                          tqp_probe=tqp_p)
    ts, tsp = (tst.prepare_stagewise_tree(TM, tt, TW, rho=r, device="cpu")
               for r in (1.0, 10.0))
    res = tst.solve_tree_miqp_stagewise(
        ts, *tst.assemble_stagewise_tree(ts, x0), spec, swt_probe=tsp)
    assert bool(ref.found) and bool(res.found)
    S, N, nv = 4, 6, 3
    xi = res.x.reshape(S, N, ts.sw.b).numpy()

    def J(V_sn):
        om = np.asarray(tt.omega_paths)
        tot = 0.0
        for s in range(S):
            fs, _ = c.assemble_np(X0.astype(np.float64), om[s])
            tot += tt.probs[s] * (0.5 * V_sn[s] @ c.H @ V_sn[s]
                                  + fs @ V_sn[s])
        return tot

    J_sw = J(xi[:, :, :nv].reshape(S, -1).astype(np.float64))
    J_ref = J(ref.x.reshape(S, -1).double().numpy())
    np.testing.assert_allclose(J_sw, J_ref, rtol=5e-3, atol=5e-3)
    assert np.ptp(xi[:, 0, 0]) < 2e-3


@pytest.mark.slow
def test_config6_at_the_bench_cpu_shape():
    """Bench config 6's long arm at the bench's own CPU-smoke shape
    (bench.py:773-774: N=24, S=4, branching at 1 and 12, paths of
    default_rng(11) after the parity arm's draw, Σu ≤ 60, the bench's
    spec): the reference's objective and first input."""
    N6, S6, bs6 = 24, 4, (1, 12)
    rng6 = np.random.default_rng(11)
    rng6.normal(0.0, 0.3, size=(2, 4, 1))       # the parity arm's draw
    jt = JTree.from_branching(
        j_tree_consistent_paths(rng6, S6, N6, bs6, sd=0.2),
        branch_steps=bs6)
    tt = convert.scenario_tree(jt)
    A_v = np.zeros((1, N6 * 3))
    A_v[0, 0::3] = 1.0
    extra = (A_v, np.array([60.0]), None, None)
    spec = dict(capacity=64, wave_size=8, max_waves=6, qp_iters=150,
                probe_iters=1000, gap=1e-3)
    js, jsp = (jst.prepare_stagewise_tree(JM, jt, JW, rho=r, extra=extra)
               for r in (1.0, 10.0))
    jr = jst.solve_tree_miqp_stagewise(
        js, *jst.assemble_stagewise_tree(js, jnp.asarray(X0)),
        JSpec(**spec), swt_probe=jsp,
        ext_u=jst.assemble_stagewise_tree_ext(js, jnp.asarray(X0)))
    ts, tsp = (tst.prepare_stagewise_tree(TM, tt, TW, rho=r, extra=extra,
                                          device="cpu")
               for r in (1.0, 10.0))
    x0 = torch.as_tensor(X0)
    tr = tst.solve_tree_miqp_stagewise(
        ts, *tst.assemble_stagewise_tree(ts, x0), BnbSpec(**spec),
        swt_probe=tsp, ext_u=tst.assemble_stagewise_tree_ext(ts, x0))
    assert bool(jr.found) and bool(tr.found)
    assert _rel(tr.obj, jr.obj) <= 1e-3
    xt = tr.x.reshape(S6, N6, 5).numpy()
    xj = np.asarray(jr.x).reshape(S6, N6, 5)
    np.testing.assert_allclose(xt[0, 0, :2], xj[0, 0, :2], atol=3e-2)
