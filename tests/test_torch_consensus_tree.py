"""The port's consensus-ADMM scenario tree (ops/consensus_tree.py) and the
B&B loop's backend hooks, against the reference's, on the CPU.

Inputs are drawn from numpy seeds and go to both packages; the reference's
tree, model and prepared ADMM data are carried across (convert.py), so a
difference is arithmetic. Tolerances: ``tree_admm_solve`` at fixed
iterations as tests/test_torch_admm.py holds ``admm_solve`` (objective
1e-4 relative, x and z 1e-3, residuals 1e-2 relative, identical
certificate bits); consensus against the dense joint build as the
reference's tests/test_consensus_tree.py (objective 2e-3, first input
2e-2, a shared first stage within 1e-3); B&B objectives within 1e-3
(tests/test_scenario_tree.py)."""

import dataclasses
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
from pyhybridcontrol_tpu.ops import consensus_tree as jct
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as jprep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
from pyhybridcontrol_tpu.solver import bnb as jbnb
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import consensus_tree as tct
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver import bnb as tbnb

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


def _tree(S=4, N=6, steps=(1, 3), seed=3):
    """The reference test's fixture tree (S=4, N=6, branching at 1 and
    3) by default, in both packages."""
    paths = np.random.default_rng(seed).normal(0.0, 0.3, size=(S, N, 1))
    jt = JTree.from_branching(paths, branch_steps=steps)
    return jt, convert.scenario_tree(jt)


@pytest.fixture(scope="module")
def preps():
    """Both packages' consensus preps of the fixture tree; the port's ADMM
    data is the reference's, carried across."""
    jt, tt = _tree()
    jq = jct.prepare_tree_consensus(
        JCondensed(JM, 6, jdi.default_weights()), jt)
    tq = tct.prepare_tree_consensus(
        CondensedMpc(TM, 6, tdi.default_weights()), tt, device="cpu")
    own = tq.admm
    tq = dataclasses.replace(tq, admm=convert.box_qp(jq.admm, "cpu"))
    return jt, tt, jq, tq, own


def test_rep_dedup(preps):
    """Information-set binaries collapse to one representative: the S=4,
    N=6 tree has 1 + 2·2 + 4·3 = 17 δ sets against 24 binaries; the
    representatives, the member map, the group-mean tensor and the
    consensus rows equal the reference's."""
    jt, tt, jq, tq, own = preps
    assert tq.binary_reps == jq.binary_reps and len(tq.binary_reps) == 17
    assert tq.rep_map == jq.rep_map
    assert (tq.S, tq.N, tq.nud, tq.cons0, tq.ncr) == (
        jq.S, jq.N, jq.nud, jq.cons0, jq.ncr)
    np.testing.assert_allclose(tq.M.numpy(), np.asarray(jq.M), atol=0)
    np.testing.assert_allclose(tq.omega.numpy(), np.asarray(jq.omega),
                               atol=0)
    rep = np.asarray(tq.rep_map)
    c0 = tq.qp.binary_idx[0]
    assert all(rep[s * tq.nV + c0] == rep[c0] for s in range(4))
    # the port's own prep (selector rows boosted as equalities) matches
    for k in convert.BOXQP_ARRAYS:
        np.testing.assert_allclose(getattr(own, k).numpy(),
                                   np.asarray(getattr(jq.admm, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _boxes(tq, rng, B):
    """(B, S, nV) B&B-node boxes fixing a seeded third of each
    information set's binaries (one value per set, as TreeBackend
    expands them)."""
    n = tq.S * tq.nV
    lb = np.tile(tq.qp.lb.numpy().astype(np.float64), (B, tq.S))
    ub = np.tile(tq.qp.ub.numpy().astype(np.float64), (B, tq.S))
    reps = np.asarray(tq.binary_reps)
    fm = rng.uniform(size=(B, len(reps))) < 0.35
    fv = (rng.uniform(size=(B, len(reps))) < 0.5).astype(float)
    lb[:, reps] = np.where(fm, fv, 0.0)
    ub[:, reps] = np.where(fm, fv, 1.0)
    rep = np.asarray(tq.rep_map)
    shape = (B, tq.S, tq.nV)
    return (lb[:, rep].reshape(shape).astype(np.float32),
            ub[:, rep].reshape(shape).astype(np.float32), n)


@pytest.mark.parametrize("iters", [40, 300])
@pytest.mark.parametrize("warm", [False, True])
def test_tree_admm_solve_matches_reference(preps, iters, warm):
    jt, tt, jq, tq, _ = preps
    rng = np.random.default_rng(iters)
    B = 6
    x0s = rng.normal(scale=1.5, size=(B, 2)).astype(np.float32)
    fs, hs = zip(*(jct.assemble_tree(jq, jnp.asarray(x)) for x in x0s))
    f, h = np.stack(fs), np.stack(hs)
    for i, x in enumerate(x0s):         # the port's own assembly agrees
        tf, th = tct.assemble_tree(tq, torch.as_tensor(x))
        np.testing.assert_allclose(tf.numpy(), f[i], rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(th.numpy(), h[i], rtol=1e-5, atol=1e-4)
    lb, ub, _ = _boxes(tq, rng, B)
    jw = tw = None
    if warm:
        r0 = jct.tree_admm_solve(jq, *map(jnp.asarray, (f, h, lb, ub)),
                                 iters=30)
        jw = (r0.x, r0.z, r0.y)
        tw = tuple(torch.as_tensor(np.array(a)) for a in jw)
    jr = jct.tree_admm_solve(jq, *map(jnp.asarray, (f, h, lb, ub)),
                             iters=iters, warm=jw)
    tr = tct.tree_admm_solve(tq, *map(torch.as_tensor, (f, h, lb, ub)),
                             iters=iters, warm=tw)
    assert tuple(tr.x.shape) == (B, 4, tq.nV) and tuple(tr.obj.shape) == (B,)
    scale = np.maximum(1.0, np.abs(np.asarray(jr.obj)))
    assert np.all(np.abs(tr.obj.numpy() - np.asarray(jr.obj))
                  <= 1e-4 * scale)
    for k, rtol, atol in (("x", 1e-3, 1e-3), ("z", 1e-3, 1e-3),
                          ("y", 1e-3, 1e-3), ("r_prim_rel", 1e-2, 1e-5),
                          ("r_dual", 1e-2, 1e-4)):
        np.testing.assert_allclose(getattr(tr, k).numpy(),
                                   np.asarray(getattr(jr, k)), rtol=rtol,
                                   atol=atol, err_msg=k)
    np.testing.assert_array_equal(tr.infeas_cert.numpy(),
                                  np.asarray(jr.infeas_cert))


def test_tree_admm_flags_a_contradictory_scenario_box(preps):
    """Nodes whose box puts one scenario's input outside its rows (|u| ≤ 1):
    both packages give the same certificate bits and a residual that the
    B&B reads as infeasible (above ``infeas_tol`` = 0.5)."""
    jt, tt, jq, tq, _ = preps
    f, h = jct.assemble_tree(jq, jnp.asarray([2.0, 0.0]))
    vals = (1.6, 3.0, 50.0)
    lb = np.tile(tq.qp.lb.numpy(), (len(vals), 4, 1))
    ub = np.tile(tq.qp.ub.numpy(), (len(vals), 4, 1))
    for i, v in enumerate(vals):
        lb[i, 2, 0] = ub[i, 2, 0] = v
    args = (np.broadcast_to(np.array(f), lb.shape).copy(),
            np.broadcast_to(np.array(h), (len(vals),) + h.shape).copy(),
            lb, ub)
    jr = jct.tree_admm_solve(jq, *map(jnp.asarray, args), iters=400)
    tr = tct.tree_admm_solve(tq, *map(torch.as_tensor, args), iters=400)
    np.testing.assert_array_equal(tr.infeas_cert.numpy(),
                                  np.asarray(jr.infeas_cert))
    assert np.all(tr.r_prim_rel.numpy() > 0.5)
    np.testing.assert_allclose(tr.r_prim_rel.numpy(),
                               np.asarray(jr.r_prim_rel), rtol=1e-2)


def test_consensus_relaxation_residual(preps):
    """The consensus residual (|Ax − group mean| on the selector rows) is
    part of r_prim: converged, the scenarios agree on every shared
    coordinate, and x is the reference's."""
    jt, tt, jq, tq, _ = preps
    x0 = [2.0, 0.0]
    f, h = tct.assemble_tree(tq, torch.tensor(x0))
    lb = tq.qp.lb.expand(4, tq.nV)
    ub = tq.qp.ub.expand(4, tq.nV)
    r = tct.tree_admm_solve(tq, f, h, lb, ub, iters=1500)
    assert float(r.r_prim_rel) < 1e-3
    V = r.x.numpy()
    g, nv = tt.groups, TM.info.nv
    for k in range(tt.N):
        for gid in np.unique(g[:, k]):
            members = np.nonzero(g[:, k] == gid)[0]
            u_vals = V[members, k * nv]
            assert u_vals.max() - u_vals.min() < 2e-3
    jf, jh = jct.assemble_tree(jq, jnp.asarray(x0))
    jr = jct.tree_admm_solve(jq, jf, jh, jnp.asarray(lb.numpy()),
                             jnp.asarray(ub.numpy()), iters=1500)
    np.testing.assert_allclose(V, np.asarray(jr.x), rtol=1e-3, atol=1e-3)


def test_consensus_matches_dense_joint_small():
    """The fast-lane case (S=2, N=4, branching at 2): through the
    controller, consensus and dense joint reach the same optimum with a
    shared first stage, and the consensus objective is the reference
    controller's."""
    jt, tt = _tree(S=2, N=4, steps=(2,))
    spec = dict(capacity=256, wave_size=32, max_waves=48, qp_iters=600,
                probe_iters=3000)
    x0 = np.array([1.0, 0.0], np.float32)
    out = {}
    for consensus in (False, True):
        c = MpcController(TM, 4, tdi.default_weights(),
                          bnb_spec=tbnb.BnbSpec(**spec), qp_iters=600,
                          device="cpu")
        c.set_scenario_tree(tt, consensus=consensus)
        out[consensus] = c.feedback(x0)
    dense, cons = out[False], out[True]
    assert bool(dense.found) and bool(cons.found)
    np.testing.assert_allclose(float(cons.obj), float(dense.obj),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cons.u.numpy(), dense.u.numpy(), atol=2e-2)
    V = cons.v_seq.numpy().reshape(tt.S, tt.N, -1)
    assert float(np.ptp(V[:, 0, 0])) < 1e-3
    assert "gap" not in cons           # consensus bounds are uncertified
    jc = JController(JM, 4, jdi.default_weights(),
                     bnb_spec=jbnb.BnbSpec(**spec), qp_iters=600)
    jc.set_scenario_tree(jt, consensus=True)
    jr = jc.feedback(jnp.asarray(x0))
    assert bool(jr.found)
    np.testing.assert_allclose(float(cons.obj), float(jr.obj), rtol=2e-3,
                               atol=2e-3)
    # feedback_batch routes consensus trees to the vmap engine
    rb = c.feedback_batch(np.stack([x0, x0]))
    np.testing.assert_allclose(rb.obj.numpy(), float(cons.obj), rtol=1e-6)


@pytest.mark.slow
def test_consensus_matches_dense_joint():
    """The reference test's own case: the S=4, N=6 fixture tree from
    [2, 0]."""
    _, tt = _tree()
    spec = tbnb.BnbSpec(capacity=256, wave_size=32, max_waves=48,
                        qp_iters=600, probe_iters=3000)
    out = {}
    for consensus in (False, True):
        c = MpcController(TM, 6, tdi.default_weights(), bnb_spec=spec,
                          qp_iters=600, device="cpu")
        c.set_scenario_tree(tt, consensus=consensus)
        out[consensus] = c.feedback([2.0, 0.0])
    dense, cons = out[False], out[True]
    assert bool(dense.found) and bool(cons.found)
    np.testing.assert_allclose(float(cons.obj), float(dense.obj),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(cons.u.numpy(), dense.u.numpy(), atol=2e-2)
    V = cons.v_seq.numpy().reshape(tt.S, tt.N, -1)
    assert float(np.ptp(V[:, 0, 0])) < 1e-3


# ---- (g) the B&B loop's backend hooks ---------------------------------------

class _Hookless:
    """A condensed backend with only ``solve``/``solve_probe`` (no
    ``solve_wave``, ``node_bound`` nor ``node_cert``), as the consensus
    tree's backend is."""

    HIDDEN = ("solve_wave", "node_bound", "node_cert")

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name):
        if name in self.HIDDEN:
            raise AttributeError(name)
        return getattr(self._inner, name)


@pytest.mark.parametrize("presolve_fix", [True, False])
def test_bnb_loop_without_wave_or_bound_hooks_matches_reference(
        presolve_fix):
    """``_bnb_loop`` with a backend that lacks the hooks (unfused relax →
    probe, uncertified node bounds) against the reference's loop on the
    same backend data: the same ``found``, objectives within 1e-3 and an
    integral plan."""
    c = JCondensed(jdi.switched_double_integrator(), 5,
                   jdi.default_weights())
    jq, js, jp = c.device_qp(), jprep(c), jprep(c, rho=10.0)
    tq = convert.device_qp(jq, "cpu")
    ts, tp = convert.box_qp(js, "cpu"), convert.box_qp(jp, "cpu")
    kw = dict(capacity=256, wave_size=32, max_waves=48, qp_iters=300,
              probe_iters=600, presolve_fix=presolve_fix)
    calls = []

    class Counting(tbnb.CondensedBackend):
        def solve(self, *a, **k):
            calls.append("solve")
            return super().solve(*a, **k)

        def solve_probe(self, *a, **k):
            calls.append("probe")
            return super().solve_probe(*a, **k)

    tb = _Hookless(Counting(ts, tq, tp))
    jb = _Hookless(jbnb.CondensedBackend(js, jq, jp))
    for x0 in ([2.0, 0.0], [-3.0, 1.0], [0.5, 0.5]):
        x = np.asarray(x0, np.float32)
        jf, jh = jq.assemble(jnp.asarray(x))
        jr = jbnb._bnb_loop(jb, jf, jh, jbnb.BnbSpec(**kw))
        tf, th = tq.assemble(torch.as_tensor(x))
        tr = tbnb._bnb_loop(tb, tf, th, tbnb.BnbSpec(**kw))
        assert bool(tr.found) == bool(jr.found) is True
        np.testing.assert_allclose(float(tr.obj), float(jr.obj), rtol=1e-3,
                                   atol=1e-3)
        xb = tr.x.numpy()[list(tq.binary_idx)]
        assert np.all(np.abs(xb - np.round(xb)) < 1e-2)
    assert "probe" in calls and calls.count("solve") > calls.count("probe")


def test_tree_refusals_and_defaults(preps):
    jt, tt, jq, tq, _ = preps
    f, h = tct.assemble_tree(tq, torch.tensor([2.0, 0.0]))
    # the tree over ranks (tests/test_torch_sharded_scenarios.py) needs a
    # mesh with the named axis
    no_scen = types.SimpleNamespace(mesh_dim_names=("pool",))
    with pytest.raises(ValueError, match="no axis 'scen'"):
        tct.solve_tree_miqp(tq, f, h, scen_mesh=no_scen)
    with pytest.raises(ValueError, match="no axis 'hz'"):
        tct.tree_admm_solve(tq, f, h, tq.qp.lb.expand(4, -1),
                            tq.qp.ub.expand(4, -1), scen_mesh=(no_scen, "hz"))
    c = CondensedMpc(TM, 6, tdi.default_weights())
    with pytest.raises(ValueError, match="full-v"):
        tct.prepare_tree_consensus(c.with_move_blocking([0, 0, 1, 1, 2, 2]),
                                   tt, device="cpu")
    with pytest.raises(ValueError, match="N=6"):
        tct.prepare_tree_consensus(CondensedMpc(TM, 5), tt, device="cpu")
    if not torch.cuda.is_available():       # the card unless asked
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tct.prepare_tree_consensus(c, tt)
    b = tct.TreeBackend(tq)
    assert not hasattr(b, "solve_wave") and not hasattr(b, "node_bound")
    assert b.n == 4 * tq.nV and b.warm_size == 4 * tq.admm.m_total
    assert b.binary_idx == tq.binary_reps
