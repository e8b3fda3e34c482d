"""The slice end to end on the CPU: the port's MpcController feedback with
config 1's B&B spec against the reference's feedback and the exact fp64
enumeration oracle, for several seeded states; the verify golden; the
enumeration solver; and the explicit refusals of what is not ported.

Tolerances: ``found`` must agree; |Δobj| ≤ 1e-3·max(1,|obj|) between
the packages (both solve to the B&B's feas_tol with fp32 iterates); each
within 1e-3 of the oracle. Node counts are not compared: search order
legitimately differs (ROADMAP)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.oracle import solve_miqp_enumeration_oracle
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

torch.set_num_threads(2)

N = 5
# config 1's B&B spec (configs/benchmarks.py), at horizon N
SPEC = dict(capacity=512, wave_size=32, max_waves=64, qp_iters=400)
X0S = [[2.0, 0.0], [-3.0, 1.0], [5.0, -1.0], [0.5, 0.5], [-1.2, -0.8]]


@pytest.fixture(scope="module")
def ctrls():
    jc = JController(jdi.switched_double_integrator(), N,
                     jdi.default_weights(), bnb_spec=JSpec(**SPEC),
                     qp_iters=SPEC["qp_iters"])
    tc = MpcController(tdi.switched_double_integrator(), N,
                       tdi.default_weights(), bnb_spec=BnbSpec(**SPEC),
                       qp_iters=SPEC["qp_iters"], device="cpu")
    jc.feedback(jnp.zeros(2))      # compile the reference once per module
    return jc, tc


@pytest.mark.parametrize("x0", X0S)
def test_bnb_feedback_matches_reference_and_oracle(ctrls, x0):
    jc, tc = ctrls
    jr = jc.feedback(jnp.asarray(x0, jnp.float32))
    tr = tc.feedback(x0)
    assert bool(tr.found) == bool(jr.found)
    t_obj, j_obj = float(tr.obj), float(jr.obj)
    assert abs(t_obj - j_obj) <= 1e-3 * max(1.0, abs(j_obj))
    c = tc.condensed
    f, h = c.assemble_np(np.asarray(x0))
    oracle = solve_miqp_enumeration_oracle(c.H, f, c.G, h, c.lb, c.ub,
                                           c.binary_idx)
    assert abs(t_obj - oracle.obj) <= 1e-3
    assert abs(j_obj - oracle.obj) <= 1e-3
    # the returned plan is feasible for the condensed MIQP
    V = tr.v_seq.reshape(-1).double().numpy()
    assert np.max(c.G @ V - h) <= 1e-3
    np.testing.assert_allclose(tr.u.numpy(), V[:1], atol=1e-6)
    assert float(tr.gap) >= 0.0


def test_infeasible_state_is_not_found(ctrls):
    jc, tc = ctrls
    x0 = [12.0, 0.0]                 # outside the |x| ≤ 10 state box
    assert not bool(tc.feedback(x0).found)
    assert not bool(jc.feedback(jnp.asarray(x0)).found)


def test_verify_golden_n8():
    """N=8, x0=[2,0]: obj ≈ −42.6865, gear bits [1,1,1,1,0,0,0,0]."""
    tc = MpcController(tdi.switched_double_integrator(), 8,
                       tdi.default_weights(), bnb_spec=BnbSpec(**SPEC),
                       qp_iters=SPEC["qp_iters"], device="cpu")
    r = tc.feedback([2.0, 0.0])
    assert bool(r.found)
    assert abs(float(r.obj) - (-42.6865)) <= 1e-3
    bits = np.round(r.v_seq[:, 1].numpy()).astype(int)
    assert bits.tolist() == [1, 1, 1, 1, 0, 0, 0, 0]
    e = MpcController(tdi.switched_double_integrator(), 8,
                      tdi.default_weights(), solver="enumerate",
                      qp_iters=600, device="cpu").feedback([2.0, 0.0])
    assert abs(float(e.obj) - float(r.obj)) <= 1e-3
    assert int(e.nodes) == 2 ** 8 and float(e.gap) == 0.0


def test_enumerate_matches_reference():
    from pyhybridcontrol_tpu.solver.enumerate import (
        solve_miqp_enumerate_device as j_enum)
    from pyhybridcontrol_tpu_torch import convert
    from pyhybridcontrol_tpu_torch.solver.enumerate import (
        solve_miqp_enumerate_device as t_enum)
    from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu.ops.condense import CondensedMpc

    c = CondensedMpc(jdi.switched_double_integrator(), 5,
                     jdi.default_weights())
    jq, js = c.device_qp(), prepare_admm_mpc(c)
    tq, ts = convert.device_qp(jq, "cpu"), convert.box_qp(js, "cpu")
    x0 = np.float32([-2.5, 0.7])
    jf, jh = jq.assemble(jnp.asarray(x0))
    tf, th = tq.assemble(torch.as_tensor(x0))
    jx, jo, jb, jfeas = j_enum(js, jq, jf, jh, iters=300)
    tx, to, tb, tfeas = t_enum(ts, tq, tf, th, iters=300)
    # same σ-form solves of all 32 assignments; fp32 noise only
    assert abs(float(to) - float(jo)) <= 1e-4 * max(1.0, abs(float(jo)))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    np.testing.assert_array_equal(tfeas.numpy(), np.asarray(jfeas))
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-3)


@pytest.mark.parametrize("kw", [
    dict(sb_iters=10), dict(sb_fix=True), dict(dive_slots=4),
    dict(branching="flipdelta"), dict(depth_tiebreak=1e-3)])
def test_unported_bnb_options_raise(kw):
    """The search options the port once refused: the spec accepts each,
    convert.bnb_spec carries it from a reference spec, the single-instance
    loop runs it (tests/test_torch_search_options.py holds each against
    the reference), and the pooled engine, where the reference ignores
    it, still raises."""
    from pyhybridcontrol_tpu_torch import convert
    from pyhybridcontrol_tpu_torch.solver.bnb_pooled import _pooled_loop

    spec = BnbSpec(**kw)
    assert all(getattr(spec, k) == v for k, v in kw.items())
    assert convert.bnb_spec(JSpec(**kw)) == spec
    with pytest.raises(NotImplementedError, match="pooled"):
        _pooled_loop(None, torch.zeros(1, 1), torch.zeros(1, 1), spec, 2)


@pytest.mark.parametrize("kw", [
    dict(probe_patience=2), dict(root_iters=800), dict(pool_norm="relgap"),
    dict(branching="most_frac"), dict(presolve_fix=False),
    dict(warm_start=False), dict(rel_gap=0.01)])
def test_ported_bnb_options_are_accepted(kw):
    """The options the pooled engine and its tests use construct, with the
    reference's validation (tests/test_torch_pooled.py runs each)."""
    spec = BnbSpec(**kw)
    assert all(getattr(spec, k) == v for k, v in kw.items())
    for bad in (dict(rel_gap=-1.0), dict(probe_patience=-1),
                dict(pool_norm="x"), dict(branching="x")):
        with pytest.raises(ValueError):
            BnbSpec(**bad)


def test_unported_paths_raise():
    with pytest.raises(ValueError):
        BnbSpec(wave_size=600, capacity=512)
    tc = MpcController(tdi.switched_double_integrator(), 4,
                       tdi.default_weights(), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tc.feedback_batch(np.zeros((2, 2)), mesh=object())
    # soft rows are ported: the setter configures, the next build softens
    assert tc.set_soft_constraints([6, 7], lin_pen=5.0, quad_pen=1.0) is tc
    assert tc.condensed.n_soft == 2 and tc.repair[1] == "soft"
    # scenario trees (tests/test_torch_scenario_tree.py) and the stagewise
    # frame with its tree (tests/test_torch_stagewise*.py) are ported; a
    # tree across devices is not, on either frame
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        tc.set_scenario_tree(object(), scen_mesh=object())
    sc = MpcController(tdi.switched_double_integrator(), 4,
                       solver="stagewise", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        sc.set_scenario_tree(object(), scen_mesh=object())
    from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tswt

    with pytest.raises(NotImplementedError, match="ROADMAP.*item 9"):
        tswt.solve_tree_miqp_stagewise(None, None, None, None,
                                       scen_mesh=object())
    with pytest.raises(ValueError, match="unknown solver"):
        MpcController(tdi.switched_double_integrator(), 4,
                      solver="stagewise_dense", device="cpu")
