"""The port's condense transforms, root presolve, fp64 oracle, soft repair
seed and controller setters against the reference's, on the CPU.

- ``CondensedMpc`` (terminal set, v bounds, ``with_extra_constraints``,
  ``with_move_blocking``, ``with_soft_constraints``, each alone and chained
  in config 3's order, and ``with_root_presolve``) is float64 numpy in both
  packages: every array at rtol = atol = 1e-12, ``binary_mask``,
  ``T_full``'s selection and ``binary_shift`` identical.
- ``DeviceQP.assemble`` (fp32) with disturbances and prices: rtol 1e-5
  (atol 1e-5 of the largest entry) against the reference's and the fp64
  ``assemble_np``.
- The oracle: relative objective within 1e-9 of the reference's, the same
  status.
- The soft repair seed: the reference test's own tolerances
  (tests/test_torch_batch_serve.py): objective 1e-4, decision 1e-3, the
  same ``ok``.
- The controller with each setter: objective within 1e-3 of the
  reference controller's, the same ``found`` and first input within 1e-2
  (both solve fp32 ADMM relaxations)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.dewh as jdewh
import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu.models.pwa_examples as jpwa
import pyhybridcontrol_tpu_torch.models.dewh as tdewh
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
import pyhybridcontrol_tpu_torch.models.pwa_examples as tpwa
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as jprep
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.solver import oracle as joracle
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu.solver.repair import prepare_repair as jprep_repair
from pyhybridcontrol_tpu.solver.repair import (
    root_repair_incumbent as jroot_repair)
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver import oracle as toracle
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device)
from pyhybridcontrol_tpu_torch.solver.repair import (
    prepare_repair,
    root_repair_incumbent,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)
ARRAYS = ("H", "f0", "Fx", "Fw", "Fup", "G", "h0", "Hx", "Hw", "lb", "ub",
          "T_full", "z_rows")
NC_DI, NC_DEWH = 10, 7      # stage rows of the double integrator, of DEWH


def _soft_rows(N, nc, rows):
    return [k * nc + r for k in range(N) for r in rows]


def _di(pkg, N=5, **kw):
    m = (tdi if pkg == "t" else jdi)
    return (CondensedMpc if pkg == "t" else JCondensed)(
        m.switched_double_integrator(), N, m.default_weights(), **kw)


def _dewh(pkg, N=6):
    m = (tdewh if pkg == "t" else jdewh)
    return (CondensedMpc if pkg == "t" else JCondensed)(
        m.dewh_model(), N, m.dewh_weights())


def _pwa(pkg, N=4, formulation="hull"):
    m = (tpwa if pkg == "t" else jpwa)
    return (CondensedMpc if pkg == "t" else JCondensed)(
        m.pwa_spring_mld(on_off=True, formulation=formulation), N,
        m.pwa_weights())


def _extra_di(N=5, nv=3):
    """Two horizon-coupled rows: Σ u ≤ 1.5 and u_0 − u_{N−1} ≤ 0.7."""
    A = np.zeros((2, N * nv))
    A[0, ::nv] = 1.0
    A[1, 0], A[1, (N - 1) * nv] = 1.0, -1.0
    return A, np.array([1.5, 0.7])


def _config3(pkg, N=6):
    mr = (tdewh if pkg == "t" else jdewh).min_up_down_rows
    c = _dewh(pkg, N)
    return (c.with_extra_constraints(*mr(N, 2, min_up=2))
            .with_move_blocking([k // 2 for k in range(N)])
            .with_soft_constraints(_soft_rows(N, NC_DEWH, (0, 1)),
                                   lin_pen=5.0, quad_pen=1.0))


TERMINAL = dict(terminal_E=np.vstack([np.eye(2), -np.eye(2)]),
                terminal_f=np.array([0.5, 0.4, 0.5, 0.4]))
VBOUNDS = dict(v_lb=np.array([-0.8, 0.0, -0.9]),
               v_ub=np.array([0.7, 1.0, 0.9]))

FRAMES = {
    "di_terminal": lambda p: _di(p, **TERMINAL),
    "di_v_bounds": lambda p: _di(p, **VBOUNDS),
    "di_extra": lambda p: _di(p).with_extra_constraints(*_extra_di()),
    "di_blocking": lambda p: _di(p).with_move_blocking([0, 0, 1, 1, 2]),
    "di_blocking_deltas": lambda p: _di(p).with_move_blocking(
        [0, 0, 0, 1, 1], block_deltas=True),
    "di_soft": lambda p: _di(p).with_soft_constraints(
        _soft_rows(5, NC_DI, (6, 7)), lin_pen=[5.0, 6.0] * 5,
        quad_pen=1.0),
    "di_all": lambda p: (_di(p, **TERMINAL, **VBOUNDS)
                         .with_extra_constraints(*_extra_di())
                         .with_move_blocking([0, 1, 1, 2, 2])
                         .with_soft_constraints([3, 17, 50], 7.0, 0.5)),
    "dewh_extra": lambda p: _dewh(p).with_extra_constraints(
        *(tdewh if p == "t" else jdewh).min_up_down_rows(6, 2, min_up=3,
                                                         min_down=2)),
    "dewh_blocking": lambda p: _dewh(p).with_move_blocking(
        [k // 3 for k in range(6)]),
    "dewh_soft": lambda p: _dewh(p).with_soft_constraints(
        _soft_rows(6, NC_DEWH, (0, 1)), lin_pen=5.0, quad_pen=1.0),
    "config3_chain": _config3,
    "pwa_hull_blocking": lambda p: _pwa(p).with_move_blocking([0, 0, 1, 1]),
}


def assert_same_frame(tc, jc):
    for k in ARRAYS:
        a, b = getattr(tc, k), np.asarray(getattr(jc, k))
        assert a.shape == b.shape, k
        np.testing.assert_allclose(a, b, err_msg=k, **TOL)
    np.testing.assert_array_equal(tc.binary_mask, jc.binary_mask)
    assert (tc.n_soft, tc.n_state_aux, tc.N) == (jc.n_soft, jc.n_state_aux,
                                                 jc.N)
    assert tc._binary_shift_perm() == jc._binary_shift_perm()


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_transform_matches_reference(name):
    tc, jc = FRAMES[name]("t"), FRAMES[name]("j")
    assert_same_frame(tc, jc)
    tq, jq = tc.device_qp("cpu"), jc.device_qp()
    assert tq.binary_idx == jq.binary_idx
    assert tq.binary_shift == jq.binary_shift
    for k in convert.DEVICEQP_ARRAYS:
        np.testing.assert_array_equal(getattr(tq, k).numpy(),
                                      np.asarray(getattr(jq, k)), err_msg=k)


def test_config3_frame_shape_and_shift():
    """Config 3 at N=24 (extra rows, blocking, soft rows): n=108, m=239,
    60 binaries; under blocking the binary shift is the identity (the
    reference's "blocked → identity" rule), without it a real shift."""
    tc, jc = _config3("t", 24), _config3("j", 24)
    assert (tc.nV, tc.G.shape[0], len(tc.binary_idx)) == (108, 239, 60)
    assert_same_frame(tc, jc)
    nb = len(tc.binary_idx)
    assert tc._binary_shift_perm() == tuple(range(nb))
    plain = _dewh("t", 24)
    shift = plain._binary_shift_perm()
    assert shift == _dewh("j", 24)._binary_shift_perm()
    assert len(shift) == len(plain.binary_idx) and shift != tuple(
        range(len(shift)))
    assert np.isinf(tc.ub[-48:]).all() and (tc.lb[-48:] == 0).all()
    assert tc.device_qp("cpu").ub[-48:].eq(1e30).all()


def test_soft_slacks_relax_their_rows():
    """A soft row accepts a violating V once its slack covers the
    violation; the slack's cost is lin·s + quad·s²."""
    row = NC_DI + 6                  # x_1[0] ≤ 10
    c = _di("t", N=3).with_soft_constraints([row], lin_pen=4.0,
                                            quad_pen=2.0)
    f, h = c.assemble_np(np.array([9.9, 1.0]))
    V = np.zeros(c.nV)
    viol = c.G[row, :-1] @ V[:-1] - h[row]
    assert viol > 0                  # x_1 = 9.9 + 0.5 · 1.0 above the box
    V[-1] = viol
    assert c.G[row] @ V - h[row] <= 1e-9
    base = _di("t", N=3)
    fb, _ = base.assemble_np(np.array([9.9, 1.0]))
    cost = 0.5 * V @ c.H @ V + f @ V - (0.5 * V[:-1] @ base.H @ V[:-1]
                                        + fb @ V[:-1])
    np.testing.assert_allclose(cost, 4.0 * viol + 2.0 * viol ** 2,
                               rtol=1e-6)


def test_transform_argument_errors():
    c = _di("t")
    with pytest.raises(ValueError, match="length N"):
        c.with_move_blocking([0, 1])
    with pytest.raises(ValueError, match="full-v layout"):
        c.with_extra_constraints(np.zeros((1, 4)), [0.0])


def test_root_presolve_pwa():
    """The PWA case of tests/test_presolve.py (big-M, on/off, N=2): the
    arrays at 1e-12 against the reference's presolve; the layout is
    unchanged, bounds only tighten, the unbounded big-M auxiliaries get
    finite boxes, and the MIQP's optimum is unchanged (the port's
    enumeration on the CPU, 1500 iterations, within 2e-3 at two states)."""
    tc0, jc0 = _pwa("t", 2, "bigm"), _pwa("j", 2, "bigm")
    tc1, jc1 = tc0.with_root_presolve(), jc0.with_root_presolve()
    assert_same_frame(tc1, jc1)
    assert tc1.G.shape == tc0.G.shape and len(tc1.lb) == len(tc0.lb)
    assert (np.isinf(tc1.lb).sum() + np.isinf(tc1.ub).sum()
            < np.isinf(tc0.lb).sum() + np.isinf(tc0.ub).sum())
    assert (tc1.lb >= tc0.lb - 1e-12).all() and (tc1.ub <= tc0.ub + 1e-12).all()
    rng = np.random.default_rng(0)
    for x0 in rng.uniform(-2, 2, size=(2, 2)).astype(np.float32):
        objs = []
        for c in (tc0, tc1):
            qp, spec = c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")
            f, h = qp.assemble(torch.as_tensor(x0))
            _, obj, _, feas = solve_miqp_enumerate_device(spec, qp, f, h,
                                                          iters=1500)
            objs.append(float(obj) if bool(feas.any()) else np.inf)
        np.testing.assert_allclose(objs[0], objs[1], rtol=2e-3, atol=2e-3)


def test_device_assemble_with_disturbances_and_prices(rng):
    """The config-3 frame's feedback-time data, one state and a batch of
    three, with draws W and prices: the port's fp32 assemble against the
    reference's and against the fp64 ``assemble_np``."""
    tc, jc = _config3("t"), _config3("j")
    tq, jq = tc.device_qp("cpu"), jc.device_qp()
    N = tc.N
    x0s = np.stack([rng.uniform(45, 70, 3), rng.integers(0, 2, 3)],
                   axis=1).astype(np.float32)
    Ws = rng.uniform(0, 1, (3, N, 1)).astype(np.float32)
    prices = tdewh.dewh_energy_price_seq(rng.uniform(0.05, 0.4, N),
                                         tdewh.DewhParams()).astype(np.float32)
    tf, th = tq.assemble(torch.as_tensor(x0s), torch.as_tensor(Ws),
                         price_seq=torch.as_tensor(prices))
    for i in range(3):
        jf, jh = jq.assemble(jnp.asarray(x0s[i]), jnp.asarray(Ws[i]),
                             price_seq=jnp.asarray(prices))
        nf, nh = tc.assemble_np(x0s[i], Ws[i], price_seq=prices)
        for got, ref in ((tf[i], jf), (th[i], jh), (tf[i], nf), (th[i], nh)):
            ref = np.asarray(ref, np.float64)
            np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * np.abs(ref).max())
        one_f, one_h = tq.assemble(torch.as_tensor(x0s[i]),
                                   torch.as_tensor(Ws[i]),
                                   price_seq=torch.as_tensor(prices))
        np.testing.assert_allclose(one_f.numpy(), tf[i].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(tf[i].abs().max()))
        np.testing.assert_allclose(one_h.numpy(), th[i].numpy(), rtol=1e-6,
                                   atol=1e-6 * float(th[i].abs().max()))


def _rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


def test_qp_oracle_matches_reference():
    """Config 3's root relaxation (N=24) and an infeasible problem."""
    tc = _config3("t", 24)
    f, h = tc.assemble_np(np.array([55.0, 0.0]), W=np.full((24, 1), 0.1),
                          price_seq=tdewh.dewh_energy_price_seq(
                              np.full(24, 0.15), tdewh.DewhParams()))
    got = toracle.solve_qp_oracle(tc.H, f, tc.G, h, tc.lb, tc.ub)
    ref = joracle.solve_qp_oracle(tc.H, f, tc.G, h, tc.lb, tc.ub)
    assert got.status == ref.status == "optimal"
    assert _rel(got.obj, ref.obj) <= 1e-9
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-9, atol=1e-9)
    G = np.array([[1.0, 0.0], [-1.0, 0.0]])
    bad = toracle.solve_qp_oracle(np.eye(2), np.zeros(2), G,
                                  np.array([1.0, -2.0]))
    assert bad.status == "infeasible" and bad.x is None
    assert toracle.solve_qp_oracle(np.zeros((0, 0)), np.zeros(0)).obj == 0.0


@pytest.mark.parametrize("frame", ["di_soft", "dewh_soft"])
def test_enumeration_oracle_matches_reference(frame):
    """The exact MIQP of a soft frame: the double integrator at N=3 (3
    binaries) and DEWH at N=2 with all but 3 of its binaries fixed."""
    tc = (_di("t", N=3).with_soft_constraints(_soft_rows(3, NC_DI, (6, 7)),
                                              5.0, 1.0)
          if frame == "di_soft" else
          _dewh("t", 2).with_soft_constraints(_soft_rows(2, NC_DEWH, (0, 1)),
                                              5.0, 1.0))
    x0 = np.array([2.0, 0.0]) if frame == "di_soft" else np.array([49.0, 0.0])
    kw = {} if frame == "di_soft" else dict(W=np.array([[0.5], [0.0]]))
    f, h = tc.assemble_np(x0, **kw)
    lb, ub = tc.lb.copy(), tc.ub.copy()
    if frame == "dewh_soft":
        lb[tc.binary_idx[3:]] = ub[tc.binary_idx[3:]] = 0.0
    got = toracle.solve_miqp_enumeration_oracle(tc.H, f, tc.G, h, lb, ub,
                                                tc.binary_idx)
    ref = joracle.solve_miqp_enumeration_oracle(tc.H, f, tc.G, h, lb, ub,
                                                tc.binary_idx)
    assert got.status == ref.status == "optimal"
    assert _rel(got.obj, ref.obj) <= 1e-9
    np.testing.assert_array_equal(got.binaries, ref.binaries)
    with pytest.raises(ValueError, match="too many"):
        toracle.solve_miqp_enumeration_oracle(
            np.eye(23), np.zeros(23), np.zeros((0, 23)), np.zeros(0),
            np.zeros(23), np.ones(23), range(23))


def test_soft_repair_seed_matches_reference():
    """The soft layout of the rollout repair on the double integrator with
    its state-box rows softened (N=4), from states whose box rows bind:
    the stage QPs carry slacks, and the seed's slack columns hold the row
    violations."""
    N, rows = 4, (6, 7, 8, 9)
    soft = _soft_rows(N, NC_DI, rows)
    tc = _di("t", N).with_soft_constraints(soft, 5.0, 1.0)
    jc = _di("j", N).with_soft_constraints(soft, 5.0, 1.0)
    jq, js = jc.device_qp(), jprep(jc)
    tq, ts = convert.device_qp(jq, "cpu"), convert.box_qp(js, "cpu")
    tr = prepare_repair(tdi.switched_double_integrator(), tdi.default_weights(),
                        soft_rows=rows, soft_lin=5.0, soft_quad=1.0,
                        device="cpu")
    jr = jprep_repair(jdi.switched_double_integrator(), jdi.default_weights(),
                      soft_rows=rows, soft_lin=5.0, soft_quad=1.0)
    assert tr.n_slack == jr.n_slack == 4
    np.testing.assert_array_equal(tr.hard_mask.numpy(),
                                  np.asarray(jr.hard_mask))
    for x0 in ([9.8, 1.5], [-9.9, -1.0], [2.0, 0.0]):
        x = np.asarray(x0, np.float32)
        tf, th = tq.assemble(torch.as_tensor(x))
        jf, jh = jq.assemble(jnp.asarray(x))
        t_obj, t_V, t_ok = root_repair_incumbent(
            ts, tq, tr, torch.as_tensor(x), tf, th, qp_iters=150,
            layout="soft")
        j_obj, j_V, j_ok = jroot_repair(js, jq, jr, jnp.asarray(x), jf, jh,
                                        qp_iters=150, layout="soft")
        assert t_V.shape == (tc.nV,) and bool(t_ok) == bool(j_ok)
        np.testing.assert_allclose(float(t_obj), float(j_obj), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(t_V.numpy(), np.asarray(j_V), atol=1e-3)
        # the slack columns hold the soft rows' violations
        nvf = N * 3
        viol = np.maximum(tc.G[:, :nvf] @ t_V[:nvf].numpy()
                          - th.numpy(), 0.0)[soft]
        np.testing.assert_allclose(t_V[nvf:].numpy(), viol, atol=1e-5)
    assert bool(t_ok)
    batch = torch.as_tensor(np.array([[9.8, 1.5], [2.0, 0.0]], np.float32))
    bf, bh = tq.assemble(batch)
    b_obj, b_V, b_ok = root_repair_incumbent(ts, tq, tr, batch, bf, bh,
                                             qp_iters=150, layout="soft")
    assert b_V.shape == (2, tc.nV)
    np.testing.assert_allclose(float(b_obj[1]), float(t_obj), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError, match="layout"):
        root_repair_incumbent(ts, tq, tr, batch, bf, bh, layout="blocked")


SETTERS = {
    "soft": lambda c: c.set_soft_constraints(
        _soft_rows(4, NC_DI, (6, 7, 8, 9)), lin_pen=5.0, quad_pen=1.0),
    "blocking": lambda c: c.set_move_blocking([0, 0, 1, 1]),
    "extra": lambda c: c.set_extra_constraints(*_extra_di(4)),
    "terminal": lambda c: c.set_terminal_constraint(
        TERMINAL["terminal_E"], [3.0, 1.0, 3.0, 1.0]),
    "horizon": lambda c: c.set_horizon(3),
    "weights": lambda c: c.set_std_obj_weights(Ru=np.array([0.5]),
                                               qdelta=np.array([0.2])),
}


def _controllers(solver, setter):
    kw = dict(solver=solver, qp_iters=600,
              bnb_spec=dict(capacity=64, wave_size=16, qp_iters=300))
    tc = MpcController(tdi.switched_double_integrator(), 4,
                       tdi.default_weights(), solver=solver, qp_iters=600,
                       bnb_spec=BnbSpec(**kw["bnb_spec"]), device="cpu")
    jc = JController(jdi.switched_double_integrator(), 4,
                     jdi.default_weights(), solver=solver, qp_iters=600,
                     bnb_spec=JSpec(**kw["bnb_spec"]))
    for c in (tc, jc):
        assert SETTERS[setter](c) is c
    return tc, jc


@pytest.mark.parametrize("setter", sorted(SETTERS))
def test_controller_setter_matches_reference(setter):
    """Enumeration through the controller after each setter: the port's
    frame equals the reference's, and so do the feedback results."""
    tc, jc = _controllers("enumerate", setter)
    assert_same_frame(tc.condensed, jc.condensed)
    assert tc.repair is None and jc.repair is None     # enumeration
    for x0 in ([2.0, 0.0], [-3.0, 1.0]):
        got, ref = tc.feedback(x0), jc.feedback(jnp.asarray(x0))
        assert bool(got.found) == bool(ref.found)
        np.testing.assert_allclose(float(got.obj), float(ref.obj),
                                   rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u),
                                   atol=1e-2)


@pytest.mark.parametrize("setter", ["soft", "blocking"])
def test_controller_bnb_repair_choice_matches_reference(setter):
    """B&B through the controller: the soft frame is seeded by the soft
    repair layout, a blocked frame by none (as the reference chooses),
    and the feedback agrees with the reference controller's."""
    tc, jc = _controllers("bnb", setter)
    want = None if setter == "blocking" else "soft"
    assert (tc.repair and tc.repair[1]) == (jc.repair and jc.repair[1]) \
        == want
    got, ref = tc.feedback([9.5, 1.0]), jc.feedback(jnp.asarray([9.5, 1.0]))
    assert bool(got.found) and bool(ref.found)
    np.testing.assert_allclose(float(got.obj), float(ref.obj), rtol=1e-3,
                               atol=1e-3)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), atol=1e-2)


def test_controller_rebuilds_on_each_setter_and_binary_states_skip_repair():
    c = MpcController(tdewh.dewh_model(), 4, tdewh.dewh_weights(),
                      device="cpu")
    first = c.condensed
    assert c.condensed is first and c.repair is None   # binary state: none
    c.set_soft_constraints(_soft_rows(4, NC_DEWH, (0, 1)), 5.0, 1.0)
    assert c.condensed is not first and c.condensed.n_soft == 8
    c.set_extra_constraints(*tdewh.min_up_down_rows(4, 2, min_up=2))
    c.set_move_blocking([0, 0, 1, 1])
    jc = JController(jdewh.dewh_model(), 4, jdewh.dewh_weights())
    jc.set_soft_constraints(_soft_rows(4, NC_DEWH, (0, 1)), 5.0, 1.0)
    jc.set_extra_constraints(*jdewh.min_up_down_rows(4, 2, min_up=2))
    jc.set_move_blocking([0, 0, 1, 1])
    assert_same_frame(c.condensed, jc.condensed)
    assert c.device_qp.n == c.condensed.nV and c.admm_probe is not None
    with pytest.raises(AttributeError, match="weight"):
        c.set_std_obj_weights(Qnope=1.0)
    # a scenario tree takes no transform (as in the reference)
    from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree

    c.set_scenario_tree(ScenarioTree.from_branching(np.zeros((2, 4, 1))))
    with pytest.raises(ValueError, match="transforms"):
        c.build()


def test_convert_carries_a_transformed_frame():
    """``convert.condensed`` of the reference's config-3 frame gives the
    port's own frame, and ``convert.mld_model`` the port's model."""
    jc, tc = _config3("j"), _config3("t")
    got = convert.condensed(jc)
    assert_same_frame(got, tc)
    assert dataclasses.asdict(got.info) == dataclasses.asdict(tc.info)
    for k, v in tc.model.mats.items():
        assert torch.equal(got.model.mats[k], v), k
    np.testing.assert_array_equal(got.weights.x_ref, tc.weights.x_ref)
    a, b = prepare_admm_mpc(got, device="cpu"), prepare_admm_mpc(tc,
                                                                 device="cpu")
    for k in convert.BOXQP_ARRAYS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
