"""The port's micro-grid layer against the reference's on the CPU:
``mld/compose.py``, ``models/grid.py``, ``models/battery.py`` and
``agents/`` (``Agent``/``MpcAgent``, the centralized
``MicroGridCoordinator`` and the dual-decomposition
``DecentralizedMicroGrid``).

Tolerances: the model matrices, layouts and price sequences are the same
numpy float64 arithmetic (stored fp32 in both packages), held exactly.
The controllers solve fp32 ADMM in another summation order: applied
heater inputs and rounded binaries must be equal, objectives within 1e-3
relative (the reference's own bound between engines), states within
1e-3. The battery feedback is held to the port's fp64 oracle as
tests/test_battery.py holds the reference's: at most 5% above it and
5e-3 below."""

import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.agents.agent as jagent
import pyhybridcontrol_tpu.agents.decentralized as jdec
import pyhybridcontrol_tpu.agents.micro_grid as jmg
import pyhybridcontrol_tpu.mld.compose as jcompose
import pyhybridcontrol_tpu.models.battery as jbat
import pyhybridcontrol_tpu.models.dewh as jdewh
import pyhybridcontrol_tpu.models.grid as jgrid
import pyhybridcontrol_tpu_torch.agents.agent as tagent
import pyhybridcontrol_tpu_torch.agents.decentralized as tdec
import pyhybridcontrol_tpu_torch.agents.micro_grid as tmg
import pyhybridcontrol_tpu_torch.mld.compose as tcompose
import pyhybridcontrol_tpu_torch.models.battery as tbat
import pyhybridcontrol_tpu_torch.models.dewh as tdewh
import pyhybridcontrol_tpu_torch.models.grid as tgrid
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

torch.set_num_threads(2)


def _same_model(jm, tm):
    a, b = jm.numpy_mats(), tm.numpy_mats()
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=k)
    for f in ("nx", "nu", "ndelta", "nz", "nomega", "ny", "ncons",
              "x_types", "u_types"):
        assert getattr(jm.info, f) == getattr(tm.info, f), f


# ---- mld/compose.py, models/grid.py -----------------------------------------

def test_aggregate_mld_matches_reference():
    """Three DEWH agents with two coupling rows over every joint vector
    (E, F1, F2, F3 random): every matrix equal."""
    rng = np.random.default_rng(0)
    ps = [dict(P_h=3000.0), dict(P_h=2000.0, UA=8.0), dict(C_w=200.0)]
    jms = [jdewh.dewh_model(jdewh.DewhParams(**p)) for p in ps]
    tms = [tdewh.dewh_model(tdewh.DewhParams(**p)) for p in ps]
    cpl = dict(coupling_E=rng.normal(size=(2, 6)),
               coupling_F1=rng.normal(size=(2, 3)),
               coupling_F2=rng.normal(size=(2, 3)),
               coupling_f5=np.array([5000.0, 1.0]))
    _same_model(jcompose.aggregate_mld(jms, **cpl),
                tcompose.aggregate_mld(tms, **cpl))
    _same_model(jcompose.aggregate_mld(jms), tcompose.aggregate_mld(tms))
    with pytest.raises(ValueError, match="coupling matrix shape"):
        tcompose.aggregate_mld(tms, coupling_F1=np.ones((1, 2)),
                               coupling_f5=np.array([1.0]))


def test_micro_grid_model_layout_and_prices_match_reference():
    """micro_grid_mld, joint_v_layout, micro_grid_price_seq,
    default_tou_profile and GridParams.price_at equal the reference's."""
    kw = [dict(), dict(P_h=2000.0), dict(Ts=600.0)]
    jp = [jdewh.DewhParams(**k) for k in kw]
    tp = [tdewh.DewhParams(**k) for k in kw]
    jg = jgrid.GridParams(P_max=3500.0,
                          tou_prices=jgrid.default_tou_profile(48))
    tg = tgrid.GridParams(P_max=3500.0,
                          tou_prices=tgrid.default_tou_profile(48))
    jm, tm = jgrid.micro_grid_mld(jp, jg), tgrid.micro_grid_mld(tp, tg)
    _same_model(jm, tm)
    jl = jcompose.joint_v_layout([jdewh.dewh_model(p).info for p in jp])
    tl = tcompose.joint_v_layout([tdewh.dewh_model(p).info for p in tp])
    assert len(jl) == len(tl) == 3
    for a, b in zip(jl, tl):
        for k in ("u", "delta", "z"):
            np.testing.assert_array_equal(a[k], b[k])
    for k0 in (0, 27, 95):
        np.testing.assert_array_equal(
            jgrid.micro_grid_price_seq(24, k0, jp, jg, jm.info.nv),
            tgrid.micro_grid_price_seq(24, k0, tp, tg, tm.info.nv))
        assert jg.price_at(k0) == tg.price_at(k0)
    assert tgrid.GridParams().price_at(3) == 0.15


# ---- models/battery.py ------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(E_cap=13.5, p_max=7.0,
                                         eta_c=0.9, soc_min=0.2)])
def test_battery_model_weights_and_prices_match_reference(kw):
    _same_model(jbat.battery_model(jbat.BatteryParams(**kw)),
                tbat.battery_model(tbat.BatteryParams(**kw)))
    jw, tw = jbat.battery_weights(0.4, 0.3), tbat.battery_weights(0.4, 0.3)
    for f in ("Qx", "x_ref", "Ru"):
        np.testing.assert_array_equal(getattr(jw, f), getattr(tw, f))
    prices = np.random.default_rng(1).uniform(0.05, 0.5, 9)
    np.testing.assert_array_equal(
        jbat.battery_price_seq(prices, jbat.BatteryParams(**kw)),
        tbat.battery_price_seq(prices, tbat.BatteryParams(**kw)))


def test_battery_feedback_against_fp64_oracle():
    """One battery MIQP feedback (the mode and product logic: all four z
    rows and the sign pair) against the port's exact fp64 enumeration
    oracle, as tests/test_battery.py holds the reference's."""
    from pyhybridcontrol_tpu_torch.solver.oracle import (
        solve_miqp_enumeration_oracle)

    p = tbat.BatteryParams()
    model = tbat.battery_model(p)
    N = 6
    ctrl = MpcController(model, N, tbat.battery_weights(soc_ref=0.5,
                                                        q_soc=2.0),
                         solver="bnb",
                         bnb_spec=BnbSpec(capacity=128, wave_size=16,
                                          qp_iters=400), device="cpu")
    pseq = tbat.battery_price_seq(np.full(N, 0.05), p,
                                  nv=model.info.nv).astype(np.float32)
    sol = ctrl.feedback(np.array([0.26], np.float32), price_seq=pseq)
    assert bool(sol.found)
    c = ctrl.condensed
    fo, ho = c.assemble_np(np.array([0.26]),
                           price_seq=np.asarray(pseq, np.float64))
    r = solve_miqp_enumeration_oracle(c.H, fo, c.G, ho, c.lb, c.ub,
                                      c.binary_idx)
    assert r.status == "optimal"
    assert float(sol.obj) <= r.obj + 0.05 * max(1.0, abs(r.obj))
    assert float(sol.obj) >= r.obj - 5e-3


# ---- agents/agent.py --------------------------------------------------------

def _dewh_agents(T):
    """One DEWH MpcAgent in each package, soft comfort band, N=4."""
    N, nc = 4, 7
    soft = [k * nc + r for k in range(N) for r in (0, 1)]
    out = []
    for dewh, Ctrl, Spec, agent, kw in (
            (jdewh, JController, JSpec, jagent, {}),
            (tdewh, MpcController, BnbSpec, tagent, dict(device="cpu"))):
        model = dewh.dewh_model()
        ctrl = Ctrl(model, N, dewh.dewh_weights(), solver="bnb",
                    bnb_spec=Spec(capacity=64, wave_size=16,
                                  qp_iters=200), **kw)
        ctrl.set_soft_constraints(soft, lin_pen=5.0, quad_pen=1.0)
        a = agent.MpcAgent(model, ctrl, name="heater")
        a.reset(np.array([52.0, 0.0]))
        out.append(a)
    rng = np.random.default_rng(2)
    omega = (0.5 * (rng.uniform(size=(T + N, 1)) < 0.3)).astype(np.float32)
    prices = tdewh.dewh_energy_price_seq(
        rng.uniform(0.05, 0.3, T + N), tdewh.DewhParams()).astype(np.float32)
    return out, omega, prices


def test_mpc_agent_run_matches_reference_and_run_compiled():
    """MpcAgent.run (the host loop) against the reference's on the same
    draws and tariff: the same applied inputs (the unrounded binaries
    within 1e-5), states within 1e-3,
    objectives within 1e-3 relative; the history has the reference's
    columns; run_compiled from the same state follows the same
    trajectory."""
    T = 3
    (ja, ta), omega, prices = _dewh_agents(T)
    jh = ja.run(T, omega_traj=omega, price_traj=prices, Ts=900.0)
    th = ta.run(T, omega_traj=omega, price_traj=prices, Ts=900.0)
    assert list(th.columns) == list(jh.columns)
    assert (th.index == jh.index).all()
    # the agent applies the solver's binaries unrounded: fp32 noise
    np.testing.assert_array_equal(np.round(th["u0"].to_numpy()),
                                  np.round(jh["u0"].to_numpy()))
    np.testing.assert_allclose(th["u0"].to_numpy(), jh["u0"].to_numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(th["x0"].to_numpy(), jh["x0"].to_numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(th["obj"].to_numpy(), jh["obj"].to_numpy(),
                               rtol=1e-3)
    assert th["found"].all()
    with pytest.raises(ValueError, match="do not match"):
        tagent.MpcAgent(tbat.battery_model(), ta.controller)
    ta.reset(np.array([52.0, 0.0]))
    res = ta.run_compiled(T, omega_traj=omega, price_traj=prices)
    np.testing.assert_allclose(res.vs[:, 0].numpy(), th["u0"].to_numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(res.xs[:-1, 0].numpy(), th["x0"].to_numpy(),
                               atol=1e-3)


def test_history_without_pandas_is_the_same_columns(monkeypatch):
    """Where pandas does not import, history() is a dict of the same
    columns as numpy arrays."""
    import builtins

    (_, ta), omega, prices = _dewh_agents(2)
    ta.run(2, omega_traj=omega, price_traj=prices)
    df = ta.history()
    real_import = builtins.__import__

    def no_pandas(name, *a, **kw):
        if name == "pandas":
            raise ImportError("no pandas")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pandas)
    cols = ta.history()
    assert isinstance(cols, dict) and list(cols) == list(df.columns)
    np.testing.assert_array_equal(cols["x0"], df["x0"].to_numpy())


# ---- agents/micro_grid.py ---------------------------------------------------

def test_micro_grid_coordinator_matches_reference():
    """M=2 heaters, one of which must wait (P_max 3 kW), N=4, the
    example's spec, 3 steps on the same draws: the same applied heater
    inputs and startup binaries and total power each step, objectives
    within 1e-3 relative, the coupling held."""
    M, steps = 2, 3
    spec = dict(capacity=256, wave_size=32, qp_iters=200)
    mgs = []
    for dewh, grid, mg, Spec, kw in (
            (jdewh, jgrid, jmg, JSpec, {}),
            (tdewh, tgrid, tmg, BnbSpec, dict(device="cpu"))):
        g = grid.GridParams(P_max=(M - 1) * 3000.0,
                            tou_prices=grid.default_tou_profile())
        c = mg.MicroGridCoordinator([dewh.DewhParams() for _ in range(M)],
                                    g, N=4, solver="bnb",
                                    bnb_spec=Spec(**spec), **kw)
        c.reset([np.array([52.0 + i, 0.0]) for i in range(M)])
        mgs.append(c)
    rng = np.random.default_rng(0)
    for k in range(steps):
        draws = (rng.uniform(0, 1, M) < 0.2) * 0.5
        js, ts = (c.sim_step(omega_k=draws) for c in mgs)
        assert ts.total_power == js.total_power <= 3000.0
        for jp, tp in zip(js.per_agent, ts.per_agent):
            assert np.round(float(tp.u[0])) == np.round(float(jp.u[0]))
            assert np.round(float(tp.delta[0])) == np.round(
                float(jp.delta[0]))
            assert tp.z is None and jp.z is None
        assert float(ts.obj) == pytest.approx(float(js.obj), rel=1e-3)
        np.testing.assert_allclose(mgs[1].x.numpy(), np.asarray(mgs[0].x),
                                   atol=1e-3)
    assert len(mgs[1].agents[0].history(Ts=900.0)) == steps


# ---- agents/decentralized.py ------------------------------------------------

def _decentralized(M, P_max, x0s, **kw):
    spec = dict(capacity=64, wave_size=8, qp_iters=150, max_waves=16)
    out = []
    for dewh, grid, dec, Spec, dkw in (
            (jdewh, jgrid, jdec, JSpec, {}),
            (tdewh, tgrid, tdec, BnbSpec, dict(device="cpu"))):
        g = grid.GridParams(P_max=P_max,
                            tou_prices=grid.default_tou_profile())
        d = dec.DecentralizedMicroGrid([dewh.DewhParams()
                                        for _ in range(M)], g, N=4,
                                       bnb_spec=Spec(**spec), **kw, **dkw)
        d.reset(x0s)
        out.append(d)
    return out


def test_decentralized_matches_reference():
    """M=3 agents, 2 of 3 heaters fit, 2 steps on the same draws: each
    dual round is one pooled B&B over the agents (a global wave of 3·8
    nodes, a pool of 3·64), where the reference vmaps the agents'
    searches — the same applied u and congestion prices λ, the same
    states within 1e-3, the coupling held after rationing."""
    M = 3
    jd, td = _decentralized(M, 6000.0,
                            [np.array([50.0 + 0.2 * i, 0.0])
                             for i in range(M)], dual_rounds=4)
    assert (td.pooled_spec.wave_size, td.pool_slots) == (24, 192)
    rng = np.random.default_rng(0)
    for _ in range(2):
        w = (rng.uniform(0, 1, M) < 0.2) * 0.3
        js, ts = jd.sim_step(omega_k=w), td.sim_step(omega_k=w)
        np.testing.assert_array_equal(ts.u, js.u)
        np.testing.assert_allclose(ts.lam, js.lam, rtol=1e-6, atol=1e-9)
        assert ts.agg_power == js.agg_power <= 6000.0 + 1e-6
        assert ts.found and js.found
        np.testing.assert_allclose(td.x.numpy(), np.asarray(jd.x),
                                   atol=1e-3)


def test_congestion_price_rises_under_scarcity():
    """Three identical cold agents and room for one heater: demand is 3×
    capacity, so the congestion price goes positive somewhere, as the
    reference's does (tests/test_decentralized.py), and rationing holds
    the coupling."""
    jd, td = _decentralized(3, 3000.0, [np.array([50.0, 0.0])] * 3,
                            dual_rounds=6, dual_step=5e-4)
    js, ts = jd.feedback(), td.feedback()
    assert ts.lam.max() > 0.0
    np.testing.assert_allclose(ts.lam, js.lam, rtol=1e-6, atol=1e-9)
    np.testing.assert_array_equal(ts.u, js.u)
    assert ts.agg_power <= 3000.0 + 1e-6


def test_agents_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tagent.Agent(tdewh.dewh_model())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdec.DecentralizedMicroGrid([tdewh.DewhParams()] * 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmg.MicroGridCoordinator([tdewh.DewhParams()] * 2, N=4)
