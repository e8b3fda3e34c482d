"""The port's model side (pyhybridcontrol_tpu_torch/mld/pwa.py,
mld/symbolic.py, models/pwa_examples.py, models/dewh.py) against the
reference's on the CPU.

Every constructor is float64 numpy in both packages, so the matrices are held
at rtol = atol = 1e-12 (in practice they are bitwise equal) with ``info``
and the variable types equal. The reference's own equivalence checks
(tests/test_mld.py, tests/test_models_dewh.py) are mirrored on the port's
models at the reference tests' tolerances: feasible (δ, z) of the active
region reproduce the PWA successor within 1e-4, a wrong region leaves a
residual above 1e-3, the big-M and hull leaves agree at 1e-6, and the
3-region MIQP's enumeration agrees with the fp64 oracle within 2e-3."""

import dataclasses

import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.mld as jmld
import pyhybridcontrol_tpu.models.dewh as jdewh
import pyhybridcontrol_tpu.models.pwa_examples as jpwa
import pyhybridcontrol_tpu_torch.mld as tmld
import pyhybridcontrol_tpu_torch.models.dewh as tdewh
import pyhybridcontrol_tpu_torch.models.pwa_examples as tpwa
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.solver.oracle import (
    solve_miqp_enumeration_oracle as j_enum_oracle)
from pyhybridcontrol_tpu_torch.mld.model import MATRIX_NAMES
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc, MpcWeights
from pyhybridcontrol_tpu_torch.solver import (
    solve_miqp_enumerate_device,
    solve_miqp_enumeration_oracle,
)

torch.set_num_threads(2)
TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float32))


def assert_same_model(tm, jm):
    """Port MldModel vs reference MldModel: info, types, 18 matrices."""
    assert dataclasses.asdict(tm.info) == dataclasses.asdict(jm.info)
    tn, jn = tm.numpy_mats(), jm.numpy_mats()
    for k in MATRIX_NAMES:
        np.testing.assert_allclose(tn[k], jn[k], err_msg=k, **TOL)


def _regions(mod, spec):
    return [mod.PwaRegion(**r) for r in spec]


def _two_region(mod):
    B = np.array([[0.0], [0.1]])
    return mod.PwaSystem(
        regions=_regions(mod, [
            dict(A=np.array([[1.0, 0.1], [-0.5, 1.0]]), B=B, c=np.zeros(2),
                 S=np.array([[-1.0, 0.0]]), R=np.zeros((1, 1)),
                 T=np.array([0.0])),                              # x1 ≥ 0
            dict(A=np.array([[1.0, 0.1], [-0.1, 1.0]]), B=B,
                 c=np.array([0.0, 0.02]), S=np.array([[1.0, 0.0]]),
                 R=np.zeros((1, 1)), T=np.array([-1e-9]))]),      # x1 < 0
        x_lb=np.array([-2.0, -2.0]), x_ub=np.array([2.0, 2.0]),
        u_lb=np.array([-1.0]), u_ub=np.array([1.0]))


def _three_region(mod, d=0.5):
    """Deadzone spring: stiff for |x1| ≥ d, free drift inside."""
    A_stiff = np.array([[1.0, 0.1], [-0.4, 1.0]])
    A_free = np.array([[1.0, 0.1], [0.0, 1.0]])
    B = np.array([[0.0], [0.1]])
    return mod.PwaSystem(
        regions=_regions(mod, [
            dict(A=A_stiff, B=B, c=np.array([0.0, -0.4 * d]),
                 S=np.array([[1.0, 0.0]]), R=np.zeros((1, 1)),
                 T=np.array([-d])),
            dict(A=A_free, B=B, c=np.zeros(2),
                 S=np.array([[1.0, 0.0], [-1.0, 0.0]]), R=np.zeros((2, 1)),
                 T=np.array([d, d])),
            dict(A=A_stiff, B=B, c=np.array([0.0, 0.4 * d]),
                 S=np.array([[-1.0, 0.0]]), R=np.zeros((1, 1)),
                 T=np.array([-d]))]),
        x_lb=np.array([-2.0, -2.0]), x_ub=np.array([2.0, 2.0]),
        u_lb=np.array([-1.0]), u_ub=np.array([1.0]))


def _spring(mod):
    """Config 2's spring: the examples module of ``mod``'s package."""
    return (tpwa if mod is tmld else jpwa).pwa_spring_system()


SYSTEMS = {"two_region": _two_region, "three_region": _three_region,
           "pwa_spring": _spring}


# ---- the constructors against the reference ------------------------------

@pytest.mark.parametrize("formulation", ["bigm", "hull"])
@pytest.mark.parametrize("system", sorted(SYSTEMS))
def test_pwa_to_mld_matches_reference(system, formulation):
    tm = tmld.pwa_to_mld(SYSTEMS[system](tmld), formulation=formulation)
    jm = jmld.pwa_to_mld(SYSTEMS[system](jmld), formulation=formulation)
    assert_same_model(tm, jm)


def test_pwa_to_mld_refuses_an_unknown_formulation():
    with pytest.raises(ValueError, match="formulation"):
        tmld.pwa_to_mld(_two_region(tmld), formulation="sos1")


def test_pwa_system_step_matches_reference(rng):
    ts, js = tpwa.pwa_spring_system(), jpwa.pwa_spring_system()
    assert (ts.nx, ts.nu) == (js.nx, js.nu) == (2, 1)
    for _ in range(10):
        x, u = rng.uniform(-4, 4, 2), rng.uniform(-2, 2, 1)
        np.testing.assert_allclose(ts.simulate_step(x, u),
                                   js.simulate_step(x, u), **TOL)
    with pytest.raises(ValueError, match="region"):
        _two_region(tmld).simulate_step(np.array([np.nan, 0.0]),
                                        np.zeros(1))


@pytest.mark.parametrize("on_off", [True, False])
@pytest.mark.parametrize("formulation", ["bigm", "hull"])
def test_pwa_spring_mld_matches_reference(formulation, on_off):
    tm = tpwa.pwa_spring_mld(on_off=on_off, formulation=formulation)
    jm = jpwa.pwa_spring_mld(on_off=on_off, formulation=formulation)
    assert_same_model(tm, jm)
    assert tm.info.u_types == (("c", "b") if on_off else ("c",))
    tw, jw = tpwa.pwa_weights(), jpwa.pwa_weights()
    for f in dataclasses.fields(MpcWeights):
        a, b = getattr(tw, f.name), getattr(jw, f.name)
        assert (a is None) == (b is None), f.name
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_template_materialize_and_cache():
    def build(Ts):
        return dict(A=np.array([[1.0, Ts], [0.0, 1.0]]),
                    B1=np.array([[0.5 * Ts**2], [Ts]]))

    tmpl = tmld.MldTemplate(build, required=("Ts",))
    m1, m2, m3 = (tmpl.materialize(Ts=0.5), tmpl.materialize(Ts=0.5),
                  tmpl(Ts=1.0))
    assert m1 is m2 and m1 is not m3          # cached per parameter value
    assert float(m3.mats.A[0, 1]) == 1.0
    assert_same_model(m1, jmld.MldTemplate(build, required=("Ts",))
                      .materialize(Ts=0.5))
    # an array parameter keys the cache by value; an unhashable one skips it
    arr = tmld.MldTemplate(lambda Ts, k: build(Ts), required=("Ts",))
    assert arr(Ts=0.5, k=np.ones(2)) is arr(Ts=0.5, k=np.ones(2))
    assert arr(Ts=0.5, k=object()) is not arr(Ts=0.5, k=object())
    with pytest.raises(ValueError, match="missing"):
        tmpl.materialize()


def test_from_sympy_matches_reference():
    sp = pytest.importorskip("sympy")
    Ts, tau = sp.symbols("Ts tau")
    mats = {"A": sp.Matrix([[1, Ts], [0, 1 - Ts / tau]]),
            "B1": sp.Matrix([[0], [Ts / tau]])}
    tm = tmld.from_sympy(mats).materialize(Ts=0.25, tau=2.0)
    np.testing.assert_allclose(tm.mats.A.numpy(), [[1.0, 0.25], [0.0, 0.875]],
                               rtol=1e-6)
    np.testing.assert_allclose(tm.mats.B1.numpy(), [[0.0], [0.125]],
                               rtol=1e-6)
    assert_same_model(tm, jmld.from_sympy(mats).materialize(Ts=0.25,
                                                            tau=2.0))
    with pytest.raises(ValueError):
        tmld.from_sympy(mats).materialize(Ts=0.25)      # missing tau


def test_dewh_model_matches_reference():
    p = dict(Ts=600.0, C_w=1.0e6, UA=3.0, P_h=2500.0, T_amb=18.0,
             dT_draw=10.0, T_min=48.0, T_max=72.0)
    tm, jm = tdewh.dewh_matrices(**p), jdewh.dewh_matrices(**p)
    assert tm.keys() == jm.keys()
    for k in tm:
        np.testing.assert_allclose(tm[k], jm[k], err_msg=k, **TOL)
    for params in (None, p):
        assert_same_model(
            tdewh.dewh_model(params and tdewh.DewhParams(**params)),
            jdewh.dewh_model(params and jdewh.DewhParams(**params)))
    m = tdewh.dewh_model()
    assert m.info.x_types == ("c", "b") and m.info.u_types == ("b",)
    assert m is tdewh.dewh_model()            # the template's cache
    tw, jw = tdewh.dewh_weights(T_set=58.0), jdewh.dewh_weights(T_set=58.0)
    for k in ("Qx", "qdelta", "x_ref"):
        np.testing.assert_array_equal(getattr(tw, k), getattr(jw, k))


@pytest.mark.parametrize("kw", [dict(min_up=2), dict(min_up=3, min_down=2),
                                dict(min_down=3), dict()])
def test_min_up_down_rows_match_reference(kw):
    ta, tb = tdewh.min_up_down_rows(8, 2, **kw)
    ja, jb = jdewh.min_up_down_rows(8, 2, **kw)
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tb, jb)
    assert ta.shape[1] == 16


def test_dewh_energy_price_seq_matches_reference(rng):
    prices = rng.uniform(0.05, 0.4, 12)
    for p in (tdewh.DewhParams(), tdewh.DewhParams(P_h=2000.0, Ts=600.0)):
        jp = jdewh.DewhParams(**dataclasses.asdict(p))
        np.testing.assert_allclose(
            tdewh.dewh_energy_price_seq(prices, p, nv=2),
            jdewh.dewh_energy_price_seq(prices, jp, nv=2), **TOL)


# ---- the reference's equivalence checks on the port's models -------------

def _residual_and_step(m, x, u, delta, z):
    args = [_t(a) for a in (x, u, delta, z)]
    return (float(m.constraint_residual(*args).max()),
            m.step(*args).numpy())


@pytest.mark.parametrize("formulation", ["bigm", "hull"])
def test_pwa_mld_equivalence_random_points(rng, formulation):
    """For random (x, u) in the box the active region's (δ, z) is feasible
    and gives the exact PWA successor; claiming the other region is not."""
    sys = _two_region(tmld)
    m = tmld.pwa_to_mld(sys, formulation=formulation)
    hull = formulation == "hull"
    assert m.info.ndelta == 2 and m.info.nz == (6 if hull else 4)
    for _ in range(30):
        x, u = rng.uniform(-1.9, 1.9, 2), rng.uniform(-0.9, 0.9, 1)
        if abs(x[0]) < 1e-6:
            continue
        want = sys.simulate_step(x, u)
        active = 0 if x[0] >= 0 else 1
        delta = np.eye(2)[active]
        if hull:
            z = np.zeros(6)
            z[active * 3: active * 3 + 2], z[active * 3 + 2] = x, u[0]
        else:
            z = np.zeros(4)
            z[active * 2:(active + 1) * 2] = want
        r, got = _residual_and_step(m, x, u, delta, z)
        assert r <= 1e-4, "feasible point rejected"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        r, _ = _residual_and_step(m, x, u, np.eye(2)[1 - active], z)
        assert r > 1e-3, "wrong-region point accepted"


@pytest.mark.parametrize("formulation", ["bigm", "hull"])
def test_pwa_three_region_equivalence(rng, formulation):
    sys = _three_region(tmld)
    m = tmld.pwa_to_mld(sys, formulation=formulation)
    assert m.info.ndelta == 3
    assert m.info.nz == (9 if formulation == "hull" else 6)
    checked = 0
    for _ in range(60):
        x, u = rng.uniform(-1.9, 1.9, 2), rng.uniform(-0.9, 0.9, 1)
        if min(abs(x[0] - 0.5), abs(x[0] + 0.5)) < 1e-3:
            continue                      # off the guard boundaries
        checked += 1
        want = sys.simulate_step(x, u)
        active = 0 if x[0] <= -0.5 else (2 if x[0] >= 0.5 else 1)
        if formulation == "hull":
            z = np.zeros(9)
            z[active * 3: active * 3 + 2], z[active * 3 + 2] = x, u[0]
        else:
            z = np.zeros(6)
            z[active * 2:(active + 1) * 2] = want
        r, got = _residual_and_step(m, x, u, np.eye(3)[active], z)
        assert r <= 1e-4, "feasible point rejected"
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        r, _ = _residual_and_step(m, x, u, np.eye(3)[(active + 1) % 3], z)
        assert r > 1e-3, "wrong-region point accepted"
    assert checked >= 40


def test_pwa_hull_leaf_matches_bigm_leaf():
    """The two formulations encode the same MIQP: at a fixed binary
    pattern the leaf QP optima agree (fp64)."""
    import scipy.optimize as sopt

    x0, N = np.array([1.5, 0.0]), 4
    bits = np.tile([1.0, 1.0, 0.0], N)    # actuator on, region 1

    def leaf(model):
        c = CondensedMpc(model, N, tpwa.pwa_weights())
        fo, ho = c.assemble_np(x0)
        lb, ub = np.array(c.lb), np.array(c.ub)
        lb[c.binary_idx] = ub[c.binary_idx] = bits
        r = sopt.minimize(
            lambda V: 0.5 * V @ c.H @ V + fo @ V, np.zeros(c.nV),
            jac=lambda V: c.H @ V + fo,
            constraints=[sopt.LinearConstraint(c.G, -np.inf, ho)],
            bounds=sopt.Bounds(lb, ub), method="SLSQP",
            options=dict(maxiter=800, ftol=1e-12))
        assert r.status == 0, r.message
        return r.fun

    np.testing.assert_allclose(
        leaf(tpwa.pwa_spring_mld(on_off=True, formulation="bigm")),
        leaf(tpwa.pwa_spring_mld(on_off=True, formulation="hull")),
        rtol=1e-6, atol=1e-6)


@pytest.mark.slow
def test_pwa_three_region_miqp_parity():
    """The 3-region MIQP at N=2: the port's enumeration on the CPU
    against the port's fp64 oracle (2e-3), and both formulations on one
    optimum (~60 s here, the oracle's 128 QPs: the slow lane, as the
    reference's own test)."""
    w = MpcWeights(Qx=np.array([4.0, 0.4]), QxN=np.array([8.0, 0.8]),
                   Ru=np.array([0.1]))
    x0 = np.array([1.2, 0.0], np.float32)
    objs = {}
    for formulation in ("hull", "bigm"):
        c = CondensedMpc(tmld.pwa_to_mld(_three_region(tmld),
                                         formulation=formulation), 2, w)
        qp, spec = c.device_qp("cpu"), prepare_admm_mpc(c, device="cpu")
        f, h = qp.assemble(torch.as_tensor(x0))
        _, obj, _, _ = solve_miqp_enumerate_device(spec, qp, f, h,
                                                   iters=1500)
        fo, ho = c.assemble_np(x0)
        oracle = solve_miqp_enumeration_oracle(c.H, fo, c.G, ho, c.lb, c.ub,
                                               c.binary_idx)
        assert abs(float(obj) - oracle.obj) < 2e-3, formulation
        objs[formulation] = oracle.obj
    np.testing.assert_allclose(objs["hull"], objs["bigm"], rtol=1e-5,
                               atol=1e-5)


def test_dewh_dynamics_physical():
    m = tdewh.dewh_model()
    x, on, off, none = _t([60.0, 0.0]), _t([1.0]), _t([0.0]), _t([0.0])
    x1 = m.step(x, u=off, delta=off, omega=none)     # decays toward ambient
    assert 55.0 < float(x1[0]) < 60.0
    x2 = m.step(x, u=on, delta=on, omega=none)       # heater on heats
    assert float(x2[0]) > float(x1[0])
    x3 = m.step(x, u=off, delta=off, omega=_t([1.0]))  # a draw cools
    assert float(x3[0]) < float(x1[0])
    assert float(x2[1]) == 1.0 and float(x1[1]) == 0.0  # m remembers u


def test_dewh_startup_logic():
    m = tdewh.dewh_model()

    def feas(x, u, d):
        r = m.constraint_residual(_t(x), _t([u]), _t([d]), None, _t([0.0]))
        return float(r.max()) <= 1e-6

    assert feas([60.0, 0.0], 1.0, 1.0)        # turning on from off = startup
    assert not feas([60.0, 0.0], 1.0, 0.0)    # must flag the startup
    assert feas([60.0, 1.0], 1.0, 0.0)        # staying on: no startup
    assert not feas([60.0, 1.0], 1.0, 1.0)    # cannot claim one
    assert feas([60.0, 0.0], 0.0, 0.0)


def test_min_up_down_rows():
    A_v, b = tdewh.min_up_down_rows(N=6, nv=2, min_up=3, min_down=2)
    assert A_v.shape[1] == 12 and len(b) == A_v.shape[0] > 0
    V = np.zeros((6, 2))
    V[0] = [1.0, 1.0]      # u on, startup flagged
    assert (A_v @ V.reshape(-1) - b).max() > 0.5   # off again at k=1
    V[1] = V[2] = [1.0, 0.0]
    assert (A_v @ V.reshape(-1) - b).max() <= 1e-9


def test_unit_commitment_condensed():
    """Min-up rows in the condensed MIQP force heater runs of ≥ 3 steps
    (N=4: 4 u, 4 startups and 4 binary-state auxiliaries; the port's
    oracle against the reference's at 1e-9 relative)."""
    model = tdewh.dewh_model()
    N = 4
    c = CondensedMpc(model, N, tdewh.dewh_weights(T_set=60.0))
    A_v, b = tdewh.min_up_down_rows(N, model.info.nv, min_up=3)
    c2 = c.with_extra_constraints(A_v, b)
    assert c2.G.shape[0] == c.G.shape[0] + A_v.shape[0]
    f, h = c2.assemble_np(np.array([52.0, 0.0]))
    r = solve_miqp_enumeration_oracle(c2.H, f, c2.G, h, c2.lb, c2.ub,
                                      c2.binary_idx)
    assert r.status == "optimal"
    ref = j_enum_oracle(c2.H, f, c2.G, h, c2.lb, c2.ub, c2.binary_idx)
    assert abs(r.obj - ref.obj) <= 1e-9 * max(1.0, abs(ref.obj))
    us = np.round(r.x[:N * model.info.nv].reshape(N, -1)[:, 0])
    runs = "".join("1" if u > 0.5 else "0" for u in us).split("0")
    assert all(len(s) >= 3 for s in runs[:-1] if s), us
    jc = JCondensed(jdewh.dewh_model(), N, jdewh.dewh_weights(T_set=60.0))
    np.testing.assert_allclose(c2.G, jc.with_extra_constraints(A_v, b).G,
                               **TOL)
