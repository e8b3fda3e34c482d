"""Lift-and-project split cuts of the port (ops/cuts.py) on the CPU:
against the reference's ``with_split_cuts`` on tests/test_cuts.py's N=2
and N=3 frames, the reference's machine checks run on the port's cuts
(validity over every binary assignment, the MIQP optimum unchanged, the
disturbance channel refused), and the port's trust box.

Both packages run the same fp64 numpy code on the same frame (the models'
fp32 matrices widened to fp64), one HiGHS LP a cut. Tolerances: the same
cut count; the cut rows (scaled as the reference scales them: max |a_V|
= 1) and root bounds within 1e-6; validity 1e-7; optima 1e-6 relative."""

import numpy as np
import pytest
import torch

from pyhybridcontrol_tpu.models.pwa_examples import pwa_spring_mld as j_pwa
from pyhybridcontrol_tpu.models.pwa_examples import pwa_weights as j_pww
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.ops.cuts import with_split_cuts as j_cuts
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.models import double_integrator as tdi
from pyhybridcontrol_tpu_torch.models.pwa_examples import (
    pwa_spring_mld,
    pwa_weights,
)
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.ops.cuts import _lifted_rows, with_split_cuts

X0_LO = np.array([0.5, -1.0])
X0_HI = np.array([2.5, 1.0])
X0N = np.array([1.5, 0.0])
GEN = dict(n_per_round=3, rounds=2, n_tilts=1)


def _gen(N, **kw):
    c = CondensedMpc(pwa_spring_mld(on_off=True, formulation="hull"), N,
                     pwa_weights())
    cut, diag = with_split_cuts(c, X0_LO, X0_HI, X0N,
                                return_diagnostics=True, **kw)
    return c, cut, diag


@pytest.fixture(scope="module")
def n2():
    return _gen(2, **GEN)


@pytest.mark.parametrize("N", [2, 3])
def test_cuts_match_reference(N, n2):
    """The same frame in both packages, the same cuts out."""
    jc = JCondensed(j_pwa(on_off=True, formulation="hull"), N, j_pww())
    jcut, jd = j_cuts(jc, X0_LO, X0_HI, X0N, return_diagnostics=True, **GEN)
    c, cut, d = n2 if N == 2 else _gen(N, **GEN)
    np.testing.assert_array_equal(c.G, np.asarray(jc.G))
    assert d.n_cuts == jd.n_cuts >= 1
    assert d.rounds == jd.rounds
    m = c.G.shape[0]
    for k in ("G", "h0", "Hx", "Hw"):
        np.testing.assert_allclose(getattr(cut, k)[m:],
                                   np.asarray(getattr(jcut, k))[m:],
                                   rtol=0, atol=1e-6, err_msg=k)
    np.testing.assert_allclose([d.root_bound_before, d.root_bound_after],
                               [jd.root_bound_before, jd.root_bound_after],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.violations, jd.violations, atol=1e-6)
    if N == 3:       # the reference's "raise the root bound" reading
        assert d.root_bound_after > d.root_bound_before + 0.05


def test_split_cuts_valid_exhaustive(n2):
    """Every binary assignment of the N=2 instance: the largest violation
    of each of the port's cuts over the assignment's feasible (V, x0) set
    (an LP per assignment and cut over the lifted polytope) is at most
    the feasibility tolerance."""
    from scipy.optimize import linprog

    c, cut, diag = n2
    nV = c.H.shape[0]
    bidx = np.asarray(c.binary_idx)
    nb = len(bidx)
    C, d = _lifted_rows(c.G, c.h0, c.Hx, c.lb, c.ub, X0_LO, X0_HI)
    m = c.G.shape[0]
    Aeq = np.zeros((nb, C.shape[1]))
    Aeq[np.arange(nb), bidx] = 1.0
    worst, feasible = -np.inf, 0
    for code in range(2 ** nb):
        b = np.array([(code >> i) & 1 for i in range(nb)], float)
        any_feas = False
        for aV, ax, bb in zip(cut.G[m:], cut.Hx[m:], cut.h0[m:]):
            cobj = np.concatenate([-aV, ax])     # max aV·V + a_x·x0
            r = linprog(cobj, A_ub=C, b_ub=d, A_eq=Aeq, b_eq=b,
                        bounds=[(None, None)] * C.shape[1], method="highs")
            if r.status == 2:
                break                            # infeasible assignment
            assert r.success, r.message
            any_feas = True
            worst = max(worst, -r.fun - bb)
        feasible += any_feas
    assert feasible > 0
    assert worst <= 1e-7, worst


def _optimum(c, x0):
    """The MIQP optimum of frame ``c`` at x0 over all 2^nb assignments, as
    the enumeration oracle computes it (solver/oracle.py's fp64 QP on each
    leaf), with each empty leaf found by HiGHS first: the QP oracle takes
    its full iteration budget to call a leaf infeasible, which makes
    ``solve_miqp_enumeration_oracle`` ~30 s a frame here."""
    from scipy.optimize import linprog

    from pyhybridcontrol_tpu_torch.solver.oracle import solve_qp_oracle

    f, h = c.assemble_np(x0)
    b = np.asarray(c.binary_idx)
    best = np.inf
    for code in range(2 ** len(b)):
        lb, ub = c.lb.copy(), c.ub.copy()
        lb[b] = ub[b] = [(code >> i) & 1 for i in range(len(b))]
        bounds = [(lo if np.isfinite(lo) else None,
                   hi if np.isfinite(hi) else None) for lo, hi in zip(lb, ub)]
        if linprog(np.zeros(len(lb)), A_ub=c.G, b_ub=h, bounds=bounds,
                   method="highs").status == 2:
            continue
        r = solve_qp_oracle(c.H, f, c.G, h, lb, ub, tol=1e-9)
        assert r.status == "optimal"
        best = min(best, r.obj)
    return best


def test_split_cuts_preserve_miqp_optimum(n2):
    """The fp64 optimum is unchanged by the cuts at two x0 inside the
    trust box."""
    c, cut, _ = n2
    for x0 in (X0N, np.array([0.8, 0.6])):
        o0, o1 = _optimum(c, x0), _optimum(cut, x0)
        assert np.isfinite(o0)
        assert abs(o0 - o1) <= 1e-6 * max(1.0, abs(o0))


def test_split_cuts_refuse_disturbance_channel():
    base = tdi.switched_double_integrator()
    m = base.numpy_mats()
    omega_di = MldModel.from_matrices(
        MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
                ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    c = CondensedMpc(omega_di, 4, tdi.default_weights())
    with pytest.raises(ValueError, match="disturbance"):
        with_split_cuts(c, [-1, -1], [1, 1], [0, 0])


def test_trust_box_is_carried_and_refused_outside(n2):
    """The cut frame carries its trust box through later transforms and
    ``device_qp``; an x0 outside it is refused on the host (assemble_np,
    the controller's feedback) and on the device (DeviceQP.assemble,
    batched too), an x0 on its corners is taken. A frame without cuts
    takes any x0."""
    c, cut, _ = n2
    assert c.x0_box is None
    lo, hi = cut.x0_box
    np.testing.assert_array_equal(lo, X0_LO)
    np.testing.assert_array_equal(hi, X0_HI)
    soft = cut.with_soft_constraints([0, 1], lin_pen=5.0)
    qp = soft.device_qp("cpu")
    assert [b.tolist() for b in qp.x0_box] == [X0_LO.tolist(),
                                                X0_HI.tolist()]
    outside = np.array([2.6, 0.0])
    for x0 in (X0_LO, X0_HI, X0N):
        soft.assemble_np(x0)
        qp.assemble(torch.as_tensor(x0, dtype=torch.float32))
    with pytest.raises(ValueError, match="trust box"):
        soft.assemble_np(outside)
    with pytest.raises(ValueError, match="trust box"):
        qp.assemble(torch.tensor(outside, dtype=torch.float32))
    with pytest.raises(ValueError, match="trust box"):
        qp.assemble(torch.tensor(np.array([X0N, [0.5, -1.5]]),
                                 dtype=torch.float32))
    c.assemble_np(outside)
    assert c.device_qp("cpu").x0_box is None
    # a second generation holds on the intersection of the two boxes
    again = with_split_cuts(cut, [0.0, -0.5], [2.0, 2.0], X0N, rounds=1,
                            n_per_round=1)
    assert [b.tolist() for b in again.x0_box] == [[0.5, -0.5], [2.0, 1.0]]
    tc = MpcController(pwa_spring_mld(on_off=True, formulation="hull"), 2,
                       pwa_weights(), device="cpu")
    tc.condensed.x0_box = cut.x0_box         # a controller over a cut frame
    with pytest.raises(ValueError, match="trust box"):
        tc.feedback(outside)
