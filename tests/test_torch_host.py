"""Port vs reference: host builders (condensation, ADMM prep, σ=0 kernel
prep), DeviceQP assembly, the MLD model, and the convert.py round trip.

Both packages run the same float64 numpy code on the same fp32-rounded
model matrices, so the fp64 arrays agree to rounding (atol 1e-12) and the
fp32 device arrays are bit-identical after the cast."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.ops.admm import prepare_admm_mpc as j_prepare
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.ops.pallas_admm import prepare_pallas
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops.admm import admm_solve
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc as t_prepare
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc as TCondensed
from pyhybridcontrol_tpu_torch.ops.cuda_admm import prepare_kernel_qp

torch.set_num_threads(2)

HOST_FIELDS = ("H", "f0", "Fx", "Fw", "Fup", "G", "h0", "Hx", "Hw", "lb",
               "ub", "T_full", "binary_mask", "z_rows")


def _pair(N):
    jc = JCondensed(jdi.switched_double_integrator(), N,
                    jdi.default_weights())
    tc = TCondensed(tdi.switched_double_integrator(), N,
                    tdi.default_weights())
    return jc, tc


def _exact(port, ref, name=""):
    ref = np.asarray(ref)
    assert port.dtype == ref.dtype, name
    np.testing.assert_array_equal(port, ref, err_msg=name)


@pytest.mark.parametrize("N", [4, 8])
def test_condensed_mpc_matches_reference(N):
    jc, tc = _pair(N)
    for k in HOST_FIELDS:
        # fp64 host arrays: same code, same data → equal to rounding
        np.testing.assert_allclose(getattr(tc, k), getattr(jc, k),
                                   rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_array_equal(tc.binary_idx, jc.binary_idx)
    x0 = np.array([2.0, -0.5])
    for a, b in zip(tc.assemble_np(x0), jc.assemble_np(x0)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("N", [4, 8])
def test_device_qp_matches_reference(N):
    jc, tc = _pair(N)
    jq, tq = jc.device_qp(), tc.device_qp("cpu")
    for k, v in convert.to_numpy(tq).items():
        _exact(v, getattr(jq, k), k)       # fp32 after the cast: exact
    assert tq.binary_idx == jq.binary_idx
    assert tq.binary_shift == jq.binary_shift
    assert (tq.n, tq.m, tq.N) == (jq.n, jq.m, jq.N)


@pytest.mark.parametrize("rho", [1.0, 10.0])
def test_prepare_admm_matches_reference(rho):
    jc, tc = _pair(6)
    js, ts = j_prepare(jc, rho=rho), t_prepare(tc, rho=rho, device="cpu")
    for k, v in convert.to_numpy(ts).items():
        _exact(v, getattr(js, k), k)
    assert (ts.rho, ts.sigma, ts.alpha, ts.m_ineq) == (
        js.rho, js.sigma, js.alpha, js.m_ineq)


@pytest.mark.parametrize("rho", [1.0, 10.0])
def test_prepare_kernel_qp_matches_prepare_pallas(rho):
    jc, tc = _pair(6)
    pq = prepare_pallas(j_prepare(jc, rho=rho))
    kq = prepare_kernel_qp(t_prepare(tc, rho=rho, device="cpu"))
    assert (kq.n_pad, kq.m_pad) == (pq.n_pad, pq.m_pad)
    for k, v in convert.to_numpy(kq).items():
        ref = np.asarray(getattr(pq, k))
        _exact(v, ref if ref.ndim == 2 and ref.shape[1] > 1
               else ref.reshape(-1), k)


def test_prepare_kernel_qp_requires_diagonal_box():
    _, tc = _pair(4)
    spec = t_prepare(tc, device="cpu")
    spec.A[spec.m_ineq, 1] = 0.5          # box row 0 no longer diagonal
    with pytest.raises(ValueError, match="diagonal"):
        prepare_kernel_qp(spec)


def test_assemble_and_full_v_match_reference(rng):
    jc, tc = _pair(6)
    jq, tq = jc.device_qp(), tc.device_qp("cpu")
    x0s = rng.normal(size=(16, 2)).astype(np.float32)
    jf, jh = jax.vmap(jq.assemble)(jnp.asarray(x0s))
    tf, th = tq.assemble(torch.as_tensor(x0s))
    # fp32 mat-vecs summed in another order: rounding-level differences
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-6,
                               atol=1e-5)
    V = rng.normal(size=(3, tq.n)).astype(np.float32)
    np.testing.assert_allclose(tq.full_v(torch.as_tensor(V)).numpy(),
                               np.asarray(jq.full_v(jnp.asarray(V))),
                               rtol=1e-6, atol=1e-6)


def test_mld_model_matches_reference(rng):
    jm = jdi.switched_double_integrator()
    tm = tdi.switched_double_integrator()
    jn, tn = jm.numpy_mats(), tm.numpy_mats()
    assert sorted(jn) == sorted(tn)
    assert convert.mld_info(jm.info) == tm.info
    for k in jn:
        _exact(tn[k], jn[k], k)
    v = rng.normal(size=(5, tm.info.nv)).astype(np.float32)
    x0 = np.array([1.0, -2.0], np.float32)
    jx, jy = jm.lsim(jnp.asarray(x0), jnp.asarray(v))
    tx, ty = tm.lsim(torch.as_tensor(x0), torch.as_tensor(v))
    # five fp32 steps, rounding-level differences only
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-6,
                               atol=1e-6)


def test_mld_model_validation():
    from pyhybridcontrol_tpu_torch.mld import MldInfo, MldModel

    with pytest.raises(ValueError, match="shape"):
        MldModel.from_matrices(MldInfo(nx=2, nu=1), A=np.eye(3))
    m = MldModel.from_matrices(A=np.eye(2), B1=np.ones((2, 1)))
    assert (m.info.nx, m.info.nu) == (2, 1)
    assert tuple(m.mats.F1.shape) == (0, 1)


def test_convert_round_trip(rng):
    """Reference objects → port objects → numpy equals the reference's
    own arrays, and a converted spec solves like a port-prepared one."""
    jc, tc = _pair(6)
    js = j_prepare(jc)
    jq = jc.device_qp()
    pq = prepare_pallas(js)
    ts = convert.box_qp(js, "cpu")
    tq = convert.device_qp(jq, "cpu")
    kq = convert.kernel_qp(pq, ts)
    for obj, ref in ((ts, js), (tq, jq)):
        for k, v in convert.to_numpy(obj).items():
            _exact(v, getattr(ref, k), k)
    for k, v in convert.to_numpy(kq).items():
        _exact(v, np.asarray(getattr(pq, k)).reshape(v.shape), k)
    assert tq.info == tc.info and tq.binary_idx == jq.binary_idx
    own = t_prepare(tc, device="cpu")
    for k, v in convert.to_numpy(own).items():
        _exact(v, convert.to_numpy(ts)[k], k)
    own_kq = prepare_kernel_qp(own)
    for k, v in convert.to_numpy(own_kq).items():
        _exact(v, convert.to_numpy(kq)[k], k)
    f, h = tq.assemble(torch.as_tensor(rng.normal(size=(4, 2)),
                                       dtype=torch.float32))
    a = admm_solve(ts, f, h, tq.lb, tq.ub, iters=50)
    b = admm_solve(own, f, h, tq.lb, tq.ub, iters=50)
    assert torch.equal(a.obj, b.obj) and torch.equal(a.x, b.x)
