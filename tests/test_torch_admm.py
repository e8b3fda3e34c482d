"""Port vs reference: the plain torch σ-form ADMM (``admm_solve``), the
Falk dual bound, the node certificate, the implied box and the OSQP
infeasibility certificate, cold and warm, on identical prepared data
(convert.py carries the reference's arrays across)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.ops import admm as jadmm
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import admm as tadmm

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def prob():
    """N=6 double integrator, a batch of 32 seeded states and B&B-node
    boxes (a seeded third of the binaries fixed per node)."""
    rng = np.random.default_rng(1)
    c = JCondensed(jdi.switched_double_integrator(), 6,
                   jdi.default_weights())
    jq, js = c.device_qp(), jadmm.prepare_admm_mpc(c)
    B = 32
    x0s = rng.normal(scale=2.0, size=(B, 2)).astype(np.float32)
    f, h = (np.array(a) for a in jax.vmap(jq.assemble)(jnp.asarray(x0s)))
    lb = np.broadcast_to(np.asarray(jq.lb), (B, jq.n)).copy()
    ub = np.broadcast_to(np.asarray(jq.ub), (B, jq.n)).copy()
    bidx = np.asarray(jq.binary_idx)
    fm = rng.uniform(size=(B, len(bidx))) < 0.35
    fv = (rng.uniform(size=(B, len(bidx))) < 0.5).astype(np.float32)
    lb[:, bidx] = np.where(fm, fv, 0.0)
    ub[:, bidx] = np.where(fm, fv, 1.0)
    return dict(js=js, ts=convert.box_qp(js, "cpu"), bidx=bidx,
                data=(f, h, lb, ub))


def _both(fn_j, fn_t, data):
    return (fn_j(*map(jnp.asarray, data)),
            fn_t(*map(torch.as_tensor, data)))


def _close(t, j, rtol, atol, name):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=rtol,
                               atol=atol, err_msg=name)


@pytest.mark.parametrize("iters", [60, 300])
@pytest.mark.parametrize("warm", [False, True])
def test_admm_solve_matches_reference(prob, iters, warm):
    js, ts = prob["js"], prob["ts"]
    f, h, lb, ub = prob["data"]
    jw = tw = None
    if warm:
        r0 = jadmm.admm_solve(js, *map(jnp.asarray, prob["data"]), iters=40)
        jw = (r0.x, r0.z, r0.y)
        tw = tuple(torch.as_tensor(np.array(a)) for a in jw)
    jr, tr = _both(lambda *a: jadmm.admm_solve(js, *a, iters=iters, warm=jw),
                   lambda *a: tadmm.admm_solve(ts, *a, iters=iters, warm=tw),
                   prob["data"])
    # same σ-form iteration in fp32; only the summation order of the
    # products differs (the port sums the objective in fp64), so the
    # iterates agree to accumulated fp32 noise
    scale = np.maximum(1.0, np.abs(np.asarray(jr.obj)))
    assert np.all(np.abs(tr.obj.numpy() - np.asarray(jr.obj))
                  <= 1e-4 * scale)
    _close(tr.x, jr.x, 1e-3, 1e-3, "x")
    _close(tr.z, jr.z, 1e-3, 1e-3, "z")
    _close(tr.r_prim_rel, jr.r_prim_rel, 1e-2, 1e-5, "r_prim_rel")
    _close(tr.r_dual, jr.r_dual, 1e-2, 1e-4, "r_dual")
    np.testing.assert_array_equal(tr.infeas_cert.numpy(),
                                  np.asarray(jr.infeas_cert))


def test_dual_bound_and_node_cert_match_reference(prob):
    """Same iterate in → same certified bound and presolve data out."""
    js, ts, bidx = prob["js"], prob["ts"], prob["bidx"]
    jd = tuple(map(jnp.asarray, prob["data"]))
    td = tuple(map(torch.as_tensor, prob["data"]))
    jr = jadmm.admm_solve(js, *jd, iters=150)
    tr = tadmm.AdmmResult(**{k: torch.as_tensor(np.array(getattr(jr, k)))
                             for k in ("x", "obj", "r_prim", "r_prim_rel",
                                       "r_dual", "infeas_cert", "y", "z")})
    jb = jadmm.admm_dual_bound(js, *jd, jr)
    tb = tadmm.admm_dual_bound(ts, *td, tr)
    # the port sums the tangent terms in fp64, the reference in fp32
    scale = np.maximum(1.0, np.abs(np.asarray(jb)))
    assert np.all(np.abs(tb.numpy() - np.asarray(jb)) <= 1e-4 * scale)
    jc = jadmm.admm_node_cert(js, *jd, jr, tuple(bidx))
    tc = tadmm.admm_node_cert(ts, *td, tr, tuple(bidx))
    _close(tc[0], jc[0], 1e-4, 1e-4, "bound")
    # flip deltas and retained sides come from the α candidate with the
    # largest bound; where two candidates tie to fp32 rounding, fp64 and
    # fp32 sums may pick different ones (both valid certificates). Allow
    # that for at most one node of the 32 and hold the rest to 1e-4.
    fd_t, fd_j = tc[1].numpy(), np.asarray(jc[1])
    rs_t, rs_j = tc[2].numpy(), np.asarray(jc[2])
    differ = (np.any(np.abs(fd_t - fd_j) > 1e-4 * (1 + np.abs(fd_j)), axis=1)
              | np.any(rs_t != rs_j, axis=1))
    assert differ.sum() <= 1, np.nonzero(differ)
    np.testing.assert_allclose(fd_t[~differ], fd_j[~differ], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(rs_t[~differ], rs_j[~differ])
    _close(tc[3], jc[3], 1e-5, 1e-5, "imp_lo")
    _close(tc[4], jc[4], 1e-5, 1e-5, "imp_hi")


def test_implied_box_matches_reference(prob):
    js, ts = prob["js"], prob["ts"]
    f, h, lb, ub = prob["data"]
    m = js.m_ineq
    uG = h * np.asarray(js.E)[:m]
    lbh = np.clip(lb / np.asarray(js.D), -1e30, 1e30)
    ubh = np.clip(ub / np.asarray(js.D), -1e30, 1e30)
    jl, ju = jadmm._implied_box(js.A[:m], jnp.asarray(uG), jnp.asarray(lbh),
                                jnp.asarray(ubh), passes=2)
    tl, tu = tadmm._implied_box(ts.A[:m], torch.as_tensor(uG),
                                torch.as_tensor(lbh), torch.as_tensor(ubh),
                                passes=2)
    # fp32 interval arithmetic with the same safety slack on both sides
    _close(tl, jl, 1e-5, 1e-5, "lbh")
    _close(tu, ju, 1e-5, 1e-5, "ubh")


def test_infeasibility_certificate_matches_reference(rng):
    """Instance 0 has x0 ≤ 1 ∧ x0 ≥ 2: the certificate must fire on it
    only, in both packages, cold and warm."""
    n, B = 8, 16
    G = np.vstack([np.eye(n)[:1], -np.eye(n)[:1]])
    js = jadmm.prepare_admm(G, np.eye(n))
    ts = convert.box_qp(js, "cpu")
    q = rng.normal(size=(B, n)).astype(np.float32)
    h = np.tile(np.float32([1.0, 2.0]), (B, 1))
    h[0] = [1.0, -2.0]
    lb = np.full((B, n), -10.0, np.float32)
    data = (q, h, lb, -lb)
    jr, tr = _both(lambda *a: jadmm.admm_solve(js, *a, iters=400),
                   lambda *a: tadmm.admm_solve(ts, *a, iters=400), data)
    cert = tr.infeas_cert.numpy()
    assert cert[0] and not cert[1:].any()
    np.testing.assert_array_equal(cert, np.asarray(jr.infeas_cert))
    tw = tadmm.admm_solve(ts, *map(torch.as_tensor, data), iters=200,
                          warm=(tr.x, tr.z, tr.y))
    np.testing.assert_array_equal(tw.infeas_cert.numpy(), cert)
