"""The port's stagewise O(N) frame (ops/stagewise.py) and the plan and
dispatch of its sweep kernel K4 (ops/cuda_stagewise.py), against the
reference's ops/stagewise.py, on the CPU.

Inputs are drawn from numpy seeds and go to both packages. The host build
is held array by array (the same fp64 numpy code, rounded once to fp32:
equal to 1e-6). The device half runs on the reference's prep carried across
(``convert.stagewise_qp``), so a difference is arithmetic: ``_apply_A``,
``_apply_AT`` and ``_apply_P`` within 1e-5 (relative, floor 1);
``stagewise_admm_solve`` at fixed iterations as tests/test_torch_admm.py
holds ``admm_solve`` (objective 1e-4 relative, x, z and y 1e-3, residuals
1e-2 relative with a 1e-4 floor, identical certificate bits); the dual
bound 1e-4 relative (the port sums it in fp64, the reference in fp32)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu.ops.condense import MpcWeights as JWeights
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights as TWeights

torch.set_num_threads(2)

N = 8
X0 = np.array([2.0, -0.5], np.float32)


def _omega_models():
    """The double integrator with a velocity disturbance (bench config 6's
    model), in both packages."""
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    jm = JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)
    return jm, convert.mld_model(jm)


JM, TM = _omega_models()
NC = JM.info.ncons
NV = JM.info.nv


def _weights(**extra):
    base = dataclasses.asdict(jdi.default_weights())
    base.update(extra)
    return JWeights(**base), TWeights(**base)


def _budget(cap):
    A_v = np.zeros((1, N * NV))
    A_v[0, 0::NV] = 1.0
    return (A_v, np.array([cap]), None, np.full((1, N), 0.1))


# prepare_stagewise options per feature (the reference's test_stagewise.py
# features: Δu/Qy costs, soft rows, move blocking, terminal set,
# horizon-coupled rows, consensus selector rows)
FEATURES = {
    "plain": {},
    "rdu_qy": dict(weights=dict(Rdu=0.7, Qy=np.diag([0.3, 0.1]),
                                qy=np.array([0.2, -0.1]))),
    "soft": dict(soft=(np.array([2, 3 * NC + 1, 5 * NC]), 40.0, 3.0)),
    "blocking": dict(blocking=[0, 0, 1, 1, 1, 2, 3, 3], block_deltas=True),
    "terminal": dict(terminal=(np.array([[1.0, 0.0], [0.0, -1.0]]),
                               np.array([0.3, 0.4]))),
    "extra": dict(extra=_budget(-1.5)),
    "consensus": dict(consensus=2),
}


def _preps(feature, rho=1.0):
    kw = dict(FEATURES[feature])
    jw, tw = _weights(**kw.pop("weights", {}))
    js = jsw.prepare_stagewise(JM, N, jw, rho=rho, **kw)
    ts = tsw.prepare_stagewise(TM, N, tw, rho=rho, device="cpu", **kw)
    return js, ts


def _data(js, ts, seed=0):
    """(q, l, u) and the extra rows' bounds of both packages for one
    seeded state, disturbance and price sequence."""
    rng = np.random.default_rng(seed)
    W = rng.normal(0.0, 0.3, size=(N, 1)).astype(np.float32)
    price = rng.normal(0.0, 0.2, size=(N, NV)).astype(np.float32)
    up = np.array([0.4], np.float32)
    jd = jsw.assemble_stagewise(js, jnp.asarray(X0), jnp.asarray(W),
                                jnp.asarray(price), jnp.asarray(up))
    td = tsw.assemble_stagewise(ts, torch.as_tensor(X0), torch.as_tensor(W),
                                torch.as_tensor(price), torch.as_tensor(up))
    je = te = None
    if js.n_ext:
        je = jsw.assemble_stagewise_ext(js, jnp.asarray(X0), jnp.asarray(W))
        te = tsw.assemble_stagewise_ext(ts, torch.as_tensor(X0),
                                        torch.as_tensor(W))
    return jd, td, je, te


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))
    assert err <= tol, f"error {err:.3e} above {tol:.1e}"


@pytest.mark.parametrize("feature", list(FEATURES))
def test_host_build_matches_reference(feature):
    """Every array of the port's own fp64 host build (stage blocks, block LU,
    soft/blocking/terminal/consensus rows, Woodbury factors) equals the
    reference's, and so do the static fields; so does the assembly."""
    js, ts = _preps(feature)
    for f in dataclasses.fields(tsw.StagewiseQP):
        if f.name == "cache":
            continue
        a, b = getattr(js, f.name), getattr(ts, f.name)
        if b is None or not isinstance(b, torch.Tensor):
            assert (a is None) if b is None else (tuple(a) == b
                                                  if isinstance(b, tuple)
                                                  else a == b), f.name
            continue
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6, err_msg=f.name)
    jd, td, je, te = _data(js, ts)
    for a, b in zip(jd, td):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-6)
    if je is not None:
        np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-6)


@pytest.mark.parametrize("feature", ["plain", "blocking", "terminal",
                                     "consensus", "rdu_qy"])
def test_operators_match_reference(feature, rng):
    """A, Aᵀ and P on the same random vectors; ⟨Aξ, w⟩ = ⟨ξ, Aᵀw⟩."""
    js, _ = _preps(feature)
    ts = convert.stagewise_qp(js, "cpu")
    xi = rng.normal(size=(3, N, ts.b)).astype(np.float32)
    w = rng.normal(size=(3, N, ts.m_k)).astype(np.float32)
    txi, tw = torch.as_tensor(xi), torch.as_tensor(w)
    _close(tsw._apply_A(ts, txi).numpy(),
           jsw._apply_A(js, jnp.asarray(xi)), 1e-5)
    _close(tsw._apply_AT(ts, tw).numpy(),
           jsw._apply_AT(js, jnp.asarray(w)), 1e-5)
    _close(tsw._apply_P(ts, txi).numpy(),
           jsw._apply_P(js, jnp.asarray(xi)), 1e-5)
    lhs = (tsw._apply_A(ts, txi).double() * tw.double()).sum()
    rhs = (txi.double() * tsw._apply_AT(ts, tw).double()).sum()
    np.testing.assert_allclose(float(lhs), float(rhs), rtol=1e-5)


def _K_apply(sw, v):
    """K v = (P + σI + Aᵀdiag(ρ)A) v through the structured operators."""
    return (tsw._apply_P(sw, v) + sw.sigma * v
            + tsw._apply_AT(sw, sw.rho_rows * tsw._apply_A(sw, v)))


@pytest.mark.parametrize("feature", ["plain", "rdu_qy", "blocking"])
def test_solve_K_inverts_K(feature, rng):
    """K (K⁻¹ r) = r with K applied densely through the operators (in
    fp64, on the fp32 factors); the plain sweeps equal the reference's."""
    js, _ = _preps(feature)
    ts = convert.stagewise_qp(js, "cpu")
    r = rng.normal(size=(4, N, ts.b))
    x = tsw._solve_K(ts, torch.as_tensor(r, dtype=torch.float32))
    sw64 = tsw.stagewise_double(ts)
    back = _K_apply(sw64, x.double()).numpy()
    np.testing.assert_allclose(back, r, rtol=2e-3, atol=2e-3)
    _close(x.numpy(), jsw._solve_K(js, jnp.asarray(r, jnp.float32)), 1e-5)


def test_solve_K_assoc_matches_sequential(rng):
    """The log-depth sweeps (``parallel_sweeps=True``) solve the same
    system on the same factors, at every horizon length's doubling
    pattern (N=1, 5, 8, 13)."""
    for n in (1, 5, 8, 13):
        ts = tsw.prepare_stagewise(TM, n, tdi.default_weights(), device="cpu")
        r = torch.as_tensor(rng.normal(size=(3, 2, n, ts.b)),
                            dtype=torch.float32)
        _close(tsw._solve_K_assoc(ts, r).numpy(),
               tsw._solve_K(ts, r).numpy(), 1e-5)


def test_block_lu_device_matches_host(rng):
    """The device-side block LU of K reproduces the host fp64 factors (in
    fp64 on the CPU: 1e-9; in fp32: 1e-4)."""
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), device="cpu")
    # rebuild K's blocks from the operators: K e_j for each unit vector
    b = ts.b
    sw64 = tsw.stagewise_double(ts)
    E = torch.eye(N * b, dtype=torch.float64).reshape(N * b, N, b)
    K = _K_apply(sw64, E).reshape(N * b, N * b).T      # dense K
    Kb = K.reshape(N, b, N, b)
    K_diag = torch.stack([Kb[k, :, k] for k in range(N)])
    K_off = torch.stack([torch.zeros(b, b, dtype=torch.float64)]
                        + [Kb[k, :, k - 1] for k in range(1, N)])
    L, Uinv, C = tsw.block_lu_device(K_diag, K_off)
    Lh, Uh, Ch = tsw.block_lu(K_diag.numpy(), K_off.numpy())
    for got, want in ((L, Lh), (Uinv, Uh), (C, Ch)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9, atol=1e-9)
    L32, U32, C32 = tsw.block_lu_device(K_diag.float(), K_off.float())
    for got, want in ((L32, Lh), (U32, Uh), (C32, Ch)):
        _close(got.numpy(), want, 1e-4)


def _jres_to_torch(jr):
    return tsw.AdmmResult(**{
        f.name: (None if getattr(jr, f.name) is None
                 else torch.as_tensor(np.array(getattr(jr, f.name))))
        for f in dataclasses.fields(tsw.AdmmResult)})


def _hold(tr, jr):
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    for k in ("x", "z", "y"):
        _close(getattr(tr, k).numpy(), getattr(jr, k), 1e-3)
    for k in ("r_prim", "r_prim_rel", "r_dual"):
        _close(getattr(tr, k).numpy(), getattr(jr, k), 1e-2, floor=1e-4)
    np.testing.assert_array_equal(tr.infeas_cert.numpy(),
                                  np.asarray(jr.infeas_cert))
    if jr.y_ext is not None:
        _close(tr.y_ext.numpy(), jr.y_ext, 1e-3)
        _close(tr.z_ext.numpy(), jr.z_ext, 1e-3)


@pytest.mark.parametrize("feature", list(FEATURES))
def test_admm_matches_reference(feature):
    """``stagewise_admm_solve`` cold (150 iterations), then warm from the
    reference's iterate (60 more), on each feature's frame."""
    js, _ = _preps(feature)
    ts = convert.stagewise_qp(js, "cpu")
    jd, td, je, te = _data(js, ts, seed=1)
    jr = jsw.stagewise_admm_solve(js, *jd, iters=150, ext_u=je)
    tr = tsw.stagewise_admm_solve(ts, *td, iters=150, ext_u=te)
    _hold(tr, jr)
    jw = jsw.stagewise_admm_solve(js, *jd, iters=60, ext_u=je,
                                  warm=(jr.x, jr.z, jr.y),
                                  warm_ext=((jr.z_ext, jr.y_ext)
                                            if js.n_ext else None))
    w = _jres_to_torch(jr)
    tw = tsw.stagewise_admm_solve(ts, *td, iters=60, ext_u=te,
                                  warm=(w.x, w.z, w.y),
                                  warm_ext=((w.z_ext, w.y_ext)
                                            if ts.n_ext else None))
    _hold(tw, jw)


def test_admm_node_boxes_and_batch_match_reference(rng):
    """A batch of B&B node boxes (binaries fixed at random, one node
    infeasible: its certificate bit must agree) through both packages."""
    js, _ = _preps("terminal")
    ts = convert.stagewise_qp(js, "cpu")
    jd, td, _, _ = _data(js, ts, seed=2)
    B = 5
    lb = np.broadcast_to(np.asarray(js.lb_xi), (B, N, ts.b)).copy()
    ub = np.broadcast_to(np.asarray(js.ub_xi), (B, N, ts.b)).copy()
    for i in range(B):
        fix = rng.random((N, NV)) < 0.5
        val = rng.integers(0, 2, size=(N, NV)).astype(np.float32)
        for j in js.binary_idx_v:
            lb[i, fix[:, j], j] = val[fix[:, j], j]
            ub[i, fix[:, j], j] = val[fix[:, j], j]
    lb[B - 1, :, NV] = 50.0          # x_{k+1}[0] ≥ 50: beyond the state box
    # the reference sets the node boxes into l/u: give it the batch
    jd = [jnp.broadcast_to(a, (B,) + a.shape) for a in jd]
    jr = jsw.stagewise_admm_solve(js, *jd, iters=300, lb_xi=jnp.asarray(lb),
                                  ub_xi=jnp.asarray(ub))
    tr = tsw.stagewise_admm_solve(ts, *td, iters=300,
                                  lb_xi=torch.as_tensor(lb),
                                  ub_xi=torch.as_tensor(ub))
    # the feasible nodes field by field; the infeasible one diverges, so
    # only its certificate bit is held (both packages certify it)
    feas = slice(0, B - 1)
    _hold(dataclasses.replace(tr, **{
        k: getattr(tr, k)[feas] for k in ("x", "z", "y", "obj", "r_prim",
                                          "r_prim_rel", "r_dual",
                                          "infeas_cert")}),
          jsw.AdmmResult(**{k: (None if getattr(jr, k) is None
                                else getattr(jr, k)[feas])
                            for k in ("x", "z", "y", "obj", "r_prim",
                                      "r_prim_rel", "r_dual", "infeas_cert",
                                      "z_ext", "y_ext")}))
    np.testing.assert_array_equal(tr.infeas_cert.numpy(),
                                  np.asarray(jr.infeas_cert))
    assert bool(tr.infeas_cert[B - 1])


@pytest.mark.parametrize("feature", ["plain", "soft", "blocking", "terminal",
                                     "extra", "consensus"])
def test_dual_bound_matches_reference(feature):
    """Same iterate in → the same certified bound (the port sums in fp64)."""
    js, _ = _preps(feature)
    ts = convert.stagewise_qp(js, "cpu")
    jd, td, je, te = _data(js, ts, seed=3)
    jr = jsw.stagewise_admm_solve(js, *jd, iters=120, ext_u=je)
    jb = jsw.stagewise_dual_bound(js, *jd, jr, ext_u=je)
    tb = tsw.stagewise_dual_bound(ts, *td, _jres_to_torch(jr), ext_u=te)
    _close(tb.numpy(), jb, 1e-4)


def test_parallel_sweeps_solve_matches_sequential():
    """``parallel_sweeps=True`` runs the same ADMM to the same point."""
    _, ts = _preps("extra")
    _, td, _, te = _data(_preps("extra")[0], ts, seed=4)
    a = tsw.stagewise_admm_solve(ts, *td, iters=200, ext_u=te)
    b = tsw.stagewise_admm_solve(ts, *td, iters=200, ext_u=te,
                                 parallel_sweeps=True)
    _close(b.obj.numpy(), a.obj.numpy(), 1e-4)
    _close(b.x.numpy(), a.x.numpy(), 1e-3)


def test_prepare_refuses_binary_states():
    """Binary states have no place in the stagewise frame (branching runs
    over per-step v binaries only), as the reference refuses them."""
    from pyhybridcontrol_tpu_torch.mld.info import MldInfo
    from pyhybridcontrol_tpu_torch.mld.model import MldModel

    info = MldInfo(nx=1, nu=1, x_types=("b",))
    model = MldModel.from_matrices(info, A=np.eye(1), B1=np.eye(1))
    with pytest.raises(ValueError, match="binary states"):
        tsw.prepare_stagewise(model, 4, device="cpu")


def test_extra_rows_refuse_a_missing_forecast():
    """Disturbance-dependent extra rows without W raise, in both packages;
    a missing ext_u with extra rows raises too."""
    js, ts = _preps("extra")
    x0 = torch.as_tensor(X0)
    with pytest.raises(ValueError, match="no omega"):
        tsw.assemble_stagewise_ext(ts, x0)
    with pytest.raises(ValueError, match="no omega"):
        jsw.assemble_stagewise_ext(js, jnp.asarray(X0))
    q, l, u = tsw.assemble_stagewise(ts, x0, torch.zeros(N, 1))
    with pytest.raises(ValueError, match="ext_u"):
        tsw.stagewise_admm_solve(ts, q, l, u, iters=2)


# ---- K4: plan and dispatch (the kernel itself runs only on the card) ----


@pytest.mark.parametrize("P,N_,b,bmax,staged,warps", [
    (64, 120, 5, 8, True, 4),      # bench config 6's long arm
    (1, 40, 5, 8, True, 4),
    (64, 20, 13, 16, True, 4),     # the PWA hull model (config 2)
    (8, 10, 40, 64, True, 4),
    (8, 200, 30, 32, False, 4),    # factors above the block's shared memory
    (8, 2000, 13, 16, False, 2),   # r/y buffers of four warps do not fit
])
def test_sweep_plan_at_the_main_shapes(P, N_, b, bmax, staged, warps):
    pl = cs.plan_sweep(P, N_, b)
    assert (pl.bmax, pl.staged, pl.warps) == (bmax, staged, warps)
    assert pl.smem == cs.sweep_smem_bytes(N_, b, warps, staged)
    assert pl.smem <= ca.SMEM_MAX
    # the plan depends on the shapes alone, not on P
    assert cs.plan_sweep(1, N_, b) == cs.plan_sweep(P + 7, N_, b)


def test_sweep_plan_refuses_what_has_no_instantiation():
    with pytest.raises(ValueError, match="above the 128"):
        cs.plan_sweep(4, 10, 129)
    with pytest.raises(ValueError, match="empty"):
        cs.plan_sweep(0, 10, 5)
    with pytest.raises(ValueError, match="shared memory"):
        cs.plan_sweep(4, 20000, 13)
    with pytest.raises(ValueError, match="shared memory"):
        cs.plan_sweep(4, 500, 13, staged=True)


def test_sweep_smem_mirrors_the_kernel_source():
    """``sweep_smem_bytes`` and ``phc_sw_smem_bytes`` pad each array to a
    multiple of 4 words; the binding passes bmax, one of SWEEP_BMAX."""
    import os

    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "pyhybridcontrol_tpu_torch", "csrc",
                            "stagewise.cu")).read()
    assert "(staged ? 3 * pad4((size_t)N * b * b) : 0)" in src
    assert "(size_t)warps * pad4((size_t)N * b)" in src
    for m in cs.SWEEP_BMAX:
        assert f"case {m}: return launch_b<{m}>" in src
    assert cs.sweep_smem_bytes(120, 5, 4, True) == 4 * (3 * 3000 + 4 * 600)
    assert cs.sweep_smem_bytes(3, 3, 1, True) == 4 * (3 * 28 + 12)


def test_sweep_dispatch_follows_the_device(monkeypatch, rng):
    """The x-update's sweep on a CPU tensor runs the plain sweeps and never
    the loader, and counts no launch; the kernel wrapper refuses a CPU
    tensor; a device with no kernel raises."""
    from pyhybridcontrol_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library",
                        lambda *a: pytest.fail("CPU path reached the loader"))
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), device="cpu")
    r = torch.as_tensor(rng.normal(size=(3, N, ts.b)), dtype=torch.float32)
    before = dict(ca.LAUNCHES)
    assert torch.equal(tsw._solve_K_bordered(ts, r), tsw._solve_K(ts, r))
    assert ca.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.sw_solve_k_cuda(r, ts.factors)
    with pytest.raises(ValueError, match="no stagewise sweep"):
        tsw._solve_K_bordered(ts, r.to("meta"))


@pytest.mark.cuda
def test_k4_matches_its_plain_version_on_the_card(rng):
    """On the card K4 launches (one count) and agrees with the plain sweeps
    within 1e-5 relative (both fp32), staged and through L2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ts = tsw.prepare_stagewise(TM, 40, tdi.default_weights(), device="cuda")
    r = torch.as_tensor(rng.normal(size=(33, 40, ts.b)), dtype=torch.float32,
                        device="cuda")
    ref = tsw._solve_K(ts, r)
    for staged in (True, False):
        ca.reset_launch_counts()
        x = cs.sw_solve_k_cuda(r, ts.factors, staged=staged)
        assert ca.LAUNCHES["stagewise_k4"] == 1
        _close(x.cpu().numpy(), ref.cpu().numpy(), 1e-5)
