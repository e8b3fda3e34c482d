"""The port's stagewise O(N) frame (ops/stagewise.py) and the plans and
dispatch of its kernels K4 (the sweep) and K5 (the ADMM loop)
(ops/cuda_stagewise.py), against the reference's ops/stagewise.py, on the
CPU.

Inputs are drawn from numpy seeds and go to both packages. The host build
is held array by array (the same fp64 numpy code, rounded once to fp32:
equal to 1e-6). The device half runs on the reference's prep carried across
(``convert.stagewise_qp``), so a difference is arithmetic: ``_apply_A``,
``_apply_AT`` and ``_apply_P`` within 1e-5 (relative, floor 1);
``stagewise_admm_solve`` at fixed iterations as tests/test_torch_admm.py
holds ``admm_solve`` (objective 1e-4 relative, x, z and y 1e-3, residuals
1e-2 relative with a 1e-4 floor, identical certificate bits); the dual
bound 1e-4 relative (the port sums it in fp64, the reference in fp32).
K5's constant packing is held by one iteration rebuilt from the packed
buffers, indexed as the kernel indexes them, against the plain iteration
(both in fp64 on the same fp32 values: 1e-6, relative with floor 1)."""

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
    # factors above the block's shared memory: above bmax 16 one warp a
    # block, its factor ring 8 blocks deep
    (8, 200, 30, 32, False, 1),
    (8, 2000, 13, 16, False, 2),   # r/y buffers of four warps do not fit
])
def test_sweep_plan_at_the_main_shapes(P, N_, b, bmax, staged, warps):
    pl = cs.plan_sweep(P, N_, b)
    assert (pl.bmax, pl.staged, pl.warps) == (bmax, staged, warps)
    assert pl.ring == (8 if bmax > 16 and not staged else 0)
    assert pl.smem == cs.sweep_smem_bytes(N_, b, warps, staged, bmax,
                                          pl.ring)
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
    assert "((staged ? 3 * factor_words(N, b, bmax) : 0) +" in src
    assert "(size_t)warps * (pad4((size_t)N * b) + ring_words(ring, b)));" \
        in src
    assert "return bmax <= 16 ? pad4((size_t)N * b * b) : (size_t)N * " \
        "wide_block(b);" in src
    for m in cs.SWEEP_BMAX:
        assert f"case {m}: return launch_b<{m}>" in src
    assert cs.sweep_smem_bytes(120, 5, 4, True) == 4 * (3 * 3000 + 4 * 600)
    assert cs.sweep_smem_bytes(3, 3, 1, True) == 4 * (3 * 28 + 12)


def test_sweep_dispatch_follows_the_device(monkeypatch, rng):
    """The solve's sweeps on a CPU tensor are the plain ones, inside the
    plain loop: it never reaches the loader and counts no launch, and the
    x-update with the plain sweep is the plain sweep; K4's wrapper refuses
    a CPU tensor; a device with no kernel raises."""
    from pyhybridcontrol_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library",
                        lambda *a: pytest.fail("CPU path reached the loader"))
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), device="cpu")
    r = torch.as_tensor(rng.normal(size=(3, N, ts.b)), dtype=torch.float32)
    before = dict(ca.LAUNCHES)
    assert torch.equal(tsw._solve_K_bordered(ts, r, tsw._solve_K),
                       tsw._solve_K(ts, r))
    q, l, u = tsw.assemble_stagewise(ts, torch.as_tensor(X0))
    tsw.stagewise_admm_solve(ts, q, l, u, iters=3)
    assert ca.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.sw_solve_k_cuda(r, ts.factors)
    with pytest.raises(ValueError, match="no stagewise ADMM"):
        tsw.stagewise_admm_solve(ts, q.to("meta"), l.to("meta"),
                                 u.to("meta"), iters=3)


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


# ---- K5: plan, dispatch and constant packing (the kernel runs only on
# the card) ----


# (P, N, b, m, S, n_blk, n_ext, n_cons, mean) -> (bmax, staged, warps,
# lanes a stage, cluster) at the four driven shapes: config 6's long arm (a wave of 8
# nodes × S=8, the budget row) and parity arm (32 × S=2), serve --solver
# stagewise (config 1, a wave of 32) and the transforms hold (soft rows,
# blocking, terminal set, budget row; a wave of 16)
DRIVEN = {
    "config6_long": ((64, 120, 5, 19, 8, 0, 1, 2, True),
                     (8, True, 15, 4, 8)),
    "config6_parity": ((64, 4, 5, 19, 2, 0, 0, 2, True), (8, True, 4, 32, 2)),
    "serve_stagewise": ((32, 10, 5, 17, 1, 0, 0, 0, False),
                        (8, True, 10, 32, 1)),
    "transforms": ((16, 8, 5, 19, 1, 1, 1, 0, False), (8, True, 8, 32, 1)),
}


def _chip_smoke():
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.parametrize("path", list(DRIVEN))
def test_admm_plan_at_the_driven_shapes(path):
    shape, want = DRIVEN[path]
    P, N_, b, m, S, n_blk, n_ext, n_cons, mean = shape
    pl = cs.plan_admm(*shape)
    assert (pl.bmax, pl.staged, pl.warps, pl.tps, pl.cluster) == want
    assert pl.smem == cs.admm_smem_bytes(N_, b, m, S, n_blk, n_ext, n_cons,
                                         mean, pl.warps, pl.staged, pl.bmax)
    assert pl.smem <= ca.SMEM_MAX
    assert 32 * pl.warps <= cs.ADMM_THREADS[pl.bmax]
    assert pl.cluster <= cs.ADMM_CLUSTER
    # every stage's lanes in one round of the CTA's threads
    assert 32 * pl.warps >= N_ * pl.tps and 32 % pl.tps == 0
    # the plan depends on the shapes alone, not on how many groups
    assert cs.plan_admm(S, *shape[1:]) == pl


def test_admm_plan_shapes_are_the_preps():
    """The driven shapes' rows and extra rows are what the preps have:
    config 6's frame (19 rows a stage, 2 consensus rows, 1 budget row), the
    served double integrator's (17) and the transforms hold's (19, one
    blocking row)."""
    smoke = _chip_smoke()
    cpu = torch.device("cpu")
    sw = smoke.config6_preps(cpu, smoke.config6_trees()[0])[0].sw
    assert (sw.N, sw.b, sw.m_k, sw.n_cons, sw.n_ext) == (4, 5, 19, 2, 0)
    plain = tsw.prepare_stagewise(TM, 10, tdi.default_weights(), device="cpu")
    assert (plain.b, plain.m_k, plain.n_blk) == (5, 17, 0)
    c = smoke.sw_transforms_controller("cpu")
    assert (c._sw.N, c._sw.m_k, c._sw.n_blk, c._sw.n_ext) == (8, 19, 1, 1)


# the wider blocks phase 22 of chip_smoke.py holds K5 at, off the driven
# paths: the PWA hull model as ``serve --config pwa_actuator --solver
# stagewise`` builds it (b=13: bmax 16, a wave of 64) and the double
# integrator with a second force (b=6: bmax 8 without b=5's instantiation,
# a wave of 16); (N, b, m, P) and the plan's (bmax, warps, tps)
WIDER = {"hull": ((20, 13, 49, 64), (16, 5, 8)),
         "di_two_forces": ((10, 6, 20, 16), (8, 10, 32))}


@pytest.mark.parametrize("key", list(WIDER))
def test_admm_plan_at_the_wider_blocks(key):
    """The preps phase 22 builds have the shapes above; the plan stages
    their factors, and forcing the unstaged variant (as phase 22 does)
    keeps the threads and drops the factors' shared memory."""
    from pyhybridcontrol_tpu_torch import serve

    smoke = _chip_smoke()
    (N_, b, m, P), want = WIDER[key]
    if key == "hull":
        sw = serve.make_controller("pwa_actuator", "stagewise", "cpu")._sw
    else:
        sw = tsw.prepare_stagewise(smoke.di_two_forces(), 10,
                                   tdi.default_weights(), device="cpu")
    assert (sw.N, sw.b, sw.m_k, sw.n_blk, sw.n_ext) == (N_, b, m, 0, 0)
    assert key in smoke.K5_UNSTAGED
    pl = cs.plan_admm(P, N_, b, m)
    assert (pl.bmax, pl.warps, pl.tps) == want and pl.staged
    st = cs.plan_admm(P, N_, b, m, staged=False)
    assert (st.bmax, st.warps, st.tps, st.staged) == want + (False,)
    assert pl.smem - st.smem == 4 * 3 * (-(-N_ * b * b // 4) * 4)


# (P, N, b, m, S, n_blk, n_ext, n_cons, mean), staged, and the plan the
# shared variant had before the FLEX variants came (bmax, staged, warps,
# lanes a stage, cluster, shared memory): every shape that planned then
# keeps its instantiation. The driven shapes and the wider blocks, forced
# unstaged where phase 22 forces it, and the largest horizons the shared
# variant holds (the double integrator at N=696, the hull model at N=240,
# config 6's tree at N=300)
KEPT = {
    "config6_long": ((64, 120, 5, 19, 8, 0, 1, 2, True), None,
                     (8, True, 15, 4, 8, 91744)),
    "config6_long_unstaged": ((64, 120, 5, 19, 8, 0, 1, 2, True), False,
                              (8, False, 15, 4, 8, 55744)),
    "config6_parity": ((64, 4, 5, 19, 2, 0, 0, 2, True), None,
                       (8, True, 4, 32, 2, 4048)),
    "serve_stagewise": ((32, 10, 5, 17, 1, 0, 0, 0, False), None,
                        (8, True, 10, 32, 1, 7664)),
    "transforms": ((16, 8, 5, 19, 1, 1, 1, 0, False), None,
                   (8, True, 8, 32, 1, 7072)),
    "hull_N20": ((64, 20, 13, 49, 1, 0, 0, 0, False), None,
                 (16, True, 5, 8, 1, 65728)),
    "hull_N20_unstaged": ((64, 20, 13, 49, 1, 0, 0, 0, False), False,
                          (16, False, 5, 8, 1, 25168)),
    "di_two_forces": ((16, 10, 6, 20, 1, 0, 0, 0, False), None,
                      (8, True, 10, 32, 1, 9696)),
    "soft_box": ((16, 10, 5, 17, 1, 0, 0, 0, False), None,
                 (8, True, 10, 32, 1, 7664)),
    "di_N696": ((64, 696, 5, 17, 1, 0, 0, 0, False), None,
                (8, False, 16, 1, 1, 232432)),
    "hull_N240": ((64, 240, 13, 49, 1, 0, 0, 0, False), None,
                  (16, False, 8, 1, 1, 232016)),
    "config6_tree_N300": ((64, 300, 5, 19, 8, 0, 1, 2, True), None,
                          (8, True, 10, 1, 8, 227024)),
}


@pytest.mark.parametrize("key", list(KEPT))
def test_admm_plan_keeps_every_shape_that_planned(key):
    shape, staged, want = KEPT[key]
    pl = cs.plan_admm(*shape, staged=staged)
    assert pl == cs.AdmmPlan(*want)
    assert (pl.spc, pl.variant) == (1, "shared")
    assert cs.ADMM_LAUNCH[pl.variant] == "stagewise_k5"


# (P, N, b, m, S, n_blk, n_ext, n_cons, mean) the shared variant refused:
# the double integrator (configs 1, 6) from its first refused horizon to
# N=20,000, the PWA hull model (config 2) likewise, and config 6's long
# arm with 9 to 64 scenarios (a wave of 8 nodes); and the variant, spc
# and cluster the plan picks (where it picked the global variant, one
# scenario with no extra rows, the horizon variant: one problem a cluster
# of C windows, tests/test_torch_stagewise_horizon.py; a group, ⌈S/8⌉
# scenarios a CTA in a portable cluster, in device memory at S=64 where 8
# slots do not fit a CTA's shared memory; above bmax 32, where no place
# holds ⌈S/8⌉ slots' factor rings, ⌈S/16⌉ in a cluster of 16)
REACHED = {
    "di_N704": ((64, 704, 5, 17, 1, 0, 0, 0, False), ("horizon", 1, 2)),
    "di_N1000": ((64, 1000, 5, 17, 1, 0, 0, 0, False), ("horizon", 1, 2)),
    "di_N4000": ((64, 4000, 5, 17, 1, 0, 0, 0, False),
                 ("global_all", 1, 1)),
    "di_N20000": ((64, 20000, 5, 17, 1, 0, 0, 0, False),
                  ("global_all", 1, 1)),
    "hull_N248": ((64, 248, 13, 49, 1, 0, 0, 0, False), ("horizon", 1, 2)),
    "hull_N300": ((64, 300, 13, 49, 1, 0, 0, 0, False), ("horizon", 1, 2)),
    "hull_N1000": ((64, 1000, 13, 49, 1, 0, 0, 0, False),
                   ("horizon", 1, 8)),
    "hull_N20000": ((64, 20000, 13, 49, 1, 0, 0, 0, False),
                    ("global_all", 1, 1)),
    "tree_S9": ((72, 120, 5, 19, 9, 0, 1, 2, True), ("grouped", 2, 5)),
    "tree_S16": ((128, 120, 5, 19, 16, 0, 1, 2, True), ("grouped", 2, 8)),
    "tree_S27": ((216, 120, 5, 19, 27, 0, 1, 2, True), ("grouped", 4, 7)),
    "tree_S64": ((512, 120, 5, 19, 64, 0, 1, 2, True), ("global", 8, 8)),
    "tree_S64_N2000": ((512, 2000, 5, 19, 64, 0, 1, 2, True),
                       ("global_all", 8, 8)),
    "tree_b64_S64": ((512, 120, 64, 258, 64, 0, 1, 2, True),
                     ("global_all", 4, 16)),
    "tree_b128_S16": ((128, 24, 128, 258, 16, 0, 1, 2, True),
                      ("global", 1, 16)),
}


@pytest.mark.parametrize("key", list(REACHED))
def test_admm_plan_reaches_every_horizon_and_group(key):
    """The plan of each shape the shared variant refused: a FLEX variant
    whose CTA fits, a portable cluster (at most 8 CTAs; up to 16, at
    ⌈S/16⌉ scenarios a CTA, only where no place fits ⌈S/8⌉) whose slots
    cover the group with no CTA left empty, whole warps a slot, every stage's
    lanes in one round of a slot's threads or one lane a stage, and the
    shared memory of ``flex_smem_bytes``. Where the plan takes the horizon
    variant, the global variant it replaced still plans, forced, as
    before, and the same checks hold of it."""
    shape, want = REACHED[key]
    P, N_, b, m, S, n_blk, n_ext, n_cons, mean = shape
    pl = cs.plan_admm(*shape)
    assert (pl.variant, pl.spc, pl.cluster) == want
    forced = None
    if pl.variant == "horizon":
        assert pl.smem == cs.horizon_smem_bytes(N_, b, m, pl.staged,
                                                pl.bmax, pl.cluster)
        forced = "global"
        pl = cs.plan_admm(*shape, variant=forced)
        assert (pl.variant, pl.spc, pl.cluster) == ("global", 1, 1)
    wide = -(-S // cs.ADMM_CLUSTER)
    if pl.spc == wide:
        assert pl.cluster <= cs.ADMM_CLUSTER
    else:
        assert pl.spc == -(-S // cs.ADMM_CLUSTER_MAX)
        assert pl.cluster <= cs.ADMM_CLUSTER_MAX
        with pytest.raises(ValueError, match="shared memory"):
            cs.plan_admm(*shape, spc=wide)
    assert pl.cluster * pl.spc >= S > (pl.cluster - 1) * pl.spc
    assert pl.warps % pl.spc == 0
    assert 32 * pl.warps <= cs.ADMM_THREADS[pl.bmax]
    slot = 32 * pl.warps // pl.spc
    assert slot >= min(N_ * pl.tps, slot) and 32 % pl.tps == 0
    assert (N_ * pl.tps <= slot) or pl.tps == 1
    assert pl.smem == cs.flex_smem_bytes(
        N_, b, m, n_blk, n_ext, n_cons, mean, pl.warps, pl.staged, pl.bmax,
        pl.spc, cs.ADMM_PLACES[pl.variant], pl.ext, pl.ring,
        S=S) <= ca.SMEM_MAX
    # the plan depends on the shapes alone, not on how many groups: one
    # wave wherever the card holds the launch's P/S portable clusters
    assert cs.plan_admm(S, *shape[1:], variant=forced) == pl
    # an earlier place of the same factors would not have fit
    for place in range(cs.ADMM_PLACES[pl.variant]):
        assert cs.flex_smem_bytes(N_, b, m, n_blk, n_ext, n_cons, mean,
                                  pl.warps, pl.staged, pl.bmax, pl.spc,
                                  place, pl.ext, pl.ring,
                                  S=S) > ca.SMEM_MAX


@pytest.mark.parametrize("S", [9, 16, 27, 64])
def test_k5_slots_cover_each_group_once(S):
    """The FLEX kernel's mapping, mirrored: CTA c of a group's cluster and
    warp w hold slot w mod spc and the slot's local warp w div spc; slot j
    of CTA c runs scenario c·spc + j, idle from S on. Every scenario of the
    group runs in exactly one slot, each slot on W whole warps, the slots'
    sweep warps (local warp 0) are warps 0 … spc−1 of the CTA, and only
    the last CTA has idle slots."""
    pl = cs.plan_admm(8 * S, 120, 5, 19, S, 0, 1, 2, True)
    spc, C, warps = pl.spc, pl.cluster, pl.warps
    seen = []
    for c in range(C):
        idle = 0
        for w in range(warps):
            j, local = w % spc, w // spc
            s = c * spc + j
            if local == 0:
                assert w == j       # one sweep warp a scheduler
            if s >= S:
                idle += 1
            elif local == 0:
                seen.append(s)
        assert idle == 0 or c == C - 1
    assert sorted(seen) == list(range(S))


def test_admm_long_horizon_matches_reference():
    """The plain loop at N=720 (a horizon the shared variant refuses, N·nv
    2,160), 30 iterations from cold, against the reference's
    ``stagewise_admm_solve`` on its prep carried across: objective within
    1e-4 relative; x within 1e-3 (the largest difference printed)."""
    js = jsw.prepare_stagewise(jdi.switched_double_integrator(), 720,
                               jdi.default_weights())
    ts = convert.stagewise_qp(js, "cpu")
    x0 = np.array([2.0, 0.0], np.float32)
    jd = jsw.assemble_stagewise(js, jnp.asarray(x0))
    td = tsw.assemble_stagewise(ts, torch.as_tensor(x0))
    jr = jsw.stagewise_admm_solve(js, *jd, iters=30)
    tr = tsw.stagewise_admm_solve(ts, *td, iters=30)
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    dx = float(np.abs(tr.x.numpy() - np.asarray(jr.x)).max())
    print(f"N=720: objective {float(tr.obj):.9f} (reference "
          f"{float(jr.obj):.9f}), max |Δx| {dx:.2e}")
    _close(tr.x.numpy(), jr.x, 1e-3)


# the shapes past the register path (b > 16, more than 4 extra rows): (P,
# N, b, m, S, n_blk, n_ext, n_cons, mean) and the plan's (bmax, variant,
# ext); the battery fleets of chip_smoke.py (5 at N=8, 8 at N=96, 16 at
# N=48, 32 at N=24), random blocks of b = 17, 33 and 100 at N=10, and
# config 6's long arm with 5, 20, 64 and 300 extra rows
PAST = {
    "b17": ((4, 10, 17, 30), (32, "shared", cs.EXT_RT)),
    "fleet5_b20": ((8, 8, 20, 77, 1, 0, 6), (32, "shared", cs.EXT_RT)),
    "fleet8_b32": ((8, 96, 32, 122, 1, 0, 20),
                   (32, "global", cs.EXT_RT | cs.EXT_AK)),
    "b33": ((4, 10, 33, 40), (64, "shared", cs.EXT_RT)),
    "fleet16_b64": ((8, 48, 64, 242, 1, 0, 22),
                    (64, "global", cs.EXT_RT | cs.EXT_AK)),
    "b100": ((4, 10, 100, 120), (128, "shared", cs.EXT_RT)),
    "fleet32_b128": ((8, 24, 128, 482, 1, 0, 35),
                     (128, "global", cs.EXT_RT | cs.EXT_AK | cs.EXT_CW
                      | cs.EXT_JM)),
    "cfg6_r5": ((64, 120, 5, 19, 8, 0, 5, 2, True), (8, "shared", cs.EXT_RT)),
    "cfg6_r20": ((64, 120, 5, 19, 8, 0, 20, 2, True),
                 (8, "shared", cs.EXT_RT)),
    "cfg6_r64": ((64, 120, 5, 19, 8, 0, 64, 2, True),
                 (8, "shared", cs.EXT_RT | cs.EXT_AK)),
    "cfg6_r300": ((64, 120, 5, 19, 8, 0, 300, 2, True),
                  (8, "shared", cs.EXT_RT | cs.EXT_AK | cs.EXT_CW)),
}


def test_admm_plan_refuses_what_has_no_instantiation():
    """Past the register path the plan takes every b up to 128 (bmax 32,
    64, 128) and any number of extra rows (the runtime-r path, its arrays
    in device memory where they do not fit), and raises on b = 129; the
    register path forced past it refuses; the other refusals."""
    for key, (shape, want) in PAST.items():
        pl = cs.plan_admm(*shape)
        assert (pl.bmax, pl.variant, pl.ext) == want, (key, pl)
        assert pl.library == ("stagewise_wide" if pl.bmax > 16
                              else "stagewise_extra")
    with pytest.raises(ValueError, match=r"P=4, N=10, b=129.*above the 128"):
        cs.plan_admm(4, 10, 129, 150)
    with pytest.raises(ValueError, match="register path"):
        cs.plan_admm(4, 10, 5, 17, n_ext=5, runtime_r=False)
    with pytest.raises(ValueError, match="register path"):
        cs.plan_admm(4, 10, 20, 30, runtime_r=False)
    # the shared variant takes a portable cluster and a scenario's state in
    # shared memory; forced past either, it refuses (the plan does not:
    # test_admm_plan_reaches_every_horizon_and_group)
    with pytest.raises(ValueError, match="S=16.*at most 8 scenarios"):
        cs.plan_admm(64, 10, 5, 19, S=16, n_cons=2, mean=True,
                     variant="shared")
    with pytest.raises(ValueError, match=r"N=2000.*shared variant.*shared "
                                         r"memory"):
        cs.plan_admm(8, 2000, 5, 19, S=8, n_cons=2, mean=True,
                     variant="shared")
    with pytest.raises(ValueError, match="no variant"):
        cs.plan_admm(8, 10, 5, 17, variant="resident")
    with pytest.raises(ValueError, match="group mean"):
        cs.plan_admm(16, 10, 5, 17, S=2)
    with pytest.raises(ValueError, match="multiple"):
        cs.plan_admm(9, 10, 5, 19, S=2, n_cons=2, mean=True)
    with pytest.raises(ValueError, match="empty"):
        cs.plan_admm(0, 10, 5, 17)
    # staged factors of 3·N·b² words past any CTA, whatever the state's place
    with pytest.raises(ValueError, match="shared memory"):
        cs.plan_admm(8, 20000, 5, 17, staged=True)
    with pytest.raises(ValueError, match="less than a warp"):
        cs.plan_admm(272, 10, 13, 49, S=272, n_cons=2, mean=True)


def test_admm_smem_mirrors_the_kernel_source():
    """``admm_smem_bytes`` mirrors ``admm_layout`` of csrc/stagewise.cu
    array by array (each padded to a multiple of 4 words, J and Mc in rows
    of bmax words to bmax 16, of b words above; the runtime-r path's
    arrays in device memory by ext's bits); the warp, cluster and
    register-path caps and the bounds each part of the source dispatches
    are the kernel's; ``_AdmmArgs`` is the C struct field by field."""
    import os

    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "pyhybridcontrol_tpu_torch", "csrc",
                            "stagewise.cu")).read()
    for line in (
            "const size_t f = staged ? pad4((size_t)N * b * b) : 0;",
            "const size_t zn = pad4((size_t)m * N), tn = pad4((size_t)N * b);",
            "return bmax <= 16 ? pad4((size_t)m * bmax)",
            ": (ext & kExtJM ? 0 : pad4((size_t)m * b));",
            "return !ext ? kRMax : (ext & kExtVec ? 0 : 4 * pad4(r));",
            "const bool ak = !(ext & kExtAK);              // Aext and KiU "
            "staged",
            "a.J = o; o += jm_words(m, b, bmax, ext);",
            "a.Mc = o; o += jm_words(m, b, bmax, ext);",
            "a.tie = o; o += pad4((size_t)N * n_blk);",
            "a.blk = o; o += pad4(n_blk);",
            "a.Aext = o; o += ak ? pad4((size_t)r * N * b) : 0;",
            "a.KiU = o; o += ak ? pad4((size_t)N * b * r) : 0;",
            "a.Cw = o; o += ext & kExtCw ? 0 : pad4((size_t)r * r);",
            "a.rho_e = o; o += ext & kExtVec ? 0 : pad4(r);",
            "a.gM = o; o += mean ? pad4((size_t)S * N) : 0;",
            "a.u = o; o += zn;",
            "a.w = o; o += bmax > 16 ? zn : 0;",
            "a.xb = o; o += tn;",
            "a.cb = o; o += mean ? 2 * pad4((size_t)N * n_cons) : 0;",
            "a.corr = o; o += vec_words(r, ext);",
            "a.red = o; o += ext ? 0 : (size_t)kRMax * warps;",
            "constexpr int kRMax = 4;",
            "constexpr int kExtRt = 1;",
            "constexpr int kExtAK = 2;",
            "constexpr int kExtCw = 4;",
            "constexpr int kExtVec = 8;",
            "constexpr int kExtJM = 16;",
            "return bmax <= 8 ? 512 : 256;",
            "a->S > 8",
            # the FLEX variants' layout (flex_layout)
            "const bool hz = place < 2;                    // horizon "
            "constants staged",
            "const bool hx = hz && !(ext & kExtAK);        // Aext and KiU "
            "staged",
            "a.tie = o; o += hz ? pad4((size_t)N * n_blk) : 0;",
            "a.Aext = o; o += hx ? pad4((size_t)r * N * b) : 0;",
            "a.KiU = o; o += hx ? pad4((size_t)N * b * r) : 0;",
            "a.w = zo; zo += bmax > 16 ? zn : 0;",
            "const size_t cn = mean ? 2 * pad4((size_t)N * n_cons) : 0;",
            "size_t& zo = place >= 1 ? g : sl;             // z, y, l, u",
            "size_t& to = place >= 2 ? g : sl;             // t, mb, x, cb",
            "a.corr = sl; sl += vec_words(r, ext);",
            "a.red = sl; sl += ext ? 0 : (size_t)kRMax * warps_slot;",
            "a.total = o + (size_t)spc * sl;",
            "constexpr int kMaxCluster = 16;",
            "fx.cluster * fx.spc >= a->S && (fx.cluster - 1) * fx.spc < a->S",
            "if (C > 8) {"):
        assert line in src, line
    # the register path at bmax 8 and 16 (this source alone), the runtime-r
    # path at every bmax (bmax 8 and 16 in stagewise_extra.cu, 32 to 128 in
    # stagewise_wide.cu): each part dispatches its bounds
    for m in cs.ADMM_BMAX:
        for rdyn in (("false", "true") if m <= 16 else ("true",)):
            assert f"case {m}: return launch_admm_b<{m}, {rdyn}>" in src
            assert f"case {m}: return launch_flex_b<{m}, {rdyn}>" in src
    csrc = os.path.join(os.path.dirname(__file__), "..",
                        "pyhybridcontrol_tpu_torch", "csrc")
    for part, name in ((1, "stagewise_wide.cu"), (2, "stagewise_extra.cu")):
        part_src = open(os.path.join(csrc, name)).read()
        assert f"#define PHC_SW_PART {part}" in part_src
        assert '#include "stagewise.cu"' in part_src
    assert (cs.EXT_RT, cs.EXT_AK, cs.EXT_CW, cs.EXT_VEC, cs.EXT_JM) == \
        (1, 2, 4, 8, 16)
    assert (cs.ADMM_RMAX, cs.ADMM_CLUSTER, cs.ADMM_CLUSTER_MAX) == (4, 8, 16)
    assert cs.ADMM_PLACES == {"grouped": 0, "global": 1, "global_all": 2}
    assert set(cs.ADMM_LAUNCH.values()) <= set(ca.LAUNCHES)
    # the slots: warp w of a CTA to slot w mod spc, the slot's rank within
    # it ((w div spc)·32 + lane), the scenario crank·spc + slot
    for line in ("const int j = FLEX ? (tc >> 5) % spc : 0;",
                 "const int tid = FLEX ? ((tc >> 5) / spc) * 32 + (tc & 31) "
                 ": tc;",
                 "const int s = FLEX ? crank * spc + j"):
        assert line in src, line
    # every export the wrapper calls is bound
    bind = open(os.path.join(os.path.dirname(__file__), "..",
                             "pyhybridcontrol_tpu_torch", "ops",
                             "_build.py")).read()
    for fn in ("phc_sw_admm_flex_smem_bytes", "phc_sw_admm_flex_scratch_words",
               "phc_sw_admm_flex", "phc_sw_admm_max_clusters"):
        assert f"\n{'long long' if 'scratch' in fn else 'int'} {fn}(" in src
        assert f"lib.{fn}.argtypes" in bind
    # the slot's words (config 6's tree at S=64, four scenarios a CTA, four
    # warps each): constants 3·3000 + 2·152 + 2·600 + 4 + 4, the member
    # lists' 1912, the 64 peers' buffer addresses 2·64, and a slot's
    # z/y/l/u 4·2280, t/mb/x 3·600, the consensus buffers 2·240, 4·(1 + 4)
    assert cs.flex_smem_bytes(120, 5, 19, 0, 1, 2, True, 16, True, 8, 4,
                              0, lists=1912, S=64) == \
        4 * (10512 + 1912 + 128 + 4 * (9120 + 1800 + 480 + 20))
    assert cs.flex_scratch_words(120, 5, 19, 2, True, 1) == 9120
    assert cs.flex_scratch_words(120, 5, 19, 2, True, 2) == 9120 + 1800 + 480
    assert cs.ADMM_THREADS == {8: 512, 16: 256, 32: 256, 64: 256, 128: 256}
    # config 6's long arm, word by word: factors 3·3000, J/Mc 2·152,
    # Aext/KiU 2·600, Cw 4, ρₑ 4, the group mean's row 960, z/y/l/u
    # 4·2280, t/mb/x 3·600, the consensus buffers 2·240, 4·(1+15)
    assert cs.admm_smem_bytes(120, 5, 19, 8, 0, 1, 2, True, 15, True, 8) == \
        4 * (9000 + 304 + 1200 + 4 + 4 + 960 + 9120 + 1800 + 480 + 64)
    # every _AdmmArgs field is one of the C struct's, in its order
    body = src[src.index("struct PhcSwAdmmArgs {"):]
    body = body[:body.index("};")]
    names = [f for f, _ in cs._AdmmArgs._fields_]
    assert names[:29] == [ln.strip().rstrip(";").split("*")[-1].strip()
                          for ln in body.splitlines()[1:30]]
    assert names[29:] == ["P", "N", "b", "m", "S", "n_blk", "blk0", "n_ext",
                          "n_cons", "mean", "iters", "sigma", "alpha",
                          "ext_ws", "ext", "ring", "Pi", "Psi", "windows"]
    assert "int P, N, b, m, S, n_blk, blk0, n_ext, n_cons, mean, iters;" in \
        body and "float sigma, alpha;" in body
    assert body.rstrip().endswith(
        "float* ext_ws;\n  int ext;\n  int ring;\n  const float* Pi;\n"
        "  const float* Psi;\n  int windows;")


def test_admm_dispatch_follows_the_device(monkeypatch):
    """A whole CPU solve with every row kind (soft, blocking, terminal,
    extra rows, the group mean) runs ``_admm_iterations`` once with the
    plain sweeps and never K5's wrapper or the loader; K5's wrapper
    refuses a CPU tensor; ``parallel_sweeps`` is the plain loop with the
    log-depth sweeps."""
    from pyhybridcontrol_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library",
                        lambda *a: pytest.fail("CPU path reached the loader"))
    monkeypatch.setattr(tsw, "sw_admm_cuda",
                        lambda *a, **k: pytest.fail("CPU path reached K5"))
    seen = []
    orig = tsw._admm_iterations

    def spy(*a, **kw):
        seen.append(kw["sweep"])
        return orig(*a, **kw)

    monkeypatch.setattr(tsw, "_admm_iterations", spy)
    ts, (q, l, u), ue, M = _k5_problem("all", 1.0, np.random.default_rng(2))
    before = dict(ca.LAUNCHES)
    tsw.stagewise_admm_solve(ts, q, l, u, iters=4, ext_u=ue, consensus_M=M)
    tsw.stagewise_admm_solve(ts, q, l, u, iters=4, ext_u=ue, consensus_M=M,
                             parallel_sweeps=True)
    assert seen == [tsw._solve_K, tsw._solve_K_assoc]
    assert ca.LAUNCHES == before
    x = torch.zeros(q.shape)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.sw_admm_cuda(ts, q, l, u, x, l, l, None, None, None, 3)


@pytest.mark.parametrize("x0", [(12.0, 0.0), (2.0, 0.0)])
def test_certificate_ratios_give_its_bits(x0):
    """``_certificate``'s ratios (what phase 22 of chip_smoke.py reads to
    tell a threshold's neighbourhood) decide its bits: ‖Aᵀδy‖∞ and the
    support sum at most 1e-4·‖δy‖∞, minus the gap sum at least that; and
    they are the solve's. From outside the double integrator's |x| ≤ 10
    box (every problem infeasible) the solve certifies, from inside it
    does not."""
    ts = tsw.prepare_stagewise(TM, 10, tdi.default_weights(), device="cpu")
    q, l, u = tsw.assemble_stagewise(ts, torch.tensor(x0))
    q, l, u = (t.expand((4,) + t.shape).clone() for t in (q, l, u))
    res = tsw.stagewise_admm_solve(ts, q, l, u, iters=300)
    z0 = torch.clamp(torch.zeros_like(l), l, u)
    out = tsw._admm_iterations(ts, q, l, u, torch.zeros_like(q), z0,
                               torch.zeros_like(l), None, None, None, 300)
    cert, r = tsw._certificate(ts, out[3], out[6], l, u, None)
    assert torch.equal(cert, res.infeas_cert)
    assert torch.equal(cert, (r[:, 0] <= 1e-4) & (r[:, 1] <= 1e-4)
                       & (r[:, 2] >= 1e-4))
    assert bool(cert.all()) == (x0[0] > 10.0) and (bool(cert.any())
                                                    == (x0[0] > 10.0))


# feature -> prepare_stagewise options of K5's packing holds; "all" has every
# row kind at once and the group mean over S=3 scenarios
K5_FEATURES = {
    "plain": {},
    "soft": dict(soft=FEATURES["soft"]["soft"]),
    "blocking": FEATURES["blocking"],
    "terminal": FEATURES["terminal"],
    "extra": dict(extra=_budget(0.5)),
    "consensus": dict(consensus=2),
    "all": dict(soft=FEATURES["soft"]["soft"], blocking=[0, 0, 1, 1, 2, 2,
                                                         3, 3],
                terminal=FEATURES["terminal"]["terminal"],
                extra=_budget(0.5), consensus=2),
}
K5_S = 3


def _k5_problem(feature, rho, rng):
    """A prep with ``feature``'s rows, a batch of 2 × S scenarios of data
    (random disturbances, a consensus group of S where the feature has
    consensus rows) and random group-mean weights."""
    kw = dict(K5_FEATURES[feature])
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), rho=rho,
                               device="cpu", **kw)
    x0 = torch.as_tensor(X0)
    Ws = torch.as_tensor(rng.normal(0.0, 0.3, size=(2, K5_S, N, 1)),
                         dtype=torch.float32)
    data = [tsw.assemble_stagewise(ts, x0, W) for W in Ws.reshape(-1, N, 1)]
    q, l, u = (torch.stack(a).reshape((2, K5_S) + a[0].shape)
               for a in zip(*data))
    ue = None
    if ts.n_ext:
        ue = torch.stack([tsw.assemble_stagewise_ext(ts, x0, W)
                          for W in Ws.reshape(-1, N, 1)]).reshape(2, K5_S, -1)
    M = None
    if ts.n_cons:
        w = torch.as_tensor(rng.uniform(0.1, 1.0, size=(K5_S, K5_S, N)),
                            dtype=torch.float32)
        M = w / w.sum(dim=1, keepdim=True)
    return ts, (q, l, u), ue, M


def _k5_iteration(ts, c, q, l, u, x, z, y, ze, ye, ue, M):
    """One iteration as K5 computes it, from the packed buffers ``c``
    (``cuda_stagewise.admm_constants``) indexed as the kernel indexes them
    (flat offsets), in the dtype of the carries: the forward/backward
    sweeps are K4's (``_solve_K``)."""
    dt = x.dtype
    N_, b, m, r, nb = ts.N, ts.b, ts.m_k, ts.n_ext, ts.n_blk
    J = c["J"].to(dt).reshape(-1)
    Mc = c["Mc"].to(dt).reshape(-1)
    rows = c["rows"].to(dt).reshape(-1)
    ik = np.arange(m)[:, None] * N_ + np.arange(N_)[None, :]   # [i][k]
    rho, lin, quad = (rows[w * m * N_ + ik].T for w in range(3))   # (N, m)
    ic = np.arange(m)[:, None] * b + np.arange(b)[None, :]         # [i][c]
    Jm, Mm = J[ic], Mc[ic]                                         # (m, b)
    tie = c["tie"].to(dt).reshape(-1) if nb else None
    blk = c["blk"].tolist() if nb else []
    mc = m - ts.n_cons if M is not None else m

    def m_block(k):
        """M_k as the kernel applies it (k ≥ 1): Mc and the ties."""
        Mk = Mm.clone()
        for j, cj in enumerate(blk):
            Mk[c["blk0"] + j, cj] -= tie[k * nb + j]
        return Mk

    def t_of(x, z, y, ze, ye):
        w = rho * z - y
        t = ts.sigma * x - q + torch.einsum("ic,...ki->...kc", Jm, w)
        for k in range(1, N_):
            t[..., k - 1, :] += w[..., k, :] @ m_block(k)
        if r:
            A = c["Aext"].to(dt).reshape(-1)
            kc = np.arange(N_)[:, None] * b + np.arange(b)[None, :]
            we = c["rho_ext"].to(dt) * ze - ye
            for j in range(r):
                t = t + A[j * N_ * b + kc] * we[..., j, None, None]
        return t

    t = t_of(x, z, y, ze, ye)
    base = tsw._solve_K(ts, t, tuple(f.to(dt) for f in ts.factors))
    xn = base
    if r:
        A = c["Aext"].to(dt).reshape(-1)
        Cw = c["Cw"].to(dt).reshape(-1)
        KiU = c["KiU"].to(dt).reshape(-1)
        flat = base.reshape(base.shape[:-2] + (N_ * b,))
        sv = torch.stack([(A[j * N_ * b:(j + 1) * N_ * b] * flat).sum(-1)
                          for j in range(r)], dim=-1)
        corr = torch.stack([sum(Cw[i * r + j] * sv[..., j] for j in range(r))
                            for i in range(r)], dim=-1)
        e = np.arange(N_ * b)
        kiu = torch.stack([KiU[e * r + j] for j in range(r)], dim=-1)
        xn = (flat - (kiu * corr[..., None, :]).sum(-1)).reshape(base.shape)
    ax = torch.einsum("ic,...kc->...ki", Jm, xn)
    for k in range(1, N_):
        ax[..., k, :] += xn[..., k - 1, :] @ m_block(k).T
    zr = ts.alpha * ax + (1 - ts.alpha) * z
    sv = zr + y / rho
    soft = (lin > 0) | (quad > 0)
    tt = (rho * (sv - u) - lin) / (rho + 2 * quad)
    zn = torch.where(soft, torch.where(sv > u, u + tt.clamp_min(0),
                                       torch.maximum(sv, l)),
                     torch.minimum(torch.maximum(sv, l), u))
    if mc < m:
        g = M.to(dt).reshape(-1)
        S_ = M.shape[0]
        for s_ in range(S_):
            for k in range(N_):
                zn[..., s_, k, mc:] = sum(
                    g[(s_ * S_ + t_) * N_ + k] * sv[..., t_, k, mc:]
                    for t_ in range(S_))
    yn = y + rho * (zr - zn)
    out = [xn, zn, yn, yn - y]
    if r:
        A = c["Aext"].to(dt).reshape(-1)
        flat = xn.reshape(xn.shape[:-2] + (N_ * b,))
        axe = torch.stack([(A[j * N_ * b:(j + 1) * N_ * b] * flat).sum(-1)
                           for j in range(r)], dim=-1)
        rho_e = c["rho_ext"].to(dt)
        zre = ts.alpha * axe + (1 - ts.alpha) * ze
        zen = torch.minimum(zre + ye / rho_e, ue)
        yen = ye + rho_e * (zre - zen)
        out += [zen, yen, yen - ye]
    return out


@pytest.mark.parametrize("feature", list(K5_FEATURES))
def test_k5_constant_packing_rebuilds_one_iteration(feature):
    """K5's packed constants (the buffers its wrapper passes), read at the
    kernel's flat offsets, rebuild the stage blocks J and M_k and one ADMM
    iteration from random carries within 1e-6 of the plain iteration
    (``_admm_iterations``, one iteration; both in fp64 on the same fp32
    values)."""
    rng = np.random.default_rng(5)
    ts, (q, l, u), ue, M = _k5_problem(feature, 1.0, rng)
    c = cs.admm_constants(ts)
    Jr, Mr, _ = tsw._row_blocks(ts)
    assert torch.equal(c["J"], Jr)
    Mk = c["Mc"].expand(ts.N, -1, -1).clone()
    Mk[0] = 0.0
    for j, cj in enumerate(ts.blk_cols):
        Mk[:, c["blk0"] + j, cj] -= ts.tie[:, j]
    assert torch.equal(Mk, Mr)
    d64 = tsw.stagewise_double(ts)
    q, l, u = (a.double() for a in (q, l, u))
    x = torch.as_tensor(rng.normal(size=q.shape))
    z = torch.clamp(torch.as_tensor(rng.normal(0.0, 2.0, size=l.shape)),
                    l, u)
    y = torch.as_tensor(rng.normal(size=l.shape))
    ze = ye = None
    if ts.n_ext:
        ue = ue.double()
        ze = torch.minimum(torch.as_tensor(rng.normal(size=ue.shape)), ue)
        ye = torch.as_tensor(rng.normal(size=ue.shape))
    Md = M.double() if M is not None else None
    want = tsw._admm_iterations(d64, q, l, u, x, z, y, ze, ye, ue, 1, Md)
    got = _k5_iteration(ts, c, q, l, u, x, z, y, ze, ye, ue, Md)
    for name, g, w in zip(("x", "z", "y", "dy", "z_e", "y_e", "dy_e"), got,
                          want):
        _close(g.numpy(), w.numpy(), 1e-6)


@pytest.mark.cuda
def test_k5_matches_its_plain_version_on_the_card():
    """On the card K5 launches once a call and agrees with the plain loop
    (both fp32, 60 iterations cold, then 40 warm from its result) within
    1e-3 (relative, floor 1) on every output, with every row kind and the
    group mean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ts, (q, l, u), ue, M = _k5_problem("all", 1.0, np.random.default_rng(3))
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), device="cuda",
                               **K5_FEATURES["all"])
    q, l, u, ue, M = (a.cuda() for a in (q, l, u, ue, M))
    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    ze = torch.clamp_max(torch.zeros_like(ue), ue)
    ye = torch.zeros_like(ue)
    for iters in (60, 40):
        ca.reset_launch_counts()
        got = cs.sw_admm_cuda(ts, q, l, u, x, z, y, ze, ye, ue, iters, M)
        assert ca.LAUNCHES["stagewise_k5"] == 1
        want = tsw._admm_iterations(ts, q, l, u, x, z, y, ze, ye, ue, iters,
                                    M)
        for g, w in zip(got, want):
            _close(g.cpu().numpy(), w.cpu().numpy(), 1e-3)
        x, z, y, _, ze, ye, _ = want


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["grouped", "global", "global_all"])
def test_k5_variants_match_the_plain_version_on_the_card(variant):
    """Each FLEX variant forced on the card launches once (counted under
    its name) and agrees with the plain loop as the shared one does (60
    iterations cold, 1e-3 relative, floor 1), with every row kind and the
    group mean."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    _, (q, l, u), ue, M = _k5_problem("all", 1.0, np.random.default_rng(3))
    ts = tsw.prepare_stagewise(TM, N, tdi.default_weights(), device="cuda",
                               **K5_FEATURES["all"])
    q, l, u, ue, M = (a.cuda() for a in (q, l, u, ue, M))
    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    ze = torch.clamp_max(torch.zeros_like(ue), ue)
    ye = torch.zeros_like(ue)
    ca.reset_launch_counts()
    got = cs.sw_admm_cuda(ts, q, l, u, x, z, y, ze, ye, ue, 60, M,
                          variant=variant)
    assert ca.LAUNCHES[cs.ADMM_LAUNCH[variant]] == 1
    want = tsw._admm_iterations(ts, q, l, u, x, z, y, ze, ye, ue, 60, M)
    for g, w in zip(got, want):
        _close(g.cpu().numpy(), w.cpu().numpy(), 1e-3)
