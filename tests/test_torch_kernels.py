"""Plain torch versions of the two kernels (ops/cuda_admm.py) vs the
reference's Pallas kernels in interpret mode on the CPU, on identical
prepared data. Both run the σ=0 iteration in fp32; the port sums the
stats in fp64. The CUDA kernels themselves are compared with these plain
versions on the card by chip_smoke.py (a CUDA kernel has no CPU mode)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.ops.admm import prepare_admm, prepare_admm_mpc
from pyhybridcontrol_tpu.ops.condense import CondensedMpc as JCondensed
from pyhybridcontrol_tpu.ops.pallas_admm import (
    admm_solve_pallas,
    admm_wave_pallas,
    pallas_for,
)
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.solver.bnb import CondensedBackend

torch.set_num_threads(2)

B = 128   # the Pallas kernel's batch grain, as in tests/test_pallas_admm.py
FIELDS = ("x", "obj", "r_prim", "r_prim_rel", "r_dual", "infeas_cert", "y",
          "z")


@pytest.fixture(scope="module")
def prob():
    """N=6 double integrator: reference specs (ρ and stiff ρ×10), their
    kernel preps carried across, 128 seeded states with node boxes."""
    rng = np.random.default_rng(2)
    c = JCondensed(jdi.switched_double_integrator(), 6,
                   jdi.default_weights())
    jq = c.device_qp()
    js, js2 = prepare_admm_mpc(c), prepare_admm_mpc(c, rho=10.0)
    x0s = rng.normal(size=(B, 2)).astype(np.float32)
    f, h = (np.array(a) for a in jax.vmap(jq.assemble)(jnp.asarray(x0s)))
    lb = np.tile(np.asarray(jq.lb), (B, 1))
    ub = np.tile(np.asarray(jq.ub), (B, 1))
    bidx = np.asarray(jq.binary_idx)
    fm = rng.uniform(size=(B, len(bidx))) < 0.3
    fv = (rng.uniform(size=(B, len(bidx))) < 0.5).astype(np.float32)
    lb[:, bidx] = np.where(fm, fv, 0.0)
    ub[:, bidx] = np.where(fm, fv, 1.0)
    ts, ts2 = convert.box_qp(js, "cpu"), convert.box_qp(js2, "cpu")
    return dict(js=js, js2=js2, ts=ts, ts2=ts2, bidx=tuple(bidx),
                pq=pallas_for(js), pq2=pallas_for(js2),
                kq=convert.kernel_qp(pallas_for(js), ts),
                kq2=convert.kernel_qp(pallas_for(js2), ts2),
                data=(f, h, lb, ub))


def _t(res):
    return {k: np.array(getattr(res, k)) for k in FIELDS}


def _assert_match(port, ref, obj_rtol, x_atol):
    """obj within obj_rtol·max(1,|obj|); x, z, y within x_atol; residuals
    to fp32 noise; certificate bits identical."""
    p, r = _t(port), _t(ref)
    scale = np.maximum(1.0, np.abs(r["obj"]))
    assert np.all(np.abs(p["obj"] - r["obj"]) <= obj_rtol * scale), \
        np.max(np.abs(p["obj"] - r["obj"]) / scale)
    for k in ("x", "z", "y"):
        np.testing.assert_allclose(p[k], r[k], rtol=x_atol, atol=x_atol,
                                   err_msg=k)
    np.testing.assert_allclose(p["r_prim_rel"], r["r_prim_rel"], rtol=1e-2,
                               atol=1e-5)
    np.testing.assert_allclose(p["r_dual"], r["r_dual"], rtol=1e-2,
                               atol=1e-4)
    np.testing.assert_array_equal(p["infeas_cert"], r["infeas_cert"])


@pytest.mark.parametrize("iters", [60, 400])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_k1_matches_pallas_interpret(prob, iters, warm):
    jd = tuple(map(jnp.asarray, prob["data"]))
    td = tuple(map(torch.as_tensor, prob["data"]))
    jw = tw = None
    if warm:
        r0 = admm_solve_pallas(prob["pq"], *jd, iters=30, interpret=True)
        jw = (r0.x, r0.z, r0.y)
        tw = tuple(torch.as_tensor(np.array(a)) for a in jw)
    ref = admm_solve_pallas(prob["pq"], *jd, iters=iters, warm=jw,
                            interpret=True)
    port = ca.admm_solve_plain(prob["kq"], *td, iters=iters, warm=tw)
    # same σ=0 iteration and padded data in fp32; summation order differs
    _assert_match(port, ref, obj_rtol=1e-4, x_atol=1e-3)


def test_plain_k1_warm_chain_is_exact(prob):
    """60 warm + 60 = 120 cold (the σ=0 iteration has no x carry), as
    tests/test_pallas_admm.py checks for the Pallas kernel."""
    kq = prob["kq"]
    td = tuple(map(torch.as_tensor, prob["data"]))
    cold = ca.admm_solve_plain(kq, *td, iters=120)
    r1 = ca.admm_solve_plain(kq, *td, iters=60)
    warm = ca.admm_solve_plain(kq, *td, iters=60, warm=(r1.x, r1.z, r1.y))
    np.testing.assert_allclose(warm.obj.numpy(), cold.obj.numpy(),
                               rtol=1e-5, atol=1e-5)


def test_plain_k1_infeasibility_certificate(rng):
    """Instance 0 has x0 ≤ 1 ∧ x0 ≥ 2: the certificate fires on it only,
    as the Pallas kernel's does."""
    n = 8
    js = prepare_admm(np.vstack([np.eye(n)[:1], -np.eye(n)[:1]]),
                      np.eye(n))
    ts = convert.box_qp(js, "cpu")
    q = rng.normal(size=(B, n)).astype(np.float32)
    h = np.tile(np.float32([1.0, 2.0]), (B, 1))
    h[0] = [1.0, -2.0]
    lb = np.full((B, n), -10.0, np.float32)
    data = (q, h, lb, -lb)
    ref = admm_solve_pallas(pallas_for(js), *map(jnp.asarray, data),
                            iters=400, interpret=True)
    port = ca.admm_solve_auto(ts, *map(torch.as_tensor, data), iters=400)
    cert = port.infeas_cert.numpy()
    assert cert[0] and not cert[1:].any()
    np.testing.assert_array_equal(cert, np.asarray(ref.infeas_cert))


@pytest.mark.parametrize("stiff", [False, True])
def test_plain_k2_matches_pallas_interpret(prob, stiff):
    jd = tuple(map(jnp.asarray, prob["data"]))
    td = tuple(map(torch.as_tensor, prob["data"]))
    kw = dict(iters=200, probe_iters=200)
    j_relax, j_probe = admm_wave_pallas(
        prob["pq"], prob["pq2"] if stiff else None, prob["bidx"], *jd,
        interpret=True, **kw)
    t_relax, t_probe = ca.admm_wave_plain(
        prob["kq"], prob["kq2"] if stiff else None, prob["bidx"], *td, **kw)
    _assert_match(t_relax, j_relax, obj_rtol=1e-4, x_atol=1e-3)
    # the probe starts from the rounded relaxation: same rounding on both
    # sides, so the same fixings and the same tolerance
    _assert_match(t_probe, j_probe, obj_rtol=1e-4, x_atol=1e-3)


def test_wave_auto_probe_bounds_follow_reference_formula(prob):
    """admm_wave_auto returns the probe bounds round(clip(clip(x, node
    box), 0, 1)) on the binaries and the node box elsewhere."""
    td = tuple(map(torch.as_tensor, prob["data"]))
    f, h, lb, ub = td
    relax, probe, lb_p, ub_p = ca.admm_wave_auto(
        prob["ts"], prob["ts2"], prob["bidx"], f, h, lb, ub, iters=100,
        probe_iters=100)
    bidx = list(prob["bidx"])
    pv = torch.round(torch.clamp(torch.minimum(torch.maximum(
        relax.x[:, bidx], lb[:, bidx]), ub[:, bidx]), 0.0, 1.0))
    assert torch.equal(lb_p[:, bidx], pv) and torch.equal(ub_p[:, bidx], pv)
    rest = [j for j in range(lb.shape[1]) if j not in bidx]
    assert torch.equal(lb_p[:, rest], lb[:, rest])
    # fixed binaries keep their node value
    fixed = lb[:, bidx] == ub[:, bidx]
    assert torch.equal(pv[fixed], lb[:, bidx][fixed])


def test_dispatch_follows_the_device(prob, monkeypatch):
    """A CPU tensor takes the plain version and never the loader; any
    batch size is taken (no 128 grain); a 1-D q is a batch of one; a
    device with no kernel raises."""
    from pyhybridcontrol_tpu_torch.ops import _build

    monkeypatch.setattr(_build, "load_library",
                        lambda: pytest.fail("CPU path reached the loader"))
    before = dict(ca.LAUNCHES)
    f, h, lb, ub = map(torch.as_tensor, prob["data"])
    r = ca.admm_solve_auto(prob["ts"], f[:3], h[:3], lb[:3], ub[:3],
                           iters=50)
    ref = ca.admm_solve_plain(prob["kq"], f[:3], h[:3], lb[:3], ub[:3],
                              iters=50)
    assert torch.equal(r.obj, ref.obj)
    r1 = ca.admm_solve_auto(prob["ts"], f[0], h[0], lb[0], ub[0], iters=50)
    assert r1.x.shape == (f.shape[1],)
    # a batch of one takes another BLAS path: rounding-level differences
    assert torch.allclose(r1.obj, ref.obj[0], rtol=1e-5, atol=1e-5)
    ca.admm_wave_auto(prob["ts"], None, prob["bidx"], f[:5], h[:5], lb[:5],
                      ub[:5], iters=20, probe_iters=20)
    assert ca.LAUNCHES == before      # plain versions never count
    meta = [t.to("meta") for t in (f, h, lb, ub)]
    with pytest.raises(ValueError, match="no ADMM kernel"):
        ca.admm_solve_auto(prob["ts"], *meta, iters=5)


def test_probe_prep_must_share_the_ruiz_frame(prob):
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm as tprep

    other = tprep(np.eye(prob["ts"].n)[:3] * 7.0, np.eye(prob["ts"].n),
                  device="cpu")
    # checked once, where the B&B backend pairs the two preps
    with pytest.raises(ValueError, match="Ruiz frame"):
        CondensedBackend(prob["ts"], None, other)
    CondensedBackend(prob["ts"], None, prob["ts2"])


# ---- K1's split-precision phase (low_frac) -------------------------------


@pytest.fixture(scope="module")
def prob12():
    """The shape of the reference's own mixed-precision test
    (tests/test_pallas_admm.py): N=12, B=128, 120 iterations, root boxes.
    nr=40 and mGp=120 here, so the 16 grain pads both (48, 128)."""
    rng = np.random.default_rng(3)
    c = JCondensed(jdi.switched_double_integrator(), 12,
                   jdi.default_weights())
    jq, js = c.device_qp(), prepare_admm_mpc(c)
    x0s = rng.normal(size=(B, 2)).astype(np.float32)
    f, h = (np.array(a) for a in jax.vmap(jq.assemble)(jnp.asarray(x0s)))
    lb = np.tile(np.asarray(jq.lb), (B, 1))
    ub = np.tile(np.asarray(jq.ub), (B, 1))
    pq = pallas_for(js)
    return dict(pq=pq, kq=convert.kernel_qp(pq, convert.box_qp(js, "cpu")),
                data=(f, h, lb, ub))


@pytest.fixture(scope="module")
def full12(prob12):
    jd = tuple(map(jnp.asarray, prob12["data"]))
    return np.array(admm_solve_pallas(prob12["pq"], *jd, iters=120,
                                      interpret=True).obj)


@pytest.mark.parametrize("low_frac", [0.8, 1.0])
def test_plain_k1_mixed_matches_pallas_interpret(prob12, full12, low_frac):
    """admm_solve_plain(low_frac=) against the Pallas kernel's iters_lo
    phase in interpret mode: both split operands into bf16 hi/lo pairs
    and accumulate three exact products in fp32, so they differ by
    summation order only (obj rtol=atol=1e-4); and each tracks the
    full-precision kernel to the reference's own 2e-3."""
    jd = tuple(map(jnp.asarray, prob12["data"]))
    td = tuple(map(torch.as_tensor, prob12["data"]))
    ref = admm_solve_pallas(prob12["pq"], *jd, iters=120, interpret=True,
                            low_frac=low_frac)
    port = ca.admm_solve_plain(prob12["kq"], *td, iters=120,
                               low_frac=low_frac)
    np.testing.assert_allclose(port.obj.numpy(), np.asarray(ref.obj),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(port.x.numpy(), np.asarray(ref.x), atol=5e-3)
    np.testing.assert_array_equal(port.infeas_cert.numpy(),
                                  np.asarray(ref.infeas_cert))
    np.testing.assert_allclose(port.obj.numpy(), full12, rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(ref.obj), full12, rtol=2e-3,
                               atol=2e-3)
    # bench.py's gate on the headline configuration: max relative
    # objective delta against full precision ≤ 1e-4
    rel = np.abs(port.obj.numpy() - full12) / np.maximum(1.0, np.abs(full12))
    assert rel.max() <= 1e-4


@pytest.mark.parametrize("low_frac,warm", [(0.8, False), (1.0, False),
                                           (0.5, True)])
def test_zero_padding_to_16_changes_no_output(prob12, low_frac, warm):
    """The tensor-core tiles want nr and mGp in multiples of 16; the
    padded rows and columns are zero and inert: every output field of the
    mixed solve is the same on the 8-padded and the 16-padded prep (fp32
    rounding of another summation length, 1e-6)."""
    kq = prob12["kq"]
    kq16 = ca.pad_kernel_qp(kq)
    assert (kq.n_pad, kq.m_pad) == (40, 120)
    assert (kq16.n_pad, kq16.m_pad) == (48, 128)
    assert ca.pad_kernel_qp(kq) is kq16 and ca.pad_kernel_qp(kq16) is kq16
    assert kq16.M.shape == (128 + 48, 48) and kq16.AGT.shape == (48, 128)
    assert torch.equal(kq16.M[128:128 + 40, :40], kq.M[120:])
    assert not kq16.M[120:128].any() and not kq16.AGT[40:].any()
    td = tuple(map(torch.as_tensor, prob12["data"]))
    w = None
    if warm:
        r0 = ca.admm_solve_plain(kq, *td, iters=20)
        w = (r0.x, r0.z, r0.y)
    iters_lo = int(120 * low_frac)
    a = ca._solve_plain(kq, *td, 120, iters_lo, w)
    b = ca._solve_plain(kq16, *td, 120, iters_lo, w)
    c = ca.admm_solve_plain(kq, *td, iters=120, warm=w, low_frac=low_frac)
    for k in FIELDS:
        ga, gb, gc = (getattr(r, k) for r in (a, b, c))
        assert ga.shape == gb.shape
        if k == "infeas_cert":
            assert torch.equal(ga, gb)
        else:
            np.testing.assert_allclose(gb.numpy(), ga.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=k)
        assert torch.equal(gb, gc)       # the public call pads by itself


def test_mixed_split_and_low_frac_rules(prob12, rng):
    """hi/lo split as the reference's _bf16_split; iters_lo =
    int(iters·low_frac); low_frac=0 is the full-precision path; bad
    fractions raise."""
    from pyhybridcontrol_tpu.ops.pallas_admm import _bf16_split

    a = rng.normal(size=(64, 7)).astype(np.float32) * 37.0
    hi, lo = ca._bf16_split(torch.as_tensor(a))
    jhi, jlo = _bf16_split(jnp.asarray(a))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(jhi.astype(jnp.float32)))
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(jlo.astype(jnp.float32)))
    assert float((hi + lo - torch.as_tensor(a)).abs().max()) <= \
        2.0 ** -16 * np.abs(a).max()
    kq = prob12["kq"]
    assert ca._split_iters(kq, 120, 0.8)[1] == 96
    assert ca._split_iters(kq, 7, 0.5)[1] == 3
    assert ca._split_iters(kq, 120, 0.0) == (kq, 0)
    td = tuple(t[:4] for t in map(torch.as_tensor, prob12["data"]))
    full = ca.admm_solve_plain(kq, *td, iters=30)
    assert torch.equal(ca.admm_solve_plain(kq, *td, iters=30,
                                           low_frac=0.0).obj, full.obj)
    assert not torch.equal(ca.admm_solve_plain(kq, *td, iters=30,
                                               low_frac=1.0).x, full.x)
    for bad in (-0.1, 1.5):
        with pytest.raises(ValueError, match="low_frac"):
            ca.admm_solve_plain(kq, *td, iters=30, low_frac=bad)
    # the B&B entry points keep the option off their path
    import inspect

    for fn in (ca.admm_solve_auto, ca.admm_wave_auto, ca.admm_wave_plain):
        assert "low_frac" not in inspect.signature(fn).parameters
