"""Plain torch versions of the two kernels (ops/cuda_admm.py) vs the
reference's Pallas kernels in interpret mode on the CPU, on identical
prepared data. Both run the σ=0 iteration in fp32; the port sums the
stats in fp64. The CUDA kernels themselves are compared with these plain
versions on the card by chip_smoke.py (a CUDA kernel has no CPU mode)."""

import ctypes
import importlib.util
import inspect
import os
import re
import types

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
    for fn in (ca.admm_solve_auto, ca.admm_wave_auto, ca.admm_wave_plain):
        assert "low_frac" not in inspect.signature(fn).parameters


# ---- the kernels' launch plan, packing factors and argument block --------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _shape(N):
    """(nr, mGp) of the double integrator at horizon N (n=3N, m=10N)."""
    return -(-3 * N // 8) * 8, -(-10 * N // 8) * 8


@pytest.mark.parametrize("N,B,pb,threads", [
    (10, 1024, 4, 288),     # config-4 wave
    (10, 32, 1, 288),       # config-1 wave
    (20, 4096, 8, 544),     # bench primary
    (10, 1, 1, 288), (10, 3, 1, 288), (10, 33, 1, 288), (10, 257, 1, 288),
    (21, 8, 1, 288),        # K2 with the stiff probe at N=21
    (26, 4096, 1, 352),     # the largest horizon that fits: one problem
])
def test_plan_instantiation_at_the_main_shapes(N, B, pb, threads):
    """The plan picks the largest tile that fits and leaves ~2 blocks per
    SM, the warps that divide the warp tasks best (9 where R is 8 more than
    a multiple of 32, 17 of the 18 a tile of 8 may have at N=20), and
    reckons the shared memory of that tile."""
    nr, mGp = _shape(N)
    pl = ca.plan(B, nr, mGp)
    assert (pl.pb, pl.threads) == (pb, threads)
    assert pl.smem == ca.smem_bytes(nr, mGp, pb) <= ca.SMEM_MAX
    assert pl.warps * 32 == pl.threads and 8 <= pl.warps <= ca.MAX_WARPS[pb]
    if pb > 1:
        assert -(-B // pb) >= 1.9 * ca.SM_COUNT
        bigger = [t for t in ca.TILES if t > pb]
        assert all(-(-B // t) < 1.9 * ca.SM_COUNT
                   or ca.smem_bytes(nr, mGp, t) > ca.SMEM_MAX
                   for t in bigger)


@pytest.mark.parametrize("pb", [8, 4, 1])
def test_plan_takes_an_asked_tile_or_raises(pb):
    """An asked tile is taken with staged constants where they fit, else
    streamed; asked for staged constants that do not fit, or for a width
    with no instantiation, the plan raises."""
    nr, mGp = _shape(21)
    pl = ca.plan(11, nr, mGp, pb)          # any batch: the edge is masked
    assert pl.pb == pb and pl.smem <= ca.SMEM_MAX and not pl.streamed
    with pytest.raises(ValueError, match="shared memory"):
        ca.plan(4096, *_shape(60), pb, streamed=False)
    pl = ca.plan(4096, *_shape(60), pb)
    assert pl.pb == pb and pl.streamed
    assert pl.smem == ca.smem_bytes(*_shape(60), pb, True) <= ca.SMEM_MAX
    with pytest.raises(ValueError, match="no instantiation"):
        ca.plan(4096, nr, mGp, 2 * pb + 1)


def test_plan_refuses_what_does_not_fit_and_empty_batches():
    """N=26 is the largest horizon of the double integrator whose
    constants a block can stage; N=27 and N=60 take the streamed variant
    (their iterates fit); a shape whose iterates fit no tile even with the
    constants streamed, and an empty batch, raise: ValueError, no other
    path."""
    assert not ca.plan(2, *_shape(26)).streamed
    assert ca.plan(2, *_shape(26)).smem <= ca.SMEM_MAX
    for N in (27, 60):
        with pytest.raises(ValueError, match="shared memory"):
            ca.plan(2, *_shape(N), streamed=False)
        pl = ca.plan(2, *_shape(N))
        assert pl.streamed and pl.pb == 1 and pl.smem <= ca.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        ca.plan(2, 2048, 4096)
    with pytest.raises(ValueError, match="empty batch"):
        ca.plan(0, *_shape(10))


def test_plan_depends_on_shapes_alone(prob):
    """Nothing but (B, nr, mGp) and an asked tile enters the plan: two
    problems of one shape get one plan, and K1 and K2 share it."""
    assert list(inspect.signature(ca.plan).parameters) == [
        "B", "nr", "mGp", "pb", "streamed"]
    kq, kq2 = prob["kq"], prob["kq2"]
    assert (kq.n_pad, kq.m_pad) == (kq2.n_pad, kq2.m_pad)
    for b in (1, 32, 1024, 4096):
        assert ca.plan(b, kq.n_pad, kq.m_pad) == ca.plan(b, kq2.n_pad,
                                                         kq2.m_pad)
    assert ca.plan(4096, 64, 200).pb >= ca.plan(1024, 64, 200).pb


@pytest.mark.parametrize("nr", range(8, 129, 8))
def test_padded_strides_spread_the_lane_groups_over_banks(nr):
    """Â_G rows: the 8 lane groups of product A read rows one apart, 4
    words each; Mᵀ rows: two groups one row apart, 16 words each. Their
    words must fall in different banks."""
    for mGp in (8, 104, 200, 216):
        sa, sm = ca._strides(nr, mGp)
        assert sa >= nr and sm >= mGp + nr and sa % 4 == 0 and sm % 8 == 0
        assert {(g * sa + w) % 32 for g in range(8)
                for w in range(4)} == set(range(32))
        assert {(g * sm + w) % 32 for g in range(2)
                for w in range(16)} == set(range(32))


def test_argument_block_mirrors_the_kernel_source():
    """``_Args`` lists the fields of ``struct PhcAdmmArgs`` in the source's
    order, pointers then ints then floats."""
    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm.cu")).read()
    body = src[src.index("struct PhcAdmmArgs {"):]
    body = re.sub(r"//[^\n]*", "", body[:body.index("};")])
    names = []
    for decl in body.split("{", 1)[1].split(";"):
        decl = decl.replace("const", "").replace("float", "").replace(
            "int", "")
        names += [w for w in re.findall(r"[A-Za-z_][A-Za-z0-9_]*", decl)]
    assert names == [f[0] for f in ca._Args._fields_]
    kinds = [f[1] for f in ca._Args._fields_]
    assert kinds == ([ctypes.c_void_p] * 24 + [ctypes.c_int] * 17
                     + [ctypes.c_float] * 3)
    assert ctypes.sizeof(ca._Args) == 24 * 8 + 17 * 4 + 3 * 4


def test_kernel_packing_factors_reproduce_pack_and_result_bitwise(prob, rng):
    """The plain path's packing is unchanged (numpy fp32, written out), and
    the factors the kernels pack with (``io``) give the same bits: one
    multiplication per value, the ±BIG clamp on the box only."""
    kq, spec = prob["kq"], prob["ts"]
    n, m, nr, mGp = spec.n, spec.m_ineq, kq.n_pad, kq.m_pad
    f, h, lb, ub = (a[:7].copy() for a in prob["data"])
    lb[0, :3], ub[1, :3] = -np.inf, np.inf
    z0 = rng.normal(size=(7, m + n)).astype(np.float32)
    y0 = rng.normal(size=(7, m + n)).astype(np.float32)
    tq, th, tlb, tub, tz, ty = map(torch.as_tensor, (f, h, lb, ub, z0, y0))
    qs, lG, uG, lB, uB, w4 = ca._pack(kq, tq, th, tlb, tub, (None, tz, ty))
    D, E = spec.D.numpy(), spec.E.numpy()
    cD = (spec.cost_scale * spec.D).numpy()
    big = np.float32(ca.BIG)

    def padded(a, cols):
        out = np.zeros((a.shape[0], cols), np.float32)
        out[:, :a.shape[1]] = a
        return out

    want = dict(qs=padded(cD * f, nr), uG=padded(h * E[:m], mGp),
                lG=padded(np.full((7, m), -big, np.float32), mGp),
                lB=padded(np.clip(lb * E[m:], -big, big), nr),
                uB=padded(np.clip(ub * E[m:], -big, big), nr))
    for k, got in dict(qs=qs, uG=uG, lG=lG, lB=lB, uB=uB).items():
        np.testing.assert_array_equal(got.numpy(), want[k], err_msg=k)
    for got, src, lo, cols in ((w4[0], z0, 0, mGp), (w4[1], y0, 0, mGp),
                               (w4[2], z0, m, nr), (w4[3], y0, m, nr)):
        width = m if lo == 0 else n
        np.testing.assert_array_equal(
            got.numpy(), padded(src[:, lo:lo + width], cols))
    # the kernels' factors: [c·D, E_B, D | E_G], zero in the padding
    io = ca._layout(kq)["io"].numpy()
    np.testing.assert_array_equal(io[:nr], padded(cD[None], nr)[0])
    np.testing.assert_array_equal(io[nr:2 * nr], padded(E[None, m:], nr)[0])
    np.testing.assert_array_equal(io[2 * nr:3 * nr], padded(D[None], nr)[0])
    np.testing.assert_array_equal(io[3 * nr:], padded(E[None, :m], mGp)[0])
    assert np.array_equal(ca._layout(kq)["PT"].numpy(), kq.P.numpy().T)
    # warm iterates are read in place from the public layout
    views = ca._warm_views(kq, (None, tz, ty))
    assert [v.shape[1] for v in views] == [m, m, n, n]
    assert all(v.stride(0) == m + n and v.stride(1) == 1 for v in views)
    assert views[2].data_ptr() == tz.data_ptr() + 4 * m
    # _result: x = D·x̃, z and y concatenated from the unpadded columns
    xt = torch.as_tensor(rng.normal(size=(7, nr)).astype(np.float32))
    res = ca._result(kq, xt, w4[0], w4[1], w4[2], w4[3], *([None] * 5))
    np.testing.assert_array_equal(res.x.numpy(), D * xt.numpy()[:, :n])
    np.testing.assert_array_equal(res.z.numpy(), z0)
    np.testing.assert_array_equal(res.y.numpy(), y0)


@pytest.mark.parametrize("obj,limit", [
    (1.0, 1e-3), (-30.5, 1e-3), (-184.0, 192 * 2.0 ** -23 * 184.0),
    (-1221.6, 192 * 2.0 ** -23 * 1221.6)])
def test_serve_limit_follows_fp32_resolution_above_the_floor(obj, limit):
    """chip_smoke's limit on |obj − enumeration|: 1e-3, or 192 fp32 relative
    steps of the objective where that is more (above |obj| ≈ 43.7)."""
    cs = _chip_smoke()
    assert cs.serve_limit(obj) == pytest.approx(limit, rel=1e-12)
    lim = cs.serve_limit(np.array([1.0, -30.5, -1221.6]))
    assert lim.shape == (3,) and lim[2] > lim[1] == lim[0] == cs.SERVE_FLOOR


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(_REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("name", ["config2", "config3", "config4b"])
def test_cert_near_gives_the_plain_bits_back(name):
    """chip_smoke's certificate rule on a real frame (16 node problems of
    the config, 150 + 150 iterations): the plain version's last half step,
    run again from its final iterates, gives its certificate bits back
    (cert_near checks that, for the relaxation and the probe); a bit that
    differs passes near a threshold only, and not at all by default."""
    from pyhybridcontrol_tpu_torch.ops.admm import AdmmResult

    cs = _chip_smoke()
    spec, spec_p, bidx, q, h, lb, ub = cs.real_problem(
        name, 16, torch.device("cpu"), cs.phase_rng("streamed_paths"))
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    plain = (kq, q, h, lb, ub)
    relax, probe = ca.admm_wave_plain(kq, kq2, bidx, q, h, lb, ub,
                                      iters=150, probe_iters=150)
    for ref, b in ((relax, None), (probe, bidx)):
        near = cs.cert_near(plain, ref, b)
        assert near.shape == ref.infeas_cert.shape
        assert near.dtype == torch.bool
        for i, passes in ((int(torch.nonzero(~near)[0]), False),
                          *(((int(torch.nonzero(near)[0]), True),)
                            if near.any() else ())):
            bits = ref.infeas_cert.clone()
            bits[i] = ~bits[i]
            got = AdmmResult(**{**vars(ref), "infeas_cert": bits})
            with pytest.raises(AssertionError):
                cs.certs_held(name, got, ref)
            if passes:
                cs.certs_held(name, got, ref, lambda: near)
            else:
                with pytest.raises(AssertionError):
                    cs.certs_held(name, got, ref, lambda: near)


@pytest.mark.parametrize("name", ["config2", "config3"])
def test_fp64_bnb_oracle_matches_enumeration_oracle(name):
    """chip_smoke's exact hold: its fp64 branch and bound (oracle_bnb)
    finds the optimum that enumerating every leaf finds, on the bench
    frame at N=1 at two of the hold's states (rel = abs = 1e-9)."""
    from pyhybridcontrol_tpu_torch.solver.oracle import (
        solve_miqp_enumeration_oracle)

    cs = _chip_smoke()
    _, _, c = cs.bench_frame(name, 1)
    x0s, W, P = cs.bench_data(name, 1, 2, cs.phase_rng(f"exact_hold_{name}"))
    for i in range(2):
        f, h = c.assemble_np(x0s[i], None if W is None else W[i],
                             price_seq=P)
        got, nodes = cs.oracle_bnb(c, f, h)
        want = solve_miqp_enumeration_oracle(c.H, f, c.G, h, c.lb, c.ub,
                                             c.binary_idx)
        assert want.status == "optimal"
        assert got == pytest.approx(want.obj, rel=1e-9, abs=1e-9)
        assert 1 <= nodes < 2 ** (len(c.binary_idx) + 1)


# ---- the split-precision kernel's plan, strides and lane ownership -------


def _shape16(N):
    """(nr, mGp) of the double integrator at horizon N on the 16 grain of
    the split-precision kernel."""
    return tuple(-(-d // 16) * 16 for d in _shape(N))


@pytest.mark.parametrize("N,B,sms,tile", [
    (20, 4096, 132, 32),    # bench primary: one round of 128 blocks
    (20, 4095, 132, 32),    # ragged last tile
    (20, 128, 132, 16),     # chip_smoke's small batches
    (20, 2112, 132, 16),    # ⌈B/16⌉ = 132 blocks: one round already
    (20, 2113, 132, 32),
    (20, 4096, 264, 16),    # a card with twice the SMs
    (12, 1, 132, 16), (12, 33, 132, 16), (12, 4095, 132, 32),
    (21, 4096, 132, 16),    # a tile of 32 does not fit N=21
])
def test_plan_mixed_picks_the_tile(N, B, sms, tile):
    """A tile of 32 problems where 16 would take more than one round of
    blocks (⌈B/16⌉ > SMs) and 32 fits, else 16; one warp per 16 rows of
    u; the reckoned shared memory fits an sm_90 block."""
    nr, mGp = _shape16(N)
    pl = ca.plan_mixed(B, nr, mGp, sms)
    assert pl.tile == tile
    assert pl.threads == 2 * (nr + mGp) <= ca.MIXED_MAX_THREADS[tile]
    assert pl.smem == ca.mixed_smem_bytes(nr, mGp, tile) <= ca.SMEM_MAX
    for t in ca.MIXED_TILES:                 # an asked width, where it fits
        if ca.mixed_smem_bytes(nr, mGp, t) <= ca.SMEM_MAX and \
                pl.threads <= ca.MIXED_MAX_THREADS[t]:
            assert ca.plan_mixed(B, nr, mGp, sms, tile=t).tile == t


def test_plan_mixed_refuses_what_does_not_fit_and_empty_batches():
    """N=21 is the largest horizon of the double integrator that fits (a
    tile of 16, 194,048 bytes; the bench primary's tile of 32 takes
    230,144); N=22 raises, as do an empty batch, a width with no
    instantiation, a forced tile that does not fit and shapes off the 16
    grain: ValueError, no other path."""
    assert ca.mixed_smem_bytes(*_shape16(20), 32) == 230144
    assert ca.mixed_smem_bytes(*_shape16(21), 16) == 194048
    fits = [N for N in range(4, 40)
            if ca.mixed_smem_bytes(*_shape16(N), 16) <= ca.SMEM_MAX]
    assert max(fits) == 21
    with pytest.raises(ValueError, match="shared memory"):
        ca.plan_mixed(2, *_shape16(22))
    with pytest.raises(ValueError, match="shared memory"):
        ca.plan_mixed(4096, *_shape16(21), tile=32)
    with pytest.raises(ValueError, match="empty batch"):
        ca.plan_mixed(0, *_shape16(12))
    with pytest.raises(ValueError, match="no instantiation"):
        ca.plan_mixed(64, *_shape16(12), tile=8)
    with pytest.raises(ValueError, match="multiples of 16"):
        ca.plan_mixed(64, 40, 120)
    with pytest.raises(ValueError, match="threads"):
        ca.plan_mixed(64, 16, 640)          # 656 rows: 41 warps


def test_plan_mixed_depends_on_shapes_alone():
    """Nothing but (B, nr, mGp), the SM count and an asked width enters the
    plan; the instantiations' thread limits are the source's."""
    assert list(inspect.signature(ca.plan_mixed).parameters) == [
        "B", "nr", "mGp", "sm_count", "tile"]
    assert ca.plan_mixed(4096, 64, 208) == ca.plan_mixed(4096, 64, 208, 132)
    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm_mixed.cu")).read()
    got = {int(t): int(v) for t, v in re.findall(
        r"struct MaxThreads<(\d+)> \{\s*static constexpr int value = (\d+);",
        src)}
    assert got == ca.MIXED_MAX_THREADS
    assert set(got) == set(ca.MIXED_TILES)


def test_rows_per_task_mirror_the_kernel_source():
    """The plan's ROWS_PER_TASK is the source's RT·32/KS of both products
    for every tile width, B_KS is the source's B_KS (the layout permutes
    Mᵀ for it), and product B (ẑ = M t, depth nr) splits its depth over at
    least 4 lane groups everywhere (the tile of 1 once took 2)."""
    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm.cu")).read()
    cfg = {int(t): dict(re.findall(r"(\w+) = (\d+)", body))
           for t, body in re.findall(
               r"struct Cfg<(\d+)> \{\s*enum \{([^}]*)\}", src)}
    assert set(cfg) == set(ca.TILES)
    for pb, c in cfg.items():
        c = {k: int(v) for k, v in c.items()}
        assert (c["A_RT"] * 32 // c["A_KS"],
                c["B_RT"] * 32 // c["B_KS"]) == ca.ROWS_PER_TASK, pb
        assert c["B_KS"] >= 4 and c["WARPS"] == ca.MAX_WARPS[pb], pb
        assert c["B_KS"] == ca.B_KS[pb], pb
    assert "vstore<W>(s.t + t_row<C::B_KS>(j, nr) * PB + p, t);" in src


@pytest.mark.parametrize("nr", range(8, 257, 8))
def test_depth_rows_give_each_lane_group_a_run_of_variables(nr):
    """``depth_rows`` (the layout's Mᵀ order) is a permutation, the inverse
    of the kernel's t_row (mirrored here from the source), and lane group g
    of ẑ = M t — rows g, g+ks, g+2ks, … — sums variables g·nr/ks … in
    order: cancelling neighbour terms share a partial sum."""
    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm.cu")).read()
    body = re.search(r"int t_row\(int j, int nr\) \{(.*?)\n\}", src,
                     re.S).group(1)
    assert "const int kc = nr / KS;" in body
    assert "return (j % kc) * KS + j / kc;" in body
    for ks in set(ca.B_KS.values()):
        rows = ca.depth_rows(nr, ks)
        assert sorted(rows) == list(range(nr))
        kc = nr // ks
        t_row = [(j % kc) * ks + j // kc for j in range(nr)]
        assert all(rows[t_row[j]] == j for j in range(nr))
        for g in range(ks):
            assert list(rows[g::ks]) == list(range(g * kc, (g + 1) * kc))


def _bank_groups(stride_bytes, rows=8):
    """16-byte bank groups (of the 8 in 128 bytes) hit by ``rows`` rows of
    16 bytes at ``stride_bytes``."""
    return {(r * stride_bytes // 16) % 8 for r in range(rows)}


def _swz(tile, r, p):
    """Mirror of the kernel's ``swz``: element (r, p) of an operand tile
    [rows][tile] whose 16-byte chunks are XOR-swizzled by the row's place
    in its run of 128-byte lines."""
    lines, chunks = 64 // tile, tile // 8
    return r * tile + (((p >> 3) ^ ((r // lines) % chunks)) << 3) + (p & 7)


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("N", range(2, 22))
def test_mixed_strides_keep_ldmatrix_phases_conflict_free(N, tile):
    """Each ldmatrix phase reads 8 rows of 16 bytes. Â_Gᵀ and M rows (the
    A fragments): every stride 8 elements over a multiple of 16 puts them
    in 8 different bank groups. The operand tiles (B fragments, rows kt·16
    + lane%16, chunk 2np + lane/16): the swizzle does, and it is a
    permutation of each row; the lanes' bf16-pair stores of an operand
    (rows 8a + lane/4, words lane%4 of chunk nt) hit 32 different banks."""
    nr, mGp = _shape16(N)
    for stride in ca.mixed_strides(nr, mGp):
        assert stride % 16 == 8
        assert _bank_groups(2 * stride) == set(range(8))
    for r in range(64):
        assert sorted(_swz(tile, r, p) for p in range(tile)) == list(
            range(r * tile, (r + 1) * tile))
        # a K tile further on keeps the swizzle (the kernel adds 16·T)
        assert all(_swz(tile, r + 16, p) == _swz(tile, r, p) + 16 * tile
                   for p in range(tile))
    for kt in range(3):
        for np_ in range(tile // 16):
            for half in (0, 1):          # lanes 0-15, lanes 16-31
                for phase in (0, 8):     # the 8 lanes of one ldmatrix phase
                    addrs = [2 * _swz(tile, kt * 16 + phase + i,
                                      np_ * 16 + half * 8) for i in range(8)]
                    assert all(a % 16 == 0 for a in addrs)
                    assert {a // 16 % 8 for a in addrs} == set(range(8))
    for a in range(4):
        for nt in range(tile // 8):
            banks = {2 * _swz(tile, 8 * a + ln // 4, nt * 8 + 2 * (ln % 4))
                     // 4 % 32 for ln in range(32)}
            assert len(banks) == 32


def _mixed_ownership(nr, mGp, tile):
    """Mirror of the kernel's lane -> elements of u for the m16n8k16
    accumulator: warp w owns rows 16w.. of u; lane l holds, for each n8
    tile nt and accumulator register c, row 16w + l/4 + 8(c/2) and
    problem 8nt + 2(l%4) + c%2. Returns {(row, problem): (w, l, nt, c)}."""
    own = {}
    for w in range((nr + mGp) // 16):
        for ln in range(32):
            for nt in range(tile // 8):
                for c in range(4):
                    key = (16 * w + ln // 4 + 8 * (c // 2),
                           8 * nt + 2 * (ln % 4) + c % 2)
                    assert key not in own
                    own[key] = (w, ln, nt, c)
    return own


@pytest.mark.parametrize("tile", [16, 32])
@pytest.mark.parametrize("N", [12, 20])
def test_mixed_lane_ownership_covers_u_once(N, tile):
    """Every (row, problem) of u is one lane's register, once; a warp's
    rows are all G rows or all box rows; the accumulator-order arrays of
    t (q, d∘w_B, the K-slice partials: item v = (row tile, n8 tile, lane))
    name the same elements the box-row warps own; and the t product's
    (row tile, K slice) jobs cover every K tile of every row tile once."""
    nr, mGp = _shape16(N)
    own = _mixed_ownership(nr, mGp, tile)
    assert set(own) == {(r, p) for r in range(nr + mGp)
                        for p in range(tile)}
    for w in range((nr + mGp) // 16):
        assert len({16 * w + i >= mGp for i in range(16)}) == 1
    nt_count = tile // 8
    for v in range(nr // 16 * nt_count * 32):
        ln, nt, jt = v % 32, (v // 32) % nt_count, v // 32 // nt_count
        for c in range(4):
            j = jt * 16 + ln // 4 + 8 * (c // 2)
            p = nt * 8 + 2 * (ln % 4) + c % 2
            assert own[(mGp + j, p)] == (mGp // 16 + jt, ln, nt, c)
    warps, n_t, k_t = (nr + mGp) // 16, nr // 16, mGp // 16
    jobs = ca._mixed_jobs(nr, mGp)
    assert n_t <= jobs <= warps and jobs % n_t == 0
    ks = jobs // n_t
    cover = [(jt, kt) for job in range(jobs)
             for jt in [job // ks]
             for kt in range(job % ks * k_t // ks, (job % ks + 1) * k_t // ks)]
    assert sorted(cover) == [(jt, kt) for jt in range(n_t)
                             for kt in range(k_t)]


def test_mixed_binding_mirrors_the_kernel_source():
    """The ctypes binding of the split-precision library gives each
    exported function of ``admm_mixed.cu`` its parameters in the source's
    order (pointers as c_void_p, ints as c_int, floats as c_float), and the
    wrapper passes as many arguments."""
    from pyhybridcontrol_tpu_torch.ops import _build

    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm_mixed.cu")).read()
    src = src[src.index('extern "C" {'):]

    lib = types.SimpleNamespace(**{
        name: types.SimpleNamespace()
        for name in re.findall(r"\n\w[\w\s\*]*?\b(phc_\w+)\(", src)})
    _build._bind_admm_mixed(lib)
    kinds = {"void*": ctypes.c_void_p, "float*": ctypes.c_void_p,
             "int": ctypes.c_int, "float": ctypes.c_float}
    for name, params in re.findall(r"\n\w[\w\s\*]*?\b(phc_admm\w+)\(([^)]*)\)",
                                   src):
        want = []
        for decl in params.split(","):
            decl = decl.replace("const", "").split()
            kind = decl[0].rstrip("*") + ("*" if "*" in "".join(decl) else "")
            want.append(kinds[kind])
        assert getattr(lib, name).argtypes == want, name
    # the wrapper's call: the pointers (starred groups by their sizes), then
    # B nr mG iters alpha tile stream
    call = inspect.getsource(ca._launch_k1_mixed)
    ptrs = re.search(r"_ptr, \((.*?)\)\)", call, re.S).group(1)
    sizes = {"*w": 4, "*outs": 4, '*lay["A"]': 2, '*lay["M"]': 2}
    n_ptrs = sum(sizes.get(tok.strip(), 1) for tok in ptrs.split(",")
                 if tok.strip())
    assert n_ptrs + 7 == len(lib.phc_admm_k1_mixed.argtypes)


# ---- shapes above the shared-memory cap: the streamed variant ------------

# (n, m) of the shapes a block cannot stage, and the bytes a tile of one
# problem would need with staged constants: the double integrator at N=27,
# the reference bench's config 3 (DEWH, N=24, min-up rows, move blocking,
# soft), 4b
# (DEWH, N=24, soft), 4c (scenario tree, S=4, N=10) and 2/2b (PWA hull,
# N=20)
BIG_SHAPES = {"N27": (81, 270, 246176), "config3": (108, 239, 293248),
              "config4b": (120, 216, 285120), "config4c": (120, 444, 531424),
              "config2": (220, 680, 1477792)}


@pytest.mark.parametrize("name", sorted(BIG_SHAPES))
def test_plan_streams_the_constants_where_a_block_cannot_stage_them(name):
    """The five shapes take the streamed variant at every batch size: a
    tile of 1 below ~2 blocks per SM, else the largest whose iterates fit
    (config 2: a tile of 8 needs 238,432 bytes, so 4)."""
    n, m, staged = BIG_SHAPES[name]
    nr, mGp = -(-n // 8) * 8, -(-m // 8) * 8
    assert ca.smem_bytes(nr, mGp, 1) == staged > ca.SMEM_MAX
    for B, pb in ((1, 1), (37, 1), (300, 1),
                  (4096, 4 if name == "config2" else 8)):
        pl = ca.plan(B, nr, mGp)
        assert pl.streamed and pl.pb == pb, (B, pl)
        assert pl.smem == ca.smem_bytes(nr, mGp, pb, True) <= ca.SMEM_MAX
        assert pl.threads == 32 * ca._warps(nr, mGp, pb)
    assert ca.smem_bytes(224, 680, 8, True) == 238432 > ca.SMEM_MAX


@pytest.mark.parametrize("N", range(1, 27))
def test_plan_stages_every_shape_it_staged_before(N):
    """Up to N=26 every batch size keeps the staged instantiation it had
    (the largest staged tile that fits and leaves ~2 blocks per SM)."""
    nr, mGp = _shape(N)
    for B in (1, 32, 300, 1024, 4096):
        pl = ca.plan(B, nr, mGp)
        assert not pl.streamed
        want = next(t for t in ca.TILES
                    if ca.smem_bytes(nr, mGp, t) <= ca.SMEM_MAX
                    and (t == 1 or -(-B // t) >= 1.9 * ca.SM_COUNT))
        assert pl.pb == want and pl.smem == ca.smem_bytes(nr, mGp, want)


def _source_smem_bytes():
    """``smem_floats`` of csrc/admm.cu read from the source text and
    evaluated in Python: the helpers it calls (stride_A, stride_M,
    max_warps through the Cfg tables) and its own statements, C casts
    dropped and the ternary turned into Python's."""
    src = open(os.path.join(_REPO, "pyhybridcontrol_tpu_torch", "csrc",
                            "admm.cu")).read()
    warps = {int(t): int(w) for t, w in re.findall(
        r"struct Cfg<(\d+)> \{\s*enum \{[^}]*WARPS = (\d+)", src)}
    red = int(re.search(r"#define PHC_RED (\d+)", src).group(1))

    def body(sig):
        text = re.search(re.escape(sig) + r"\s*\{(.*?)\n\}", src,
                         re.S).group(1)
        text = re.sub(r"//[^\n]*", "", text)
        text = re.sub(r"\((size_t|int)\)", "", text).replace("const size_t",
                                                             "")
        text = re.sub(r"(\w+) \? (\w+)\s*:", r"\2 if \1 else ", text)
        stmts = [" ".join(st.split()) for st in text.split(";")
                 if st.strip()]
        return "\n".join("    " + st for st in stmts)

    code = ("def stride_A(nr):\n" + body("inline int stride_A(int nr)")
            + "\ndef stride_M(R):\n" + body("inline int stride_M(int R)")
            + "\ndef smem_floats(nr, mGp, PB, streamed):\n"
            + body("inline size_t smem_floats(int nr, int mGp, int PB,\n"
                   "                                              bool "
                   "streamed)"))
    env = dict(max_warps=warps.__getitem__, PHC_RED=red)
    exec(code, env)
    return warps, red, lambda nr, mGp, pb, st: 4 * env["smem_floats"](
        nr, mGp, pb, st)


def test_smem_bytes_follows_the_kernel_source_for_both_variants():
    """The wrapper's shared-memory reckoning and the source's
    ``smem_floats`` (what ``phc_admm_smem_bytes`` returns and the launch
    asks for) agree for staged and streamed constants, every tile, over
    the double integrator's horizons and the five large shapes."""
    warps, red, src_bytes = _source_smem_bytes()
    assert warps == ca.MAX_WARPS and red == ca._RED
    shapes = [_shape(N) for N in range(1, 61)] + [
        (-(-n // 8) * 8, -(-m // 8) * 8) for n, m, _ in BIG_SHAPES.values()]
    for nr, mGp in shapes:
        for pb in ca.TILES:
            for st in (False, True):
                assert src_bytes(nr, mGp, pb, st) == ca.smem_bytes(
                    nr, mGp, pb, st), (nr, mGp, pb, st)
    # the kernels' device layout carries the shared-memory strides
    assert src_bytes(88, 272, 1, False) - src_bytes(88, 272, 1, True) == \
        4 * (272 * ca._strides(88, 272)[0] + 88 * ca._strides(88, 272)[1])


def test_device_layout_carries_the_padded_strides(prob):
    """Â_G and Mᵀ lie in device memory with the shared-memory row strides
    (zero in the pad columns): the staged kernels copy them flat, the
    streamed ones read them in place."""
    kq = prob["kq"]
    nr, mGp = kq.n_pad, kq.m_pad
    sa, sm = ca._strides(nr, mGp)
    lay = ca._layout(kq)
    assert lay["AG"].shape == (mGp, sa)
    assert torch.equal(lay["AG"][:, :nr], kq.AGT.T)
    assert not lay["AG"][:, nr:].any() and lay["AG"].is_contiguous()
    assert set(lay["MT"]) == set(ca.B_KS.values())
    for ks, MT in lay["MT"].items():
        # Mᵀ's rows in depth_rows order: row p holds variable rows[p]
        rows = ca.depth_rows(nr, ks)
        assert MT.shape == (nr, sm) and MT.is_contiguous()
        assert torch.equal(MT[:, :mGp + nr], kq.M.T[torch.as_tensor(rows)])
        assert not MT[:, mGp + nr:].any()


@pytest.mark.parametrize("N", range(2, 28))
def test_low_frac_route_follows_the_shape(N):
    """The split-precision phase runs on the tensor cores up to N=21 and
    in K1's split mode from N=22 (staged to N=26, streamed at N=27), from
    the 16-padded shape alone, with a plan for every batch size: no shape
    is refused."""
    nr, mGp = _shape16(N)
    route = ca.split_route(nr, mGp)
    assert route == ("tensor_cores" if N <= 21 else "k1_split")
    for B in (1, 37, 4096):
        if route == "tensor_cores":
            assert ca.plan_mixed(B, nr, mGp).threads == 2 * (nr + mGp)
        else:
            with pytest.raises(ValueError):
                ca.plan_mixed(B, nr, mGp)
        assert ca.plan(B, nr, mGp).streamed == (N >= 27)


def _split_product_mirror(A, b):
    """The kernel's split-mode product, term by term as ``product<...,
    SPLIT>`` accumulates it: for each depth index c the three exact bf16
    products ah·bh, ah·bl, al·bh added in that order in fp32. A (K, O),
    b (B, K) -> (B, O)."""
    ah, al = ca._bf16_split(A)
    bh, bl = ca._bf16_split(b)
    acc = torch.zeros(b.shape[0], A.shape[1])
    for c in range(A.shape[0]):
        for x, y in ((ah, bh), (ah, bl), (al, bh)):
            acc = acc + y[:, c:c + 1] * x[c]
    return acc


def test_plain_split_mode_arithmetic_equals_mm3(prob12, rng):
    """The split mode's arithmetic (three exact bf16 products per term,
    fp32 accumulation) gives ``_mm3``'s products to fp32 rounding of the
    sum, on both products of an iteration at the N=12 shape; dropping the
    lo·hi pass is far outside that."""
    kq = ca.pad_kernel_qp(prob12["kq"])
    for A, K in ((kq.AGT.T, kq.m_pad), (kq.M.T, kq.n_pad)):
        b = torch.as_tensor(rng.normal(0, 3.0, size=(6, K)).astype(
            np.float32))
        got = _split_product_mirror(A, b)
        want = ca._mm3(A)(b)
        scale = (b.abs() @ A.abs()) * K * 2.0 ** -23
        assert bool(((got - want).abs() <= scale + 1e-30).all())
        bh, bl = ca._bf16_split(b)
        ah = ca._bf16_split(A)[0]
        two = bh @ ah + bl @ ah
        assert float((two - want).abs().max()) > 10 * float(scale.max())
    # one iteration of the plain split phase equals the same iteration
    # written with the mirror's products
    td = tuple(t[:6] for t in map(torch.as_tensor, prob12["data"]))
    qs, lG, uG, lB, uB, _ = ca._pack(kq, *td, None)
    it = ca._init_iterates(lG, uG, lB, uB, None)
    zG, yG, zB, yB = ca._mixed_plain(kq, qs, lG, uG, lB, uB, it, 1)
    alpha = kq.base.alpha
    t = (_split_product_mirror(kq.AGT.T, kq.rhoG * it[0] - it[1])
         + kq.dbox * (kq.rhoB * it[2] - it[3]) - qs)
    u = _split_product_mirror(kq.M.T, t)
    zr = alpha * u[:, kq.m_pad:] + (1 - alpha) * it[2]
    want_zB = torch.clamp(zr + it[3] * kq.rhoB_inv, lB, uB)
    np.testing.assert_allclose(zB.numpy(), want_zB.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_plain_split_precision_above_n21_passes_the_gate():
    """At N=24, where K1's split mode serves ``low_frac`` on the card, the
    plain version's split-precision solve tracks full precision within
    the reference bench's gate (max relative objective delta 1e-4) on
    seeded states."""
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import (
        prepare_admm_mpc as tprep)
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    c = CondensedMpc(switched_double_integrator(), 24, di_default_weights())
    qp = c.device_qp("cpu")
    kq = ca.kernel_qp_for(tprep(c, device="cpu"))
    assert ca.split_route(*_shape16(24)) == "k1_split"
    x0s = torch.as_tensor(np.random.default_rng(4).normal(
        size=(16, 2)).astype(np.float32))
    f, h = qp.assemble(x0s)
    args = (kq, f, h, qp.lb.expand(16, -1), qp.ub.expand(16, -1))
    full = ca.admm_solve_plain(*args, iters=100)
    lo = ca.admm_solve_plain(*args, iters=100, low_frac=1.0)
    rel = ((lo.obj - full.obj).abs() / full.obj.abs().clamp_min(1.0)).max()
    assert float(rel) <= 1e-4


def test_fp32_noise_grows_with_the_horizon():
    """Why chip_smoke holds the double integrator above the staging cap to
    a "large" regime (4× "main"): the plain version's own difference from
    the same iteration in fp64 grows with the horizon's conditioning. At
    N=27 it is over twice that at N=20 in x, and over thrice in y, on the
    same seeded states."""
    import dataclasses

    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import (
        prepare_admm_mpc as tprep)
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    def noise(N):
        c = CondensedMpc(switched_double_integrator(), N,
                         di_default_weights())
        qp = c.device_qp("cpu")
        kq = ca.kernel_qp_for(tprep(c, device="cpu"))
        kd = ca.KernelQP(**{
            f.name: (getattr(kq, f.name).double()
                     if isinstance(getattr(kq, f.name), torch.Tensor)
                     else getattr(kq, f.name))
            for f in dataclasses.fields(kq)})
        x0s = torch.as_tensor(np.random.default_rng(7).normal(
            size=(64, 2)).astype(np.float32))
        f, h = qp.assemble(x0s)
        lb, ub = qp.lb.expand(64, -1), qp.ub.expand(64, -1)
        r32 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=100)
        r64 = ca._solve_plain(kd, f.double(), h.double(), lb.double(),
                              ub.double(), 100, 0, None)
        return [float((getattr(r32, k).double() - getattr(r64, k)).abs()
                      .max()) for k in ("x", "y")]

    (x20, y20), (x27, y27) = noise(20), noise(27)
    assert x27 > 2 * x20 and y27 > 3 * y20
