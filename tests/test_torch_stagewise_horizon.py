"""K5's horizon variant on the CPU (ops/cuda_stagewise.py's plan and layout,
ops/stagewise.py's window maps and windowed sweep) against the reference's
ops/stagewise.py.

The variant cuts one scenario's horizon into C windows over a cluster's
CTAs (``horizon_windows``). Its plan is held at the long horizons it takes
over from the global variant and at the shapes it leaves to the others;
its shared memory against the kernel source. Its parallel sweep's plain
version, ``_solve_K_windowed`` (every window from a zero carry, the
carries through the window maps Π and Ψ, then the correction), is held
against the port's ``_solve_K`` and the reference's ``_solve_K`` and
``_solve_K_assoc`` on the same factors: 1e-10 relative in fp64 (the
products are exact to rounding; the window maps' norms stay below 1 at
these preps, so nothing grows), and 1e-5 relative in fp32 against the
fp32 ``_solve_K`` (the same factors, sums in another order). The ADMM
loop around it is held against the reference's
``stagewise_admm_solve(parallel_sweeps=True)`` as tests/test_torch_
stagewise.py holds the plain loop (x, z, y within 1e-3, relative with
floor 1). The kernel itself runs only on the card (``chip_smoke.py``
phase 35)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
import pyhybridcontrol_tpu.models.pwa_examples as jpwa
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

torch.set_num_threads(2)

SRC = os.path.join(os.path.dirname(__file__), "..",
                   "pyhybridcontrol_tpu_torch", "csrc", "stagewise.cu")

# the horizons the global variant took (b, m of the double integrator and
# of the PWA hull model): the plan's shape, the problems of a launch
LONG = {"di_N704": (704, 5, 17), "di_N1000": (1000, 5, 17),
        "di_N3000": (3000, 5, 17), "hull_N248": (248, 13, 49),
        "hull_N300": (300, 13, 49), "hull_N1000": (1000, 13, 49)}


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))
    assert err <= tol, f"error {err:.3e} above {tol:.1e}"


@pytest.mark.parametrize("P", [8, 64])
@pytest.mark.parametrize("key", list(LONG))
def test_horizon_plan_takes_the_long_horizons(key, P):
    """Where the plan picked the global variant (one scenario, no extra
    rows, bmax 8 or 16) it picks the horizon one: C of HORIZON_CLUSTERS,
    the most whose P·C CTAs fit the reckoned wave (planned without a card;
    on one, its occupancy), else the fewest whose window
    fits; the window's lanes in one round of the CTA's threads; the shared
    memory of ``horizon_smem_bytes`` within SMEM_MAX; staged factors where
    they fit. The global variant stays reachable, forced, as the parent
    planned it; ``parallel`` plans the same instantiation with the
    parallel sweep."""
    N, b, m = LONG[key]
    pl = cs.plan_admm(P, N, b, m)
    assert pl.variant == "horizon" and not pl.parallel
    assert pl.library == "stagewise_horizon"
    assert cs.ADMM_LAUNCH[pl.variant] == "stagewise_k5_horizon"
    assert pl.cluster in cs.HORIZON_CLUSTERS and pl.spc == 1
    assert pl.bmax == (8 if b <= 8 else 16) and pl.ext == 0 and pl.ring == 0
    nw = -(-N // pl.cluster)
    assert 32 * pl.warps <= cs.ADMM_THREADS[pl.bmax]
    assert nw * pl.tps <= 32 * pl.warps or pl.tps == 1
    assert pl.smem == cs.horizon_smem_bytes(N, b, m, pl.staged, pl.bmax,
                                            pl.cluster) <= ca.SMEM_MAX
    one_wave = [C for C in cs.HORIZON_CLUSTERS
                if P * C <= cs.HORIZON_WAVE
                and cs.horizon_smem_bytes(N, b, m, False, pl.bmax, C)
                <= ca.SMEM_MAX]
    assert pl.cluster == (one_wave[0] if one_wave else min(
        C for C in cs.HORIZON_CLUSTERS
        if cs.horizon_smem_bytes(N, b, m, False, pl.bmax, C)
        <= ca.SMEM_MAX))
    assert pl.staged == (cs.horizon_smem_bytes(N, b, m, True, pl.bmax,
                                               pl.cluster) <= ca.SMEM_MAX)
    glob = cs.plan_admm(P, N, b, m, variant="global")
    assert (glob.variant, glob.spc, glob.cluster) == ("global", 1, 1)
    par = cs.plan_admm(P, N, b, m, parallel=True)
    assert par == cs.AdmmPlan(**{**pl.__dict__, "parallel": True})


def test_horizon_plan_at_long_horizons_wave():
    """``long_horizon``'s waves (8 nodes): eight windows a problem, the
    factors staged, four lanes a stage (chip_smoke.py's path shapes)."""
    di = cs.plan_admm(8, 1000, 5, 17)
    hull = cs.plan_admm(8, 300, 13, 49)
    assert (di.cluster, di.staged, di.tps, di.warps) == (8, True, 4, 16)
    assert (hull.cluster, hull.staged, hull.tps, hull.warps) == (8, True, 4,
                                                                 5)


# the card's clusters at once (cudaOccupancyMaxActiveClusters) by C, the
# problems of a launch, and the C the plan should pick: the most whose P
# clusters the card holds at once, else the fewest whose window fits
HELD = {
    "di_one_wave_at_8": ("di_N1000", {8: 15, 4: 31, 2: 64}, 8, 8),
    "di_fewer_clusters_of_8": ("di_N1000", {8: 7, 4: 31, 2: 64}, 8, 4),
    "di_only_pairs": ("di_N1000", {8: 7, 4: 7, 2: 64}, 8, 2),
    "di_no_wave_fits": ("di_N1000", {8: 15, 4: 31, 2: 64}, 100, 2),
    "hull_one_wave_at_8": ("hull_N300", {8: 15, 4: 31, 2: 64}, 8, 8),
    "hull_no_wave_fits": ("hull_N300", {8: 1, 4: 1, 2: 1}, 8, 2),
    "hull_N1000_only_8_fits": ("hull_N1000", {8: 1}, 8, 8),
    "di_N3000_only_8_fits": ("di_N3000", {8: 15}, 64, 8),
}


@pytest.mark.parametrize("key", list(HELD))
def test_horizon_plan_reads_the_cards_occupancy(monkeypatch, key):
    """Planned for a CUDA device, the horizon variant's cluster follows the
    card's occupancy (``horizon_capacity``, asked once per candidate plan
    that fits, here a stand-in): the most CTAs a problem whose P clusters
    the card holds at once, else the fewest whose window fits; the
    sequential and the parallel plan alike. Without a device the plan
    keeps the reckoned wave (HORIZON_WAVE CTAs)."""
    shape, held, P, want = HELD[key]
    N, b, m = LONG[shape]
    asked = []

    def capacity(N_, b_, m_, pl, device):
        assert (N_, b_, m_) == (N, b, m) and device.type == "cuda"
        assert pl.smem <= ca.SMEM_MAX
        asked.append(pl.cluster)
        return held[pl.cluster]

    monkeypatch.setattr(cs, "horizon_capacity", capacity)
    dev = torch.device("cuda")
    pl = cs.plan_admm(P, N, b, m, device=dev)
    assert pl.variant == "horizon" and pl.cluster == want
    assert set(asked) <= set(held)
    par = cs.plan_admm(P, N, b, m, parallel=True, device=dev)
    assert par == cs.AdmmPlan(**{**pl.__dict__, "parallel": True})
    assert cs.plan_admm(P, N, b, m) == cs.horizon_plan(P, N, b, m)


def test_horizon_capacity_mirrors_the_kernel_source():
    """The occupancy query the plan reads exists in the kernel source with
    the arguments ``horizon_capacity`` passes (the args, warps, lanes,
    staged, bmax, C), and asks for a grid of one cluster."""
    src = " ".join(open(SRC).read().split())
    assert ("int phc_sw_admm_horizon_max_clusters(const PhcSwAdmmArgs* a, "
            "int warps, int tps, int staged, int bmax, int C)") in src
    assert "cfg.gridDim = dim3((unsigned)h.C, 1, 1);" in src
    assert "cudaOccupancyMaxActiveClusters(max_clusters," in src


def _route_prep(feature):
    """A small double integrator prep (N=12) with ``feature``'s rows."""
    import pyhybridcontrol_tpu_torch.models.double_integrator as tdi

    model, N = tdi.switched_double_integrator(), 12
    kw = {}
    if feature == "extra":
        A = np.zeros((1, N * model.info.nv))
        A[0, 0::model.info.nv] = 1.0
        kw["extra"] = (A, np.array([3.0]))
    elif feature == "mean":
        kw["consensus"] = 1
    return tsw.prepare_stagewise(model, N, tdi.default_weights(),
                                 device="cpu", **kw)


@pytest.mark.parametrize("feature", ["mean_over_ranks"])
def test_parallel_sweeps_on_the_card_refuse_other_shapes(monkeypatch,
                                                         feature):
    """On a CUDA device ``parallel_sweeps=True`` with a group mean over
    ranks (``consensus_M`` a function), which raised until K6 took it,
    routes to the torch loop with K6's windowed sweep: neither K5 nor a
    kernel is launched while the route decides, and the CPU keeps the
    reference's ``_solve_K_assoc``. (Extra rows and a group mean on one
    card reach K5's parallel sweep: tests/test_torch_stagewise_parallel.py;
    the other shapes K5 has no instantiation for:
    tests/test_torch_stagewise_any.py.)"""
    monkeypatch.setattr(tsw, "sw_admm_cuda",
                        lambda *a, **k: pytest.fail("K5 reached"))
    monkeypatch.setattr(cs, "sw_solve_k_any_cuda",
                        lambda *a, **k: pytest.fail("K6 launched"))
    ts = _route_prep("mean")
    M = lambda s: s                                         # noqa: E731
    assert feature == "mean_over_ranks"
    assert tsw._admm_route(ts, torch.device("cuda"), True, M) == (
        tsw._admm_iterations, dict(sweep=tsw._k6_windowed_sweep))
    fn, kw = tsw._admm_route(ts, torch.device("cpu"), True, M)
    assert (fn, kw) == (tsw._admm_iterations, dict(sweep=tsw._solve_K_assoc))


@pytest.mark.parametrize("parallel", [False, True])
def test_admm_route_at_a_horizon_shape(monkeypatch, parallel):
    """At a shape the horizon variant takes, a CUDA device routes to one K5
    launch (the parallel sweep with ``parallel_sweeps``), a CPU device to
    the plain loop with the reference's sweep; another device raises."""
    ts = _route_prep("plain")
    assert tsw._admm_route(ts, torch.device("cuda"), parallel) == (
        tsw.sw_admm_cuda, dict(parallel=True) if parallel else {})
    assert tsw._admm_route(ts, torch.device("cpu"), parallel) == (
        tsw._admm_iterations,
        dict(sweep=tsw._solve_K_assoc if parallel else tsw._solve_K))
    with pytest.raises(ValueError, match="no stagewise ADMM for device"):
        tsw._admm_route(ts, torch.device("meta"), parallel)


# shapes the horizon variant leaves to the others: (P, N, b, m, S, n_blk,
# n_ext, n_cons, mean) and the variant the plan keeps
LEFT = {
    "di_N1000_one_extra_row": ((8, 1000, 5, 17, 1, 0, 1), "global"),
    "hull_N300_two_extra_rows": ((8, 300, 13, 49, 1, 0, 2), "global"),
    "di_N1000_runtime_r": ((8, 1000, 5, 17, 1, 0, 6), "global"),
    "tree_S16": ((128, 120, 5, 19, 16, 0, 1, 2, True), "grouped"),
    "tree_S8_N1000": ((64, 1000, 5, 19, 8, 0, 1, 2, True), "global"),
    "fleet8_b32": ((8, 96, 32, 122, 1, 0, 20), "global"),
    "config6_long_arm": ((64, 120, 5, 19, 8, 0, 1, 2, True), "shared"),
    "di_N4000": ((64, 4000, 5, 17), "global_all"),
    "served_di_N10": ((32, 10, 5, 17), "shared"),
}


@pytest.mark.parametrize("key", list(LEFT))
def test_horizon_plan_leaves_the_other_shapes(key):
    """Extra rows, a group mean, b above 16 or a shape the global variant
    did not get plan as before (the variant and its fields equal to the
    plan forced to that variant); the parallel sweep runs in the horizon
    variant where that takes the shape, else inside the plan's variant
    (its windows from the slot's warps), and the horizon variant forced
    refuses the shapes it does not take."""
    shape, want = LEFT[key]
    pl = cs.plan_admm(*shape)
    assert pl.variant == want and not pl.parallel
    assert pl == cs.plan_admm(*shape, variant=want)
    pp = cs.plan_admm(*shape, parallel=True)
    b, S = shape[2], (shape[4] if len(shape) > 4 else 1)
    n_ext = shape[6] if len(shape) > 6 else 0
    mean = shape[8] if len(shape) > 8 else False
    if cs.horizon_applies(b, S, mean, n_ext):
        assert pp.variant == "horizon" and pp.parallel
    else:
        assert pp.variant == want and pp.parallel and pp.windows >= 2
        with pytest.raises(ValueError, match="horizon variant takes"):
            cs.plan_admm(*shape, variant="horizon", parallel=True)


@pytest.mark.parametrize("N,C", [(1, 1), (2, 2), (7, 4), (37, 8), (300, 8),
                                 (1000, 8), (1000, 2), (3000, 8), (10, 4)])
def test_horizon_windows_cover_the_horizon(N, C):
    """The windows cover stages 0 … N−1 once, in order, each ⌊N/C⌋ or
    ⌈N/C⌉ stages (none empty), within the layout's ⌈N/C⌉; the kernel's
    hz_lo is the same c·N div C."""
    w = cs.horizon_windows(N, C)
    assert len(w) == C + 1 and w[0] == 0 and w[-1] == N
    sizes = [e - s for s, e in zip(w[:-1], w[1:])]
    assert set(sizes) <= {N // C, -(-N // C)} and min(sizes) >= 1
    assert sum(sizes) == N and max(sizes) <= -(-N // C)
    assert "return (int)((long long)c * N / C);" in open(SRC).read()


def test_horizon_smem_mirrors_the_kernel_source():
    """``horizon_smem_bytes`` mirrors ``horizon_layout`` array by array
    (windows of ⌈N/C⌉ stages, each array padded to a multiple of 4 words),
    the exports and bindings are there, and the dispatch takes clusters
    of 1, 2, 4 or 8 at bmax 8 and 16 without a group mean or extra rows."""
    src = open(SRC).read()
    for line in (
            "const size_t f = staged ? pad4((size_t)nw * b * b) : 0;",
            "const size_t zn = pad4((size_t)m * nw), tn = pad4((size_t)nw * b);",
            "const size_t vn = pad4(b);",
            "a.bar = o; o += 4;",
            "a.J = o; o += pad4((size_t)m * bmax);",
            "a.Mc = o; o += pad4((size_t)m * bmax);",
            "a.u = o; o += zn;",
            "a.xb = o; o += tn;",
            "a.px = o; o += vn;",
            "a.cm = o; o += pad4((size_t)2 * C * b * b);",
            "a.vb = o; o += pad4((size_t)C * b);",
            "horizon_layout((N + C - 1) / C, b, m, staged, bmax, C).total;",
            "!(h.C == 1 || h.C == 2 || h.C == 4 || h.C == 8) || h.C > a->N",
            "a->n_ext || a->ext || bmax > 16 ||",
            "#define PHC_SW_PART 3"):
        assert line in src or line in open(SRC.replace(
            "stagewise.cu", "stagewise_horizon.cu")).read(), line
    # the double integrator at N=1000 over 8 windows of 125 stages: the
    # barriers 4, the factors 3·3128 (3125 padded), J/Mc 2·136, z/y/l/u
    # 4·2128 (2125 padded), t/mb/x 3·628 (625 padded), 5·8 vectors, the
    # carries' maps 2·8·25 and the peers' vectors 8·5
    assert cs.horizon_smem_bytes(1000, 5, 17, True, 8, 8) == \
        4 * (4 + 3 * 3128 + 2 * 136 + 4 * 2128 + 3 * 628 + 5 * 8 + 400 + 40)
    assert cs.horizon_smem_bytes(1000, 5, 17, False, 8, 8) == \
        4 * (4 + 2 * 136 + 4 * 2128 + 3 * 628 + 5 * 8 + 400 + 40)
    bind = open(os.path.join(os.path.dirname(SRC), "..", "ops",
                             "_build.py")).read()
    for fn in ("phc_sw_admm_horizon_smem_bytes", "phc_sw_admm_horizon",
               "phc_sw_admm_horizon_max_clusters"):
        assert f"\nint {fn}(" in src
        assert f"lib.{fn}.argtypes" in bind
    assert cs.HORIZON_CLUSTERS == (8, 4, 2)
    assert "stagewise_k5_horizon" in ca.LAUNCHES


def _di_prep(N):
    js = jsw.prepare_stagewise(jdi.switched_double_integrator(), N,
                               jdi.default_weights())
    return js, convert.stagewise_qp(js, "cpu")


def _hull_prep(N):
    js = jsw.prepare_stagewise(
        jpwa.pwa_spring_mld(on_off=True, formulation="hull"), N,
        jpwa.pwa_weights())
    return js, convert.stagewise_qp(js, "cpu")


PREPS = {"di": _di_prep, "hull": _hull_prep}


@pytest.mark.parametrize("model,N,C", [("di", 64, 4), ("hull", 40, 8),
                                       ("di", 13, 8), ("hull", 9, 2)])
def test_window_maps_are_the_windows_products(model, N, C):
    """Π_k and Ψ_k against the fp64 products of the factors taken
    directly (numpy, in their own order): equal to 1e-12 relative; the
    first window's Π and the last window's Ψ are zero (L_0 = 0, C_{N−1} =
    0); their largest norm (printed) stays below 1 at these preps."""
    _, ts = PREPS[model](N)
    sw64 = tsw.stagewise_double(ts)
    w = cs.horizon_windows(N, C)
    Pi, Psi = (a.numpy() for a in tsw.window_maps(sw64, w))
    L, _, Cf = (f.numpy() for f in sw64.factors)
    for s, e in zip(w[:-1], w[1:]):
        for k in range(s, e):
            want = np.eye(ts.b)
            for j in range(s, k + 1):
                want = -L[j] @ want
            _close(Pi[k], want, 1e-12)
            want = np.eye(ts.b)
            for j in range(e - 1, k - 1, -1):
                want = -Cf[j] @ want
            _close(Psi[k], want, 1e-12)
    assert not Pi[:w[1]].any() and not Psi[w[-2]:].any()
    norm = max(np.linalg.norm(Pi, 2, axis=(1, 2)).max(),
               np.linalg.norm(Psi, 2, axis=(1, 2)).max())
    print(f"{model} N={N} C={C}: max ‖Π_k‖, ‖Ψ_k‖ = {norm:.4f}")
    assert norm < 1.0


@pytest.mark.parametrize("model,N,C", [("di", 64, 4), ("hull", 40, 8)])
def test_windowed_sweep_matches_both_packages(model, N, C):
    """``_solve_K_windowed`` on the same factors as the port's
    ``_solve_K`` and the reference's ``_solve_K`` and ``_solve_K_assoc``:
    in fp64 within 1e-10 relative (floor 1) of each; in fp32 (the prep's
    factors) within 1e-5 of the port's fp32 ``_solve_K``."""
    js, ts = PREPS[model](N)
    rng = np.random.default_rng(N)
    r = rng.normal(size=(3, N, ts.b))
    w = cs.horizon_windows(N, C)
    sw64 = tsw.stagewise_double(ts)
    got = tsw._solve_K_windowed(sw64, torch.as_tensor(r), w).numpy()
    _close(got, tsw._solve_K(sw64, torch.as_tensor(r)).numpy(), 1e-10)
    f64 = tuple(jnp.asarray(f.numpy()) for f in sw64.factors)
    with jax.enable_x64(True):
        f64 = tuple(jnp.asarray(f.numpy()) for f in sw64.factors)
        rj = jnp.asarray(r)
        for ref in (jsw._solve_K, jsw._solve_K_assoc):
            want = np.asarray(ref(js, rj, factors=f64))
            assert want.dtype == np.float64
            _close(got, want, 1e-10)
    r32 = torch.as_tensor(r, dtype=torch.float32)
    _close(tsw._solve_K_windowed(ts, r32, w).numpy(),
           tsw._solve_K(ts, r32).numpy(), 1e-5)


@pytest.mark.parametrize("model,N,C", [("di", 24, 4), ("hull", 16, 8)])
def test_windowed_admm_matches_reference_parallel_sweeps(model, N, C):
    """The plain version of K5's parallel sweep, ``_admm_iterations`` with
    ``_solve_K_windowed``, 120 iterations from cold against the reference's
    ``stagewise_admm_solve(parallel_sweeps=True)`` on its prep carried
    across: x, z and y within 1e-3 (relative, floor 1), as
    tests/test_torch_stagewise.py holds the plain loop."""
    js, ts = PREPS[model](N)
    x0 = np.array([1.0, 0.0], np.float32)
    jd = jsw.assemble_stagewise(js, jnp.asarray(x0))
    q, l, u = tsw.assemble_stagewise(ts, torch.as_tensor(x0))
    jr = jsw.stagewise_admm_solve(js, *jd, iters=120, parallel_sweeps=True)
    w = cs.horizon_windows(N, C)
    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    got = tsw._admm_iterations(
        ts, q, l, u, x, z, y, None, None, None, 120,
        sweep=lambda s, t: tsw._solve_K_windowed(s, t, w))
    for g, want in zip(got[:3], (jr.x, jr.z, jr.y)):
        _close(g.numpy(), want, 1e-3)


def test_parallel_sweeps_dispatch_on_the_cpu(monkeypatch):
    """On a CPU tensor ``parallel_sweeps=True`` stays the reference's
    algorithm, the torch loop with ``_solve_K_assoc``, at a shape the
    horizon variant takes on the card; it never reaches K5."""
    monkeypatch.setattr(tsw, "sw_admm_cuda",
                        lambda *a, **k: pytest.fail("CPU path reached K5"))
    seen = []
    orig = tsw._admm_iterations

    def spy(*a, **kw):
        seen.append(kw["sweep"])
        return orig(*a, **kw)

    monkeypatch.setattr(tsw, "_admm_iterations", spy)
    _, ts = _di_prep(12)
    assert cs.horizon_applies(ts.b)
    q, l, u = tsw.assemble_stagewise(ts, torch.as_tensor([1.0, 0.0]))
    tsw.stagewise_admm_solve(ts, q, l, u, iters=3, parallel_sweeps=True)
    assert seen == [tsw._solve_K_assoc]


@pytest.mark.cuda
@pytest.mark.parametrize("parallel", [False, True])
def test_k5_horizon_matches_its_plain_versions_on_the_card(parallel):
    """On the card the horizon variant launches once (counted under its
    name) and agrees with its plain version (the plain loop with
    ``_solve_K``, or with ``_solve_K_windowed`` on its windows), 60
    iterations cold at the double integrator N=40 over 4 windows, within
    1e-3 (relative, floor 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import pyhybridcontrol_tpu_torch.models.double_integrator as tdi

    ts = tsw.prepare_stagewise(tdi.switched_double_integrator(), 40,
                               tdi.default_weights(), device="cuda")
    q, l, u = tsw.assemble_stagewise(ts, torch.tensor([1.0, 0.0],
                                                      device="cuda"))
    q, l, u = (a.expand((8,) + a.shape).contiguous() for a in (q, l, u))
    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    ca.reset_launch_counts()
    got = cs.sw_admm_cuda(ts, q, l, u, x, z, y, None, None, None, 60,
                          variant="horizon", parallel=parallel)
    assert ca.LAUNCHES["stagewise_k5_horizon"] == 1
    pl = cs.plan_admm(8, 40, ts.b, ts.m_k, variant="horizon")
    w = cs.horizon_windows(40, pl.cluster)
    sweep = ((lambda s, t: tsw._solve_K_windowed(s, t, w)) if parallel
             else tsw._solve_K)
    want = tsw._admm_iterations(ts, q, l, u, x, z, y, None, None, None, 60,
                                sweep=sweep)
    for g, w_ in zip(got[:4], want[:4]):
        _close(g.cpu().numpy(), w_.cpu().numpy(), 1e-3)


def _phase_stamps():
    """tools/k5_phases.py's stamp sets by mode (the tool patches a copy of
    the kernel source with them; each anchor must occur once)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "k5_phases", os.path.join(os.path.dirname(__file__), "..", "tools",
                                  "k5_phases.py"))
    k = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k)
    decl = (k.STAMPS[0][0], k.STAMPS[0][1].replace(
        "namespace {", "__device__ long long g_sw[3];\nnamespace {"))
    return {"default": k.STAMPS, "wide": k.WIDE_STAMPS,
            "flex": [decl] + k.STAMPS[1:] + k.SWEEP_STAMPS,
            "horizon": k.HORIZON_STAMPS}


@pytest.mark.parametrize("mode", ["default", "wide", "flex", "horizon"])
def test_k5_phase_stamps_fit_the_kernel_source(mode):
    """Every anchor of tools/k5_phases.py's stamps occurs exactly once in
    csrc/stagewise.cu, in order of application (the tool raises on the
    card otherwise, after building everything else)."""
    src = open(SRC).read()
    for old, new in _phase_stamps()[mode]:
        assert src.count(old) == 1, old[:80]
        src = src.replace(old, new)
