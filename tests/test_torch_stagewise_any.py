"""K6, the stagewise sweep at any block size and over windows, on the CPU:
its plain versions at block sizes past K4's and K5's (b > 128) against the
JAX package, the route that sends the shapes K5 has no instantiation for
to the torch loop with K4's or K6's sweep, and the solves such shapes run
(a fleet of 33–40 batteries, b = 132–160; a tree of S = 272 scenarios)
against the JAX package.

Inputs come from numpy seeds and go to both packages. Tolerances: the
sweeps as tests/test_torch_stagewise_horizon.py states them (1e-10
relative, floor 1, in fp64 against the reference's ``_solve_K`` and
``_solve_K_assoc`` on the same factors; 1e-5 in fp32 against the port's
fp32 ``_solve_K``); the solves as tests/test_torch_stagewise.py holds the
plain loop (objective 1e-4 relative, x, z, y and the extra rows' z and y
1e-3, relative with floor 1). The kernel itself runs only on the card
(``chip_smoke.py``, "K6 vs plain")."""

import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.mld.compose import aggregate_mld as j_aggregate
from pyhybridcontrol_tpu.mld.info import MldInfo as JInfo
from pyhybridcontrol_tpu.mld.model import MldModel as JModel
from pyhybridcontrol_tpu.models.battery import BatteryParams as JParams
from pyhybridcontrol_tpu.models.battery import battery_model as j_battery
from pyhybridcontrol_tpu.models.battery import battery_weights as j_bw
from pyhybridcontrol_tpu.models.grid import default_tou_profile as j_tou
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu.ops import stagewise_tree as jst
from pyhybridcontrol_tpu.ops.condense import MpcWeights as JWeights
from pyhybridcontrol_tpu.ops.scenario_tree import ScenarioTree as JTree
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst

torch.set_num_threads(2)

CUDA = torch.device("cuda")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _chip_smoke()


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))
    assert err <= tol, f"error {err:.3e} above {tol:.1e}"


def _factors(N, b, seed):
    """(L, U⁻¹, C) in fp64 of ``chip_smoke.random_factors``' random
    symmetric positive definite block-tridiagonal K (the card's holds'
    recipe)."""
    return SMOKE.random_factors(np.random.default_rng(seed), N, b, "cpu",
                                torch.float64)


# (b, N, C): b past K4's and K5's 128 (odd ones included), N not a
# multiple of C where C > 1
SWEEPS = [(129, 5, 2), (137, 6, 4), (160, 3, 1), (160, 5, 3), (129, 4, 1)]


@pytest.mark.parametrize("b,N,C", SWEEPS)
def test_sweeps_past_128_match_both_packages(b, N, C):
    """The plain versions of K6 (``_solve_K`` for C = 1,
    ``_solve_K_windowed`` on ``horizon_windows(N, C)`` else) on random
    factors at b > 128 against the reference's ``_solve_K`` and
    ``_solve_K_assoc`` on the same fp64 factors (1e-10), and in fp32
    against the port's fp32 ``_solve_K`` (1e-5)."""
    f64 = _factors(N, b, seed=b + N)
    r = np.random.default_rng(C).normal(size=(3, N, b))
    w = cs.horizon_windows(N, C)

    def plain(rr, f):
        return (tsw._solve_K(None, rr, f) if C == 1
                else tsw._solve_K_windowed(None, rr, w, f))

    got = plain(torch.as_tensor(r), f64).numpy()
    with jax.enable_x64(True):
        jf = tuple(jnp.asarray(f.numpy()) for f in f64)
        for ref in (jsw._solve_K, jsw._solve_K_assoc):
            want = np.asarray(ref(None, jnp.asarray(r), factors=jf))
            assert want.dtype == np.float64
            _close(got, want, 1e-10)
    f32 = tuple(f.float() for f in f64)
    r32 = torch.as_tensor(r, dtype=torch.float32)
    _close(plain(r32, f32).numpy(), tsw._solve_K(None, r32, f32).numpy(),
           1e-5)


def test_any_plan_takes_every_block_size():
    """K6's launch: b rounded up to a warp (at most 256 threads), C = 1 or
    ``any_windows(N)`` (⌈√(2N)⌉, at most 16 and N), four b-word vectors of
    shared memory; it raises only where those do not fit a CTA, where C is
    not 1 to N, and on an empty shape. K4's and K5's plans still raise at
    b = 129."""
    assert [cs.any_windows(N) for N in (1, 2, 3, 8, 24, 96, 120, 1000)] == [
        1, 2, 3, 4, 7, 14, 16, 16]
    for b, threads in ((1, 32), (5, 32), (33, 64), (129, 160), (160, 160),
                       (256, 256), (1000, 256)):
        pl = cs.plan_sweep_any(7, 24, b)
        assert (pl.threads, pl.windows, pl.smem) == (threads, 1, 16 * b)
        assert cs.plan_sweep_any(7, 24, b, cs.any_windows(24)).windows == 7
    assert cs.plan_sweep_any(1, 5, 160, 5).windows == 5
    for C in (6, 0):
        with pytest.raises(ValueError, match="windows, not 1 to N"):
            cs.plan_sweep_any(1, 5, 160, C)
    assert cs.plan_sweep_any(1, 3, cs.SMEM_MAX // 16).smem <= cs.SMEM_MAX
    with pytest.raises(ValueError, match="b=14529.*shared memory"):
        cs.plan_sweep_any(1, 3, 14529)
    with pytest.raises(ValueError, match="empty shape"):
        cs.plan_sweep_any(0, 3, 5)
    with pytest.raises(ValueError, match="above the 128"):
        cs.plan_admm(8, 24, 129, 500)
    with pytest.raises(ValueError, match="above the 128"):
        cs.plan_sweep(8, 24, 129)
    assert cs.k5_plan(24, 129, 500) is None and cs.k4_plan(24, 129) is None


def test_any_smem_mirrors_the_kernel_source():
    """``any_smem_bytes`` (16·b) and the CTA's thread bound mirror
    csrc/stagewise_any.cu (smem_bytes: four b-word vectors; kMaxThreads)."""
    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "pyhybridcontrol_tpu_torch", "csrc",
                            "stagewise_any.cu")).read()
    assert "return sizeof(float) * 4 * (size_t)b;" in src
    assert f"constexpr int kMaxThreads = {cs.ANY_THREADS};" in src
    assert cs.any_smem_bytes(160) == 4 * 4 * 160


def test_k6_wrapper_refuses_a_cpu_tensor():
    """On a CPU tensor the wrapper raises (the plain versions are what a CPU
    tensor runs) and counts nothing."""
    before = dict(ca.LAUNCHES)
    f = tuple(t.float() for t in _factors(3, 129, 0))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        cs.sw_solve_k_any_cuda(torch.zeros(2, 3, 129), f)
    assert ca.LAUNCHES == before


def test_k6_wrapper_needs_the_window_maps():
    """Over more than one window the wrapper takes the prep's packed window
    maps (``any_maps``) and builds none of its own: without them it raises,
    before any launch, and counts nothing."""
    before = dict(ca.LAUNCHES)
    f = tuple(t.float() for t in _factors(3, 129, 0))
    with pytest.raises(ValueError, match="need the window maps"):
        cs.sw_solve_k_any_cuda(torch.zeros(2, 3, 129), f, windows=3)
    assert ca.LAUNCHES == before


def test_route_plans_are_memoized():
    """``k5_plan`` and ``k4_plan``, which the route asks on every solve,
    are memoized and give what the plans give: K5's at P = S (None where
    it has no instantiation), K4's at any P."""
    args = (120, 5, 19, 4, 0, 1, 2, True, False)
    first = cs.k5_plan(*args)
    hits = cs.k5_plan.cache_info().hits
    assert cs.k5_plan(*args) is first and first == cs.plan_admm(
        4, *args[:-1], parallel=args[-1])
    assert cs.k5_plan.cache_info().hits == hits + 1
    assert cs.k5_plan(24, 160, 602, 1, 0, 43) is None
    assert cs.k4_plan(24, 128) == cs.plan_sweep(8, 24, 128)
    assert cs.k4_plan(24, 160) is None and cs.k4_plan(24, 128) is \
        cs.k4_plan(24, 128)


def test_k6_bound_counts_the_functions_own_work():
    """K6's bound (chip_smoke.py "K6 vs plain") is ``k4_work``, K⁻¹r's own
    bytes and operations, in both modes; over windows the maps, the
    carries and the corrections go to a bound of their own
    (``k6_windowed_bound_ms``), which ``par_overhead`` shares with K5's
    parallel sweep."""
    P, N, b, C = 8, 24, 160, cs.any_windows(24)
    own = SMOKE.bound(*SMOKE.k4_work(P, N, b))[0]
    nbytes, ops = SMOKE.window_overhead(P, N, b, C)
    w = cs.horizon_windows(N, C)
    fwd, bwd = N - w[1], w[C - 1]
    assert nbytes == 4 * (fwd + bwd + 2) * b * b
    assert ops["fp32"] == P * (2 * (C - 1) + fwd + bwd) * (2 * b * b + b)
    assert SMOKE.window_overhead(P, N, b, 1) == (0, dict(fp32=0))
    assert SMOKE.k6_windowed_bound_ms(P, N, b, C) > own
    assert SMOKE.k6_windowed_bound_ms(P, N, b, 1) == own


def _shape(N, b, m, n_ext=0, n_cons=0, n_blk=0):
    """The fields of a stagewise prep the route reads."""
    return types.SimpleNamespace(N=N, b=b, m_k=m, n_ext=n_ext,
                                 n_cons=n_cons, n_blk=n_blk)


def _no_launch(monkeypatch):
    """Every kernel wrapper and the plain loop fail if the route called
    one: the route decides from the shapes before any launch."""
    for mod, name in ((cs, "sw_solve_k_any_cuda"), (cs, "sw_solve_k_cuda"),
                      (cs, "sw_admm_cuda")):
        monkeypatch.setattr(mod, name, lambda *a, **k: pytest.fail(
            "a kernel or its launch plan was reached"))


def _over_ranks(s):
    """A group mean whose scenario axis is split over ranks (a function)."""
    return s


# (what, the prep's shape, the group of S scenarios with a mean, or
# "ranks" for a group mean over ranks): the shapes K5 has no
# instantiation for
NO_K5 = {
    "b129": (_shape(24, 129, 500, n_ext=33), None),
    "b160_fleet": (_shape(24, 160, 602, n_ext=43), None),
    "tree_S272_b5": (_shape(3, 5, 19, n_ext=1, n_cons=2), 272),
    "tree_S130_b20": (_shape(24, 20, 76, n_ext=4, n_cons=8), 130),
    "ranks_b5": (_shape(120, 5, 19, n_ext=1, n_cons=2), "ranks"),
}


@pytest.mark.parametrize("key", list(NO_K5))
@pytest.mark.parametrize("parallel", [False, True])
def test_route_takes_the_torch_loop_where_k5_has_no_plan(monkeypatch, key,
                                                         parallel):
    """On a CUDA device, where K5 has no instantiation (b > 128; a tree
    whose group would leave a scenario under a warp, S = 272 at b = 5 and
    S = 130 at b = 20; a group mean over ranks) the route is the torch
    loop with a hand-written sweep: K6 over windows with
    ``parallel_sweeps``; sequential, K4 where its plan takes the shape (b
    up to 128), K6 above. The CPU keeps the plain sweeps."""
    _no_launch(monkeypatch)
    sw, S = NO_K5[key]
    M = (_over_ranks if S == "ranks"
         else None if S is None else torch.zeros(S, S, sw.N))
    if S != "ranks":
        assert cs.k5_plan(sw.N, sw.b, sw.m_k, S or 1, 0, sw.n_ext,
                          sw.n_cons, S is not None, parallel) is None
    want = (tsw._k6_windowed_sweep if parallel
            else tsw._k4_sweep if sw.b <= 128 else tsw._k6_sweep)
    assert tsw._admm_route(sw, CUDA, parallel, M) == (
        tsw._admm_iterations, dict(sweep=want))
    assert tsw._admm_route(sw, torch.device("cpu"), parallel, M) == (
        tsw._admm_iterations,
        dict(sweep=tsw._solve_K_assoc if parallel else tsw._solve_K))


# the shapes of today's K5 paths (chip_smoke.py): (N, b, m, S with a
# group mean or 1, n_ext, n_cons), each with K5's plan before this route
K5_PATHS = {
    "config6_long": (120, 5, 19, 8, 1, 2),
    "config6_parity": (4, 5, 19, 2, 0, 2),
    "serve_di": (10, 5, 17, 1, 0, 0),
    "long_horizon_di": (1000, 5, 17, 1, 0, 0),
    "long_horizon_hull": (300, 13, 49, 1, 0, 0),
    "wide_tree_S16": (120, 5, 19, 16, 1, 2),
    "wide_tree_S27": (120, 5, 19, 27, 1, 2),
    "wide_tree_S64": (120, 5, 19, 64, 1, 2),
    "battery_fleet": (96, 32, 122, 1, 20, 0),
    "fleet_b128": (24, 128, 482, 1, 35, 0),
}


@pytest.mark.parametrize("key", list(K5_PATHS))
@pytest.mark.parametrize("parallel", [False, True])
def test_route_keeps_k5_at_every_shape_it_plans(monkeypatch, key, parallel):
    """At every shape of today's K5 paths the route is one K5 launch (its
    parallel sweep with ``parallel_sweeps``), as before K6, and its plan
    is ``plan_admm``'s own."""
    _no_launch(monkeypatch)
    N, b, m, S, n_ext, n_cons = K5_PATHS[key]
    sw, mean = _shape(N, b, m, n_ext, n_cons), S > 1
    M = torch.zeros(S, S, N) if mean else None
    pl = cs.k5_plan(N, b, m, S, 0, n_ext, n_cons, mean, parallel)
    assert pl == cs.plan_admm(S, N, b, m, S, 0, n_ext, n_cons, mean,
                              parallel=parallel)
    assert tsw._admm_route(sw, CUDA, parallel, M) == (
        tsw.sw_admm_cuda, dict(parallel=True) if parallel else {})


def _fleet(M, N):
    """The JAX package's M-battery fleet over N steps
    (``chip_smoke.fleet_arrays``, one import window) and its prep carried
    across: (js, ts, x0, price)."""
    p = JParams()
    one = j_battery(p)
    F1, f5, A_v, b_e, price, x0 = SMOKE.fleet_arrays(
        M, N, M * one.info.nv, j_tou(N), p.Ts_h)
    model = j_aggregate([j_battery(p) for _ in range(M)], coupling_F1=F1,
                        coupling_f5=f5)
    bw = j_bw()
    w = JWeights(Qx=np.tile(bw.Qx, M), x_ref=np.tile(bw.x_ref, M),
                 Ru=np.tile(bw.Ru, M))
    js = jsw.prepare_stagewise(model, N, w, extra=(A_v, b_e, None, None))
    return js, convert.stagewise_qp(js, "cpu"), x0, price


@pytest.mark.parametrize("M,parallel", [(33, False), (40, False),
                                        (40, True)])
def test_fleet_past_128_matches_reference(M, parallel):
    """A stagewise ADMM solve of M batteries at N = 3 (b = 4·M = 132, 160;
    M + 1 extra rows), 60 iterations from cold, the port's plain loop (what
    a CPU tensor runs; on the card the torch loop with K6) against the
    reference's ``stagewise_admm_solve`` on its prep carried across, both
    sweeps (``parallel_sweeps``: the reference's log-depth prefixes, the
    port's ``_solve_K_assoc``)."""
    js, ts, x0, price = _fleet(M, 3)
    assert (ts.b, ts.n_ext) == (4 * M, M + 1)
    assert cs.k5_plan(ts.N, ts.b, ts.m_k, n_ext=ts.n_ext) is None
    jx0 = jnp.asarray(x0, jnp.float32)
    jd = jsw.assemble_stagewise(js, jx0, price_seq=jnp.asarray(price))
    tx0 = torch.as_tensor(x0, dtype=torch.float32)
    td = tsw.assemble_stagewise(ts, tx0, price_seq=torch.as_tensor(
        price, dtype=torch.float32))
    jr = jsw.stagewise_admm_solve(js, *jd, iters=60,
                                  parallel_sweeps=parallel,
                                  ext_u=jsw.assemble_stagewise_ext(js, jx0))
    tr = tsw.stagewise_admm_solve(ts, *td, iters=60,
                                  parallel_sweeps=parallel,
                                  ext_u=tsw.assemble_stagewise_ext(ts, tx0))
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    for name in ("x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tr, name).numpy(), getattr(jr, name), 1e-3)


@pytest.mark.parametrize("parallel", [False, True])
def test_the_solve_reaches_k6_on_the_card_route(monkeypatch, parallel):
    """``stagewise_admm_solve`` at b = 160 on a CUDA-device route hands
    every x-update's sweep to K6's wrapper (stubbed here by its plain
    version: no card), sequential or over ``any_windows(N)`` windows with
    the prep's packed window maps, and its result is the plain loop's with
    that sweep: bitwise, the same operations."""
    js, ts, x0, price = _fleet(40, 5)
    calls = []

    def k6(r, factors, windows=None, maps=None):
        calls.append((windows, None if maps is None else maps.shape))
        if windows in (None, 1):
            return tsw._solve_K(None, r, factors)
        return tsw._solve_K_windowed(
            None, r, cs.horizon_windows(r.shape[-2], windows), factors)

    monkeypatch.setattr(cs, "sw_solve_k_any_cuda", k6)
    route = tsw._admm_route
    monkeypatch.setattr(tsw, "_admm_route",
                        lambda sw, dev, par, M=None: route(sw, CUDA, par, M))
    tx0 = torch.as_tensor(x0, dtype=torch.float32)
    td = tsw.assemble_stagewise(ts, tx0, price_seq=torch.as_tensor(
        price, dtype=torch.float32))
    eu = tsw.assemble_stagewise_ext(ts, tx0)
    got = tsw.stagewise_admm_solve(ts, *td, iters=4, ext_u=eu,
                                   parallel_sweeps=parallel)
    C = cs.any_windows(5) if parallel else None
    assert calls == [(C, (2, 5, cs.wide_block_words(160)) if C else None)
                     ] * 4
    monkeypatch.setattr(tsw, "_admm_route", route)
    w = cs.horizon_windows(5, C or 1)
    sweep = ((lambda s, t: tsw._solve_K_windowed(s, t, w)) if C
             else tsw._solve_K)
    ref = tsw._admm_iterations(
        ts, td[0], td[1], td[2], torch.zeros_like(td[0]),
        torch.clamp(torch.zeros_like(td[1]), td[1], td[2]),
        torch.zeros_like(td[1]), torch.clamp_max(torch.zeros_like(eu), eu),
        torch.zeros_like(eu), eu, 4, sweep=sweep)
    assert torch.equal(got.x, ref[0]) and torch.equal(got.y, ref[2])
    if C:
        Pi, Psi = tsw.window_maps(ts, w)
        assert torch.equal(cs.any_maps(ts, C),
                           cs.pack_wide((Pi, Psi)))
        assert cs.any_maps(ts, C) is cs.any_maps(ts, C)


def _omega_model():
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    return JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]),
        C=m.C, E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


@pytest.mark.parametrize("parallel", [False, True])
def test_tree_past_k5s_clusters_matches_reference(parallel):
    """A tree of S = 272 scenarios (N = 3, b = 5: past K5's clusters, whose
    slots would be under a warp) on config 6's ω double integrator: the
    consensus relaxation, 60 iterations on the reference's prep carried
    across, against the reference's ``stagewise_tree_admm_solve``, both
    sweeps: objective within 1e-4 relative, x within 1e-3."""
    S = 272
    paths = np.random.default_rng(S).normal(0.0, 0.3, size=(S, 3, 1))
    jt = JTree.from_branching(paths, branch_steps=(1,))
    js = jst.prepare_stagewise_tree(_omega_model(), jt,
                                    jdi.default_weights())
    ts = convert.stagewise_tree_qp(js, "cpu")
    sw = ts.sw
    assert cs.k5_plan(sw.N, sw.b, sw.m_k, S, sw.n_blk, sw.n_ext, sw.n_cons,
                      True, parallel) is None
    x0 = np.array([2.0, 0.0], np.float32)
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(x0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(x0))
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=60,
                                       parallel_sweeps=parallel)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=60,
                                       parallel_sweeps=parallel)
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    _close(tr.x.numpy(), jr.x, 1e-3)
