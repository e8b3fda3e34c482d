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
    """K6's launch: "narrow" (k6_narrow) where b is up to 32 and the
    horizon's factors (and maps) fit one CTA, one warp a CTA where a
    problem's slots fit one (else a problem a CTA); "ring" (k6_wide) where
    two row slices fit beside the vectors, the cluster the fewest CTAs that
    leave a CTA 16 rows (16 CTAs above b=256), 8 problems a cluster or as
    many more as put the sweep's clusters in one wave of ANY_WAVE CTAs, a
    thread a row of a problem and a producer warp, the ring as deep as
    fits (at most ANY_RING and the slices a CTA reads); "l2" above. C = 1
    or ``any_windows(N)`` (⌈√(2N)⌉, at most 16 and N). It
    raises only where a stage's vectors do not fit a CTA (b above 19,364),
    where C is not 1 to N, and on an empty shape. K4's and K5's plans
    still raise at b = 129."""
    assert [cs.any_windows(N) for N in (1, 2, 3, 8, 24, 96, 120, 1000)] == [
        1, 2, 3, 4, 7, 14, 16, 16]
    pl = cs.plan_sweep_any(64, 120, 5)
    assert (pl.variant, pl.lanes, pl.problems, pl.threads, pl.clusters,
            pl.smem) == ("narrow", 8, 4, 32, 16, 4 * (
                4 + 3 * 120 * 28 + 2 * 4 * 600 + 4 * (4 * 8 + 1)))
    pl = cs.plan_sweep_any(32, 120, 5, 16)
    assert (pl.variant, pl.windows, pl.problems, pl.threads,
            pl.clusters) == ("narrow", 16, 1, 128, 32)
    for (P, N, b, C), want in {
            (8, 24, 160, 1): ("ring", 16, 10, 8, 32, 128, 1),
            (8, 24, 160, 7): ("ring", 16, 10, 8, 19, 128, 7),
            (64, 24, 160, 1): ("ring", 16, 10, 10, 32, 160, 7),
            (64, 24, 160, 7): ("ring", 16, 10, 64, 16, 256, 7),
            (64, 96, 32, 1): ("ring", 2, 16, 8, 48, 160, 8),
            (64, 24, 128, 1): ("ring", 8, 16, 8, 25, 160, 8),
            (64, 12, 256, 5): ("ring", 16, 16, 8, 12, 160, 40),
            (1, 1, 200, 1): ("ring", 16, 13, 1, 2, 64, 1),
            (2, 4, 700, 1): ("l2", 16, 44, 2, 0, 96, 1)}.items():
        pl = cs.plan_sweep_any(P, N, b, C)
        assert (pl.variant, pl.cluster, pl.rows, pl.problems, pl.ring,
                pl.threads, pl.clusters) == want, (P, N, b, C)
        assert pl.smem == cs.any_smem_bytes(
            pl.variant, N, b, C, pl.lanes, pl.rows, pl.problems,
            pl.ring) <= cs.SMEM_MAX
    assert cs.plan_sweep_any(1, 5, 160, 5).windows == 5
    for C in (6, 0):
        with pytest.raises(ValueError, match="windows, not 1 to N"):
            cs.plan_sweep_any(1, 5, 160, C)
    for b in (14528, 19364):
        pl = cs.plan_sweep_any(1, 3, b)
        assert (pl.variant, pl.cluster, pl.problems) == ("l2", 16, 1)
        assert pl.smem <= cs.SMEM_MAX and pl.threads == cs.ANY_THREADS
    with pytest.raises(ValueError, match="b=19365.*shared memory"):
        cs.plan_sweep_any(1, 3, 19365)
    with pytest.raises(ValueError, match="empty shape"):
        cs.plan_sweep_any(0, 3, 5)
    with pytest.raises(ValueError, match="above the 128"):
        cs.plan_admm(8, 24, 129, 500)
    with pytest.raises(ValueError, match="above the 128"):
        cs.plan_sweep(8, 24, 129)
    assert cs.k5_plan(24, 129, 500) is None and cs.k4_plan(24, 129) is None


def _first_plan_takes(P, N, b, C):
    """Whether K6's first plan took the shape (one CTA a problem and window,
    four b-word vectors in its shared memory): 1 ≤ C ≤ N, P, N, b ≥ 1."""
    return P >= 1 and N >= 1 and 1 <= b and 16 * b <= cs.SMEM_MAX and \
        1 <= C <= N


def _check_any_plan(pl, P, N, b, C):
    """A plan's own consistency: the kernel's bounds on its arguments."""
    assert pl.windows == C and pl.smem <= cs.SMEM_MAX
    assert pl.threads % 32 == 0 and 32 <= pl.threads <= cs.ANY_THREADS
    assert pl.smem == cs.any_smem_bytes(pl.variant, N, b, C, pl.lanes,
                                        pl.rows, pl.problems, pl.ring)
    if pl.variant == "narrow":
        assert b <= pl.lanes <= 32 and 32 % pl.lanes == 0
        assert pl.problems * C * pl.lanes <= pl.threads
        assert pl.clusters == -(-P // pl.problems)
    else:
        cl, R = cs.any_rows(b)
        assert (pl.cluster, pl.rows) == (cl, R) and R * cl >= b
        assert pl.cluster in (1, 2, 4, 8, 16) and pl.problems >= 1
        wave = max(1, cs.ANY_WAVE // pl.cluster // C)
        assert pl.problems <= max(cs.ANY_GROUP, -(-P // wave))
        assert (pl.ring >= 2) == (pl.variant == "ring")
        rows = -(-pl.problems * pl.rows // 32) * 32
        assert pl.threads == (min(cs.ANY_THREADS - 32, rows) + 32
                              if pl.variant == "ring"
                              else min(cs.ANY_THREADS, rows))
        assert pl.clusters == -(-P // pl.problems) * C


@pytest.mark.parametrize("axis", ["b", "N", "P"])
def test_any_plan_takes_every_shape_the_first_plan_took(axis):
    """Every shape K6's first plan took (b 1–1000, N 1–120, P 1–300, C 1 and
    ``any_windows(N)``) still has a plan, and each plan is one the kernel
    takes (``_check_any_plan``): along b at N in (1, 3, 24, 120) and P in
    (1, 8, 300); along N at b in (1, 5, 32, 33, 160, 1000) and P in (1,
    64); along P at (N, b) in ((120, 5), (96, 32), (24, 160), (3, 1000))."""
    if axis == "b":
        shapes = [(P, N, b) for b in range(1, 1001) for N in (1, 3, 24, 120)
                  for P in (1, 8, 300)]
    elif axis == "N":
        shapes = [(P, N, b) for N in range(1, 121)
                  for b in (1, 5, 32, 33, 160, 1000) for P in (1, 64)]
    else:
        shapes = [(P, N, b) for P in range(1, 301)
                  for N, b in ((120, 5), (96, 32), (24, 160), (3, 1000))]
    for P, N, b in shapes:
        for C in sorted({1, cs.any_windows(N)}):
            assert _first_plan_takes(P, N, b, C)
            _check_any_plan(cs.plan_sweep_any(P, N, b, C), P, N, b, C)


def test_any_plan_picks_its_variant_by_shape():
    """The plan's pick, from the shapes alone: narrow at b ≤ 32 whose
    staged horizon fits (config 6's b=5 at N=120, sequential and over 16
    windows), ring where it does not (b=5 at N=1000, b=32 at N=96) and at
    the fleets' b (128, 160) and random b up to 600, l2 from b=700. A
    forced variant is taken where it fits (ring and l2 at fleet_b160's
    wave, sequential and over windows; ring at config 6's shape) and
    raises where not (narrow above b=32 or past a CTA; ring at b=700)."""
    for (P, N, b, C), want in {
            (64, 120, 5, 1): "narrow", (64, 120, 5, 16): "narrow",
            (32, 4, 32, 3): "narrow", (8, 1000, 5, 1): "ring",
            (64, 96, 32, 14): "ring", (8, 24, 128, 1): "ring",
            (8, 24, 160, 7): "ring", (64, 12, 256, 1): "ring",
            (2, 4, 600, 1): "ring", (2, 4, 700, 1): "l2",
            (1, 3, 14528, 1): "l2"}.items():
        assert cs.plan_sweep_any(P, N, b, C).variant == want, (P, N, b, C)
    for C in (1, 7):
        for v in ("ring", "l2"):
            pl = cs.plan_sweep_any(8, 24, 160, C, v)
            assert pl.variant == v
            _check_any_plan(pl, 8, 24, 160, C)
    assert cs.plan_sweep_any(64, 120, 5, 1, "ring").variant == "ring"
    for shape in ((8, 24, 33, 1), (8, 1000, 5, 1)):
        with pytest.raises(ValueError, match="narrow variant takes"):
            cs.plan_sweep_any(*shape, variant="narrow")
    with pytest.raises(ValueError, match="no ring of two"):
        cs.plan_sweep_any(2, 4, 700, 1, "ring")
    with pytest.raises(ValueError, match="no variant"):
        cs.plan_sweep_any(2, 4, 5, 1, "wide")


def test_row_slices_read_back_as_the_packed_blocks():
    """``pack_slices`` of ``pack_wide``'s blocks (n, N, cluster, R,
    ``_odd_quads(b)``): slice [a, k, q] holds rows q·R … q·R + R − 1 of
    block (a, k) row-major, zero past b; every slice a multiple of 16
    bytes; the wrapper's cache gives the same tensor while the packed one
    is unchanged."""
    rng = np.random.default_rng(3)
    for b, N, n in ((5, 3, 3), (33, 2, 2), (160, 2, 3), (137, 1, 2)):
        blocks = torch.as_tensor(rng.normal(size=(n, N, b, b)),
                                 dtype=torch.float32)
        packed = cs.pack_wide(tuple(blocks))
        cl, R = cs.any_rows(b)
        RS = cs._odd_quads(b)
        sl = cs.pack_slices(packed, b, cl)
        assert sl.shape == (n, N, cl, R, RS) and (R * RS) % 4 == 0
        assert RS >= b and (RS // 4) % 2 == 1
        rows = sl.reshape(n, N, cl * R, RS)
        assert torch.equal(rows[:, :, :b, :b], blocks)
        assert not rows[:, :, b:].any() and not rows[:, :, :, b:].any()
        for a_, k, q in ((0, 0, 0), (n - 1, N - 1, cl - 1)):
            want = torch.zeros(R, RS)
            got = blocks[a_, k, q * R:(q + 1) * R]
            want[:got.shape[0], :b] = got
            assert torch.equal(sl[a_, k, q], want)
        assert cs._slices_of(packed, b, cl) is cs._slices_of(packed, b, cl)
        assert torch.equal(cs._slices_of(packed, b, cl), sl)


def test_any_smem_mirrors_the_kernel_source():
    """``any_smem_bytes``, the CTA's thread bound and the row stride mirror
    csrc/stagewise_any.cu (narrow_smem_words, wide_smem_words, odd_quads,
    kMaxThreads)."""
    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "pyhybridcontrol_tpu_torch", "csrc",
                            "stagewise_any.cu")).read()
    assert f"constexpr int kMaxThreads = {cs.ANY_THREADS};" in src
    assert ("return 4 + (size_t)(C > 1 ? 5 : 3) * N * block_words(b) +\n"
            "         2 * pad4((size_t)G * N * b) + (size_t)G * C * (4 * L + 1);"
            ) in src
    assert ("return pad4(2 * ((size_t)D + 2)) + (size_t)D * R * RS +\n"
            "         3 * (size_t)G * odd_quads(b);") in src
    assert "return (w / 4) % 2 ? w : w + 4;" in src
    assert cs.any_smem_bytes("narrow", 120, 5, 16, lanes=8) == 4 * (
        4 + 5 * 120 * 28 + 2 * 600 + 16 * 33)
    assert cs.any_smem_bytes("ring", 24, 160, 1, rows=10, G=8,
                             ring=32) == 4 * (68 + 32 * 10 * 164
                                              + 3 * 8 * 164)
    assert cs.any_smem_bytes("l2", 24, 160, 1, rows=10, G=8,
                             ring=32) == 4 * (4 + 3 * 8 * 164)


def test_profile_counts_k6_by_its_kernels():
    """``profile_serve.profile_request`` counts K6's device time by a name
    that both kernels of csrc/stagewise_any.cu carry and no other kernel
    of csrc/ does, so that phase 41's "K6 ... ms on the device" reads
    k6_narrow and k6_wide and nothing else."""
    import re

    root = os.path.join(os.path.dirname(__file__), "..",
                        "pyhybridcontrol_tpu_torch")
    prof = open(os.path.join(root, "profile_serve.py")).read()
    assert '("k6", "k6_")' in prof
    names = {}
    for f in os.listdir(os.path.join(root, "csrc")):
        src = open(os.path.join(root, "csrc", f)).read()
        names[f] = set(re.findall(
            r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\(",
            src))
    assert {"k6_wide", "k6_narrow"} <= names["stagewise_any.cu"]
    assert all("k6_" in n for n in names["stagewise_any.cu"])
    assert not any("k6_" in n for f, ns in names.items() for n in ns
                   if f != "stagewise_any.cu")


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
