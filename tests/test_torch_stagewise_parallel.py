"""K5's parallel sweep inside its shared and FLEX variants
(``parallel_sweeps=True`` at every stagewise shape) on the CPU, against
the JAX package's ``parallel_sweeps=True``.

On the card ``stagewise_admm_solve(parallel_sweeps=True)`` launches K5
once with its parallel sweep: the horizon in C windows (the plan's
``windows``), each swept from a zero carry, joined by carries through the
window maps, with the Woodbury rows, the row work and the group mean
reading the corrected x. Its plain version is ``_admm_iterations`` with
``_solve_K_windowed`` on the plan's windows; here that plain loop runs
inside the port's own solves (the CPU's log-depth sweep ``_solve_K_assoc``
replaced by it) and is held against the JAX package's
``stagewise_admm_solve(parallel_sweeps=True)`` (``_solve_K_bordered`` over
``_solve_K_assoc``) on its prep carried across: 120 iterations from cold,
x, z, y and the extra rows' z and y within 1e-3 (relative, floor 1), as
tests/test_torch_stagewise_horizon.py holds the horizon variant's. Shapes:
one extra row (the register path's sizes), six (the runtime-r path's),
five batteries (b = 20, bmax 32) and a stagewise tree with a group mean
and a coupled row. ``MpcController(sw_parallel=True)`` on a small tree
with a coupled row matches the JAX package's: both find a plan, the
objective within 1e-3 relative. The parallel plan is the sequential one with at
least 2 windows at every shape the horizon variant leaves to the others,
and the horizon variant's at the single scenarios it takes; its shared
memory mirrors the kernel source, and the card's route reaches
K5 with the parallel sweep (the kernel itself runs only on the card:
``chip_smoke.py``, phase "K5's parallel sweep")."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyhybridcontrol_tpu.models.double_integrator as jdi
from pyhybridcontrol_tpu.control.mpc import MpcController as JController
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
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
import pyhybridcontrol_tpu_torch.models.double_integrator as tdi
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.ops import _build
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw
from pyhybridcontrol_tpu_torch.ops import stagewise_tree as tst
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

torch.set_num_threads(2)

CSRC = os.path.join(os.path.dirname(__file__), "..",
                    "pyhybridcontrol_tpu_torch", "csrc")
SRC = os.path.join(CSRC, "stagewise.cu")
ITERS = 120


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


def _omega_model():
    """Config 6's double integrator with a velocity disturbance (the JAX
    package's; ``convert.mld_model`` carries it across)."""
    base = jdi.switched_double_integrator()
    m = base.numpy_mats()
    return JModel.from_matrices(
        JInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=1, ny=2,
              ncons=base.info.ncons),
        A=m.A, B1=m.B1, B3=m.B3, B4=np.array([[0.0], [1.0]]), C=m.C,
        E=m.E, F1=m.F1, F2=m.F2, F3=m.F3, f5=m.f5)


def _budget_rows(N, nv, r, rng):
    """r horizon-coupled rows over the first input of each step: row 0
    Σ_k u_k ≤ 3, the others seeded weights ≤ 2."""
    A = np.zeros((r, N * nv))
    A[0, 0::nv] = 1.0
    if r > 1:
        A[1:, 0::nv] = rng.uniform(-1.0, 1.0, size=(r - 1, N))
    return A, np.concatenate([[3.0], np.full(r - 1, 2.0)])


def _di_case(r):
    def build():
        rng = np.random.default_rng(100 + r)
        N = 16
        js = jsw.prepare_stagewise(
            jdi.switched_double_integrator(), N, jdi.default_weights(),
            extra=_budget_rows(N, 3, r, rng) + (None, None))
        x0 = np.array([1.5, 0.0], np.float32)
        return js, x0, None
    return build


def _fleet_case():
    M, N, window = 5, 8, 8
    p = JParams()
    one = j_battery(p)
    F1, f5, A_v, b_e, price, x0 = SMOKE.fleet_arrays(
        M, N, M * one.info.nv, j_tou(N), p.Ts_h, window)
    model = j_aggregate([j_battery(p) for _ in range(M)], coupling_F1=F1,
                        coupling_f5=f5)
    bw = j_bw()
    w = JWeights(Qx=np.tile(bw.Qx, M), x_ref=np.tile(bw.x_ref, M),
                 Ru=np.tile(bw.Ru, M))
    js = jsw.prepare_stagewise(model, N, w, extra=(A_v, b_e, None, None))
    return js, np.asarray(x0, np.float32), price


# single-scenario shapes: (the JAX prep, x0, price_seq); the plan's path
CASES = {"one_extra_row": (_di_case(1), 0),
         "six_extra_rows": (_di_case(6), cs.EXT_RT),
         "five_batteries_b20": (_fleet_case, cs.EXT_RT)}


def _windowed(monkeypatch, windows):
    """The CPU's parallel sweep replaced by K5's plain version on
    ``windows`` windows (``_admm_route`` reads ``_solve_K_assoc`` when it
    routes), so that the port's own solves run what the card runs."""
    monkeypatch.setattr(
        tsw, "_solve_K_assoc",
        lambda sw, t, factors=None: tsw._solve_K_windowed(
            sw, t, cs.horizon_windows(sw.N, windows), factors))


@pytest.mark.parametrize("key", list(CASES))
def test_windowed_loop_matches_reference_parallel_sweeps(monkeypatch, key):
    """``_admm_iterations`` with ``_solve_K_windowed`` on the parallel
    plan's windows, inside the port's ``stagewise_admm_solve`` with the
    Woodbury extra rows, against the JAX package's
    ``stagewise_admm_solve(parallel_sweeps=True)`` on its prep carried
    across: x, z, y, z_e and y_e within 1e-3 (relative, floor 1)."""
    build, ext = CASES[key]
    js, x0, price = build()
    ts = convert.stagewise_qp(js, "cpu")
    pl = cs.plan_admm(8, ts.N, ts.b, ts.m_k, n_ext=ts.n_ext, parallel=True)
    assert pl.windows >= 2 and bool(pl.ext) == bool(ext)
    assert pl.variant != "horizon"
    _windowed(monkeypatch, pl.windows)
    jx = jnp.asarray(x0)
    tx = torch.as_tensor(x0)
    kw = {}
    if price is not None:
        kw = dict(price_seq=price)
    jd = jsw.assemble_stagewise(js, jx, **{k: jnp.asarray(v)
                                          for k, v in kw.items()})
    td = tsw.assemble_stagewise(ts, tx, **{k: torch.as_tensor(
        v, dtype=torch.float32) for k, v in kw.items()})
    jr = jsw.stagewise_admm_solve(js, *jd, iters=ITERS, parallel_sweeps=True,
                                  ext_u=jsw.assemble_stagewise_ext(js, jx))
    tr = tsw.stagewise_admm_solve(ts, *td, iters=ITERS, parallel_sweeps=True,
                                  ext_u=tsw.assemble_stagewise_ext(ts, tx))
    for name in ("x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tr, name).numpy(), getattr(jr, name), 1e-3)


def _trees(S=4, N=8, steps=(1, 4), seed=3):
    paths = np.random.default_rng(seed).normal(0.0, 0.3, size=(S, N, 1))
    jt = JTree.from_branching(paths, branch_steps=steps)
    return jt, convert.scenario_tree(jt)


def test_tree_windowed_loop_matches_reference_parallel_sweeps(monkeypatch):
    """A stagewise tree (S=4, N=8) with its group mean and a coupled row
    Σ_k u_k ≤ 3 on every scenario: the port's tree relaxation with K5's
    plain parallel sweep (the grouped plan's windows) against the JAX
    tree's ``stagewise_tree_admm_solve(parallel_sweeps=True)``: x, z, y,
    z_e and y_e within 1e-3 (relative, floor 1)."""
    jt, tt = _trees()
    N = jt.N
    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    js = jst.prepare_stagewise_tree(_omega_model(), jt, jdi.default_weights(),
                                    extra=(A_v, np.array([3.0])))
    ts = convert.stagewise_tree_qp(js, "cpu")
    sw = ts.sw
    assert sw.n_ext == 1 and sw.n_cons == 2
    pl = cs.plan_admm(8 * ts.S, N, sw.b, sw.m_k, ts.S, sw.n_blk, sw.n_ext,
                      sw.n_cons, True, parallel=True)
    assert pl.variant == "shared" and pl.windows >= 2
    _windowed(monkeypatch, pl.windows)
    x0 = np.array([2.0, 0.0], np.float32)
    jd = jst.assemble_stagewise_tree(js, jnp.asarray(x0))
    td = tst.assemble_stagewise_tree(ts, torch.as_tensor(x0))
    je = jst.assemble_stagewise_tree_ext(js, jnp.asarray(x0))
    te = tst.assemble_stagewise_tree_ext(ts, torch.as_tensor(x0))
    jr = jst.stagewise_tree_admm_solve(js, *jd, iters=ITERS, ext_u=je,
                                       parallel_sweeps=True)
    tr = tst.stagewise_tree_admm_solve(ts, *td, iters=ITERS, ext_u=te,
                                       parallel_sweeps=True)
    for k in ("x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tr, k).numpy(), getattr(jr, k), 1e-3)


def test_controller_sw_parallel_matches_reference_on_a_tree(monkeypatch):
    """``MpcController(solver="stagewise", sw_parallel=True)`` on a tree
    (S=2, N=4) with a coupled row Σ_k u_k ≤ 3, the port's solves running
    K5's plain parallel sweep, against the JAX package's controller with
    ``sw_parallel=True``: both find a plan, the objective within 1e-3
    (relative, floor 1)."""
    N = 4
    paths = np.random.default_rng(5).normal(0.0, 0.3, size=(2, N, 1))
    jt = JTree.from_branching(paths, branch_steps=(1,))
    A_v = np.zeros((1, N * 3))
    A_v[0, 0::3] = 1.0
    b_e = np.array([3.0])
    spec = dict(capacity=64, wave_size=8, max_waves=8, qp_iters=150,
                probe_iters=300)
    jm = _omega_model()
    jc = JController(jm, N, jdi.default_weights(), solver="stagewise",
                     bnb_spec=JSpec(**spec), sw_parallel=True)
    jc.set_scenario_tree(jt)
    jc.set_extra_constraints(A_v, b_e)
    x0 = np.array([2.0, 0.0], np.float32)
    jr = jc.feedback(x0)
    tc = MpcController(convert.mld_model(jm), N, tdi.default_weights(),
                       solver="stagewise", bnb_spec=BnbSpec(**spec),
                       sw_parallel=True, device="cpu")
    tc.set_scenario_tree(convert.scenario_tree(jt))
    tc.set_extra_constraints(A_v, b_e)
    tc.build()
    sw = tc.stagewise.sw
    pl = cs.plan_admm(8 * 2, N, sw.b, sw.m_k, 2, sw.n_blk, sw.n_ext,
                      sw.n_cons, True, parallel=True)
    _windowed(monkeypatch, pl.windows)
    tr = tc.feedback(x0)
    assert bool(tr.found) and bool(jr.found)
    rel = abs(float(tr.obj) - float(jr.obj)) / max(1.0, abs(float(jr.obj)))
    assert rel <= 1e-3, rel


# the shapes the horizon variant leaves to the others (as
# tests/test_torch_stagewise_horizon.py's LEFT, but for the single
# scenarios it takes, which the parallel plan gives it: HORIZON): (P, N, b,
# m, S, n_blk, n_ext, n_cons, mean) and the variant the sequential plan
# keeps
LEFT = {
    "di_N1000_one_extra_row": ((8, 1000, 5, 17, 1, 0, 1), "global"),
    "hull_N300_two_extra_rows": ((8, 300, 13, 49, 1, 0, 2), "global"),
    "di_N1000_runtime_r": ((8, 1000, 5, 17, 1, 0, 6), "global"),
    "tree_S16": ((128, 120, 5, 19, 16, 0, 1, 2, True), "grouped"),
    "tree_S8_N1000": ((64, 1000, 5, 19, 8, 0, 1, 2, True), "global"),
    "fleet8_b32": ((8, 96, 32, 122, 1, 0, 20), "global"),
    "config6_long_arm": ((64, 120, 5, 19, 8, 0, 1, 2, True), "shared"),
}
# one scenario, no extra rows, b up to 16: the sequential plan's variant,
# and the parallel plan the horizon variant's wherever a window fits
HORIZON = {
    "di_N1000": ((8, 1000, 5, 17), "horizon"),
    "hull_N300": ((8, 300, 13, 49), "horizon"),
    "di_N4000": ((64, 4000, 5, 17), "global_all"),
    "served_di_N10": ((32, 10, 5, 17), "shared"),
    "served_hull_N20": ((64, 20, 13, 49), "shared"),
}


@pytest.mark.parametrize("key", list(LEFT))
def test_parallel_plan_is_the_sequential_plan_with_windows(key):
    """``plan_admm(parallel=True)`` at every shape the horizon variant
    leaves to the others: the sequential plan's variant, placement, lanes
    and extra-row path, with C ≥ 2 windows from the slot's warps
    (``par_windows``), no factor ring, within SMEM_MAX, its shared memory
    the formula's with the carries; its library the "_par" twin of the
    sequential one's, its launches counted under their own name."""
    shape, want = LEFT[key]
    seq = cs.plan_admm(*shape)
    pl = cs.plan_admm(*shape, parallel=True)
    assert seq.variant == pl.variant == want
    assert pl.parallel and pl.windows >= 2 and pl.ring == 0
    assert pl.windows == cs.par_windows(pl.warps // pl.spc, shape[1])
    for f in ("bmax", "staged", "warps", "tps", "cluster", "spc", "ext",
              "lists"):
        assert getattr(pl, f) == getattr(seq, f), f
    assert pl.smem <= ca.SMEM_MAX
    P, N, b, m = shape[:4]
    S, n_blk, n_ext, n_cons, mean = (tuple(shape[4:])
                                     + (1, 0, 0, 0, False)[len(shape) - 4:])
    if pl.variant == "shared":
        want_smem = cs.admm_smem_bytes(N, b, m, S, n_blk, n_ext, n_cons,
                                       mean, pl.warps, pl.staged, pl.bmax,
                                       pl.ext, 0, pl.windows)
    else:
        want_smem = cs.flex_smem_bytes(
            N, b, m, n_blk, n_ext, n_cons, mean, pl.warps, pl.staged,
            pl.bmax, pl.spc, cs.ADMM_PLACES[pl.variant], pl.ext, 0, pl.lists,
            S, pl.windows)
    assert pl.smem == want_smem
    assert pl.library == seq.library + "_par"
    assert pl.launch == cs.ADMM_LAUNCH[want] + cs.PAR_SUFFIX
    assert pl.launch in ca.LAUNCHES


@pytest.mark.parametrize("warps,N,C", [(15, 120, 8), (6, 96, 6), (2, 120, 2),
                                       (1, 40, 2), (16, 1, 1), (4, 3, 3)])
def test_par_windows_take_the_slots_warps(warps, N, C):
    """C = the slot's warps, at least 2 (a one-warp slot sweeps both
    windows in turn), at most N and PAR_WINDOWS (the kernel's
    kMaxWindows)."""
    assert cs.par_windows(warps, N) == C


@pytest.mark.parametrize("key", list(HORIZON))
def test_horizon_shapes_keep_the_horizon_variant(key):
    """Where the horizon variant takes the shape (one scenario, no extra
    rows, bmax 8–16), the parallel plan is that variant's parallel sweep,
    as before, whatever the sequential plan picks: the horizon plan with
    ``parallel`` set, no "_par" library; the parallel sweep inside the
    sequential plan's variant only forced."""
    shape, want = HORIZON[key]
    seq = cs.plan_admm(*shape)
    pl = cs.plan_admm(*shape, parallel=True)
    assert seq.variant == want and pl.variant == "horizon"
    assert pl.parallel and not pl.windows and pl.library == \
        "stagewise_horizon"
    assert pl == cs.plan_admm(*shape, variant="horizon", parallel=True)
    if want != "horizon":
        forced = cs.plan_admm(*shape, variant=want, parallel=True)
        assert forced.variant == want and forced.windows >= 2
        assert forced.library == seq.library + "_par"


def test_parallel_plan_raises_where_the_sequential_plan_raises():
    """b above 128 has no instantiation in either sweep."""
    for parallel in (False, True):
        with pytest.raises(ValueError, match="above the 128"):
            cs.plan_admm(8, 10, 130, 300, parallel=parallel)


def test_par_smem_mirrors_the_kernel_source():
    """The carries' words in both layouts, the windows' bound, the window
    of a stage (``win_of``: hz_lo's inverse) and the three "_par" sources
    are the kernel's; each library is built and bound; ``_AdmmArgs`` ends
    with the maps and the windows, as the C struct does."""
    src = open(SRC).read()
    for line in ("a.cw = o; o += pad4((size_t)windows * b);",
                 "a.cw = sl; sl += pad4((size_t)windows * b);",
                 f"constexpr int kMaxWindows = {cs.PAR_WINDOWS};",
                 "return ((k + 1) * C - 1) / N;",
                 "if constexpr (RING && !PAR)",
                 "return sizeof(float) * (pad4((size_t)windows * b) +",
                 "#if PHC_SW_PART == 0 && !PHC_SW_PAR"):
        assert line in src, line
    for name, part in (("stagewise_par", None), ("stagewise_wide_par", 1),
                       ("stagewise_extra_par", 2)):
        body = open(os.path.join(CSRC, name + ".cu")).read()
        assert "#define PHC_SW_PAR 1" in body
        assert '#include "stagewise.cu"' in body
        assert (f"#define PHC_SW_PART {part}" in body) == (part is not None)
        assert _build.LIBRARIES[name].name == name + ".cu"
        assert _build._BINDERS[name] is _build._bind_stagewise_k5
    bind = open(_build.__file__).read()
    assert "lib.phc_sw_admm_smem_bytes.argtypes = [I] * 14" in bind
    assert "lib.phc_sw_admm_flex_smem_bytes.argtypes = [I] * 17" in bind
    assert [f for f, _ in cs._AdmmArgs._fields_][-3:] == ["Pi", "Psi",
                                                          "windows"]
    # win_of against the windows' bounds, every stage of many splits
    for N in (1, 2, 3, 7, 10, 37, 96, 120, 1000):
        for C in range(1, min(N, 8) + 1):
            w = cs.horizon_windows(N, C)
            for k in range(N):
                c = ((k + 1) * C - 1) // N
                assert w[c] <= k < w[c + 1]
    # the sequential layouts are unchanged at zero windows
    assert cs.admm_smem_bytes(120, 5, 19, 8, 0, 1, 2, True, 15, True, 8) == \
        cs.admm_smem_bytes(120, 5, 19, 8, 0, 1, 2, True, 15, True, 8, 0, 0)
    assert cs.admm_smem_bytes(120, 5, 19, 8, 0, 1, 2, True, 15, True, 8, 0,
                              0, 8) == \
        cs.admm_smem_bytes(120, 5, 19, 8, 0, 1, 2, True, 15, True, 8) + 4 * 40


def test_par_maps_layout():
    """The window maps as the kernel reads them: ``window_maps`` of the
    plan's windows row-major up to bmax 16, each block transposed
    (column-major) above; built once a prep."""
    js, _, _ = _fleet_case()
    ts = convert.stagewise_qp(js, "cpu")
    w = cs.horizon_windows(ts.N, 4)
    Pi, Psi = tsw.window_maps(ts, w)
    got = cs.par_maps(ts, 4, 32)
    assert torch.equal(got[0], Pi.transpose(-1, -2))
    assert torch.equal(got[1], Psi.transpose(-1, -2))
    assert got[0].is_contiguous() and cs.par_maps(ts, 4, 32)[0] is got[0]
    narrow = cs.par_maps(ts, 4, 16)
    assert narrow[0] is Pi and narrow[1] is Psi


ROUTES = {"extra": dict(extra=1), "mean": dict(consensus=1),
          "extra_and_mean": dict(extra=1, consensus=1)}


@pytest.mark.parametrize("feature", list(ROUTES))
def test_parallel_sweeps_on_the_card_route_to_k5(monkeypatch, feature):
    """On a CUDA device ``parallel_sweeps=True`` at shapes the horizon
    variant does not take (extra rows, a group mean, both) routes to one K5
    launch with the parallel sweep, never to the plain loop; the CPU keeps
    the reference's ``_solve_K_assoc``."""
    monkeypatch.setattr(tsw, "_admm_iterations",
                        lambda *a, **k: pytest.fail("plain loop reached"))
    model, N = tdi.switched_double_integrator(), 12
    kw = {}
    if "extra" in ROUTES[feature]:
        A = np.zeros((1, N * model.info.nv))
        A[0, 0::model.info.nv] = 1.0
        kw["extra"] = (A, np.array([3.0]))
    if "consensus" in ROUTES[feature]:
        kw["consensus"] = 1
    ts = tsw.prepare_stagewise(model, N, tdi.default_weights(), device="cpu",
                               **kw)
    M = torch.full((2, 2, N), 0.5) if "consensus" in kw else None
    assert not cs.horizon_applies(ts.b, 2 if M is not None else 1,
                                  M is not None, ts.n_ext)
    assert tsw._admm_route(ts, torch.device("cuda"), True, M) == (
        tsw.sw_admm_cuda, dict(parallel=True))
    assert tsw._admm_route(ts, torch.device("cpu"), True, M) == (
        tsw._admm_iterations, dict(sweep=tsw._solve_K_assoc))


def test_parallel_sweeps_reach_k5_through_the_solve(monkeypatch):
    """``stagewise_admm_solve(parallel_sweeps=True)`` on a CUDA-device
    route with extra rows hands its carries to K5's wrapper once, with
    ``parallel=True`` (the wrapper stubbed: no card here)."""
    seen, plain = [], tsw._admm_iterations

    def k5(*a, **kw):
        seen.append(kw)
        return plain(*a)

    monkeypatch.setattr(tsw, "sw_admm_cuda", k5)
    route = tsw._admm_route
    monkeypatch.setattr(tsw, "_admm_route",
                        lambda sw, dev, par, M=None: route(
                            sw, torch.device("cuda"), par, M))
    model, N = tdi.switched_double_integrator(), 10
    A = np.zeros((1, N * model.info.nv))
    A[0, 0::model.info.nv] = 1.0
    ts = tsw.prepare_stagewise(model, N, tdi.default_weights(), device="cpu",
                               extra=(A, np.array([3.0])))
    x0 = torch.tensor([1.0, 0.0])
    q, l, u = tsw.assemble_stagewise(ts, x0)
    tsw.stagewise_admm_solve(ts, q, l, u, iters=3, parallel_sweeps=True,
                             ext_u=tsw.assemble_stagewise_ext(ts, x0))
    assert seen == [dict(parallel=True)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["tree", "fleet"])
def test_k5_parallel_sweep_matches_its_plain_version_on_the_card(shape):
    """On the card K5's parallel sweep launches once (counted under the
    plan's "_par" name) and agrees with its plain version (the plain loop
    with ``_solve_K_windowed`` on the plan's windows) within 1e-3
    (relative, floor 1): a small tree (S=4, N=8, a group mean and a
    coupled row; the shared variant) and five batteries (b=20, 6 extra
    rows; bmax 32), 60 iterations cold."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda")
    if shape == "tree":
        jt, _ = _trees()
        A_v = np.zeros((1, jt.N * 3))
        A_v[0, 0::3] = 1.0
        js = jst.prepare_stagewise_tree(_omega_model(), jt,
                                        jdi.default_weights(),
                                        extra=(A_v, np.array([3.0])))
        ts = convert.stagewise_tree_qp(js, dev)
        sw, M = ts.sw, ts.M
        x0 = torch.tensor([2.0, 0.0], device=dev)
        q, l, u = tst.assemble_stagewise_tree(ts, x0)
        eu = tst.assemble_stagewise_tree_ext(ts, x0)
    else:
        js, x0n, price = _fleet_case()
        sw, M = convert.stagewise_qp(js, dev), None
        x0 = torch.as_tensor(x0n, device=dev)
        q, l, u = tsw.assemble_stagewise(sw, x0, price_seq=torch.as_tensor(
            price, dtype=torch.float32, device=dev))
        eu = tsw.assemble_stagewise_ext(sw, x0)
    batch = (8,) + tuple(q.shape[:-2])
    q, l, u = (a.expand(batch + a.shape[-2:]).contiguous() for a in (q, l, u))
    eu = eu.expand(batch + eu.shape[-1:]).contiguous()
    x = torch.zeros_like(q)
    z = torch.clamp(torch.zeros_like(l), l, u)
    y = torch.zeros_like(l)
    ze = torch.clamp_max(torch.zeros_like(eu), eu)
    ye = torch.zeros_like(eu)
    args = (sw, q, l, u, x, z, y, ze, ye, eu, 60, M)
    ca.reset_launch_counts()
    got = cs.sw_admm_cuda(*args, parallel=True)
    P = q.numel() // (sw.N * sw.b)
    S = M.shape[0] if M is not None else 1
    pl = cs.plan_admm(P, sw.N, sw.b, sw.m_k, S, sw.n_blk, sw.n_ext,
                      sw.n_cons, M is not None, parallel=True, device=dev,
                      members=(cs.admm_members(sw, M).numel()
                               if M is not None else 0))
    assert ca.LAUNCHES[pl.launch] == 1
    w = cs.horizon_windows(sw.N, pl.windows)
    want = tsw._admm_iterations(
        *args, sweep=lambda s, t: tsw._solve_K_windowed(s, t, w))
    for g, w_ in zip(got, want):
        if g is not None:
            _close(g.cpu().numpy(), w_.cpu().numpy(), 1e-3)
