"""The port's stagewise frame at the shapes past K5's register path (block
sizes above 16, more than 4 horizon-coupled rows) against the JAX package,
on the CPU, and K5's plan and shared-memory formulas there.

The shapes are battery fleets: default batteries (models/battery.py, b = 4
each) aggregated with ``mld/compose.aggregate_mld`` and the feeder limit
as coupling rows, with ``chip_smoke.fleet_arrays``' export and import caps
as horizon-coupled rows, its TOU price and its x0. Both packages get the
same numpy arrays.

Tolerances are tests/test_torch_stagewise.py's: ``stagewise_admm_solve`` at
30 iterations on the reference's prep carried across
(``convert.stagewise_qp``): objective 1e-4 relative, x, z, y and the extra
rows' z and y 1e-3 (relative, floor 1). ``MpcController.feedback``
(stagewise) on each package's own prep of the same numpy model: objective
1e-3 relative, u₀ 1e-3."""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pyhybridcontrol_tpu.control.mpc import MpcController as JController
from pyhybridcontrol_tpu.mld.compose import aggregate_mld as j_aggregate
from pyhybridcontrol_tpu.models.battery import BatteryParams as JParams
from pyhybridcontrol_tpu.models.battery import battery_model as j_battery
from pyhybridcontrol_tpu.models.battery import battery_weights as j_bw
from pyhybridcontrol_tpu.models.grid import default_tou_profile as j_tou
from pyhybridcontrol_tpu.ops import stagewise as jsw
from pyhybridcontrol_tpu.ops.condense import MpcWeights as JWeights
from pyhybridcontrol_tpu.solver.bnb import BnbSpec as JSpec
from pyhybridcontrol_tpu_torch import convert
from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops import stagewise as tsw

torch.set_num_threads(2)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..",
                                   "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _chip_smoke()


def _fleet_ref(M, N, window):
    """The JAX package's M-battery fleet: (model, weights, extra rows,
    price_seq, x0), from ``chip_smoke.fleet_arrays``."""
    p = JParams()
    one = j_battery(p)
    F1, f5, A_v, b_e, price, x0 = SMOKE.fleet_arrays(
        M, N, M * one.info.nv, j_tou(N), p.Ts_h, window)
    model = j_aggregate([j_battery(p) for _ in range(M)], coupling_F1=F1,
                        coupling_f5=f5)
    bw = j_bw()
    w = JWeights(Qx=np.tile(bw.Qx, M), x_ref=np.tile(bw.x_ref, M),
                 Ru=np.tile(bw.Ru, M))
    return model, w, (A_v, b_e, None, None), price, x0


def _close(got, want, tol, floor=1.0):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.max(np.abs(got - want) / np.maximum(np.abs(want), floor))
    assert err <= tol, f"error {err:.3e} above {tol:.1e}"


# (batteries, N, import window): b = 4·M, and M + ⌈N/window⌉ extra rows
FLEETS = {"five_b20_r6": (5, 8, 8), "eight_b32_r10": (8, 4, 2)}


@pytest.mark.parametrize("key", list(FLEETS))
def test_plain_loop_matches_reference_past_the_register_path(key):
    """30 iterations of the port's plain loop (what a CPU tensor runs, the
    plain version of K5's runtime-r instantiations) against the reference's
    ``stagewise_admm_solve`` on its prep carried across, at a fleet whose
    block (b = 20, 32) and extra rows (6, 10) are past the register
    path."""
    M, N, window = FLEETS[key]
    model, w, extra, price, x0 = _fleet_ref(M, N, window)
    js = jsw.prepare_stagewise(model, N, w, extra=extra)
    ts = convert.stagewise_qp(js, "cpu")
    assert (ts.b, ts.n_ext) == (4 * M, M + -(-N // window))
    pl = cs.plan_admm(8, ts.N, ts.b, ts.m_k, n_ext=ts.n_ext)
    assert pl.bmax == 32 and pl.ext & cs.EXT_RT
    jx0 = jnp.asarray(x0, jnp.float32)
    jd = jsw.assemble_stagewise(js, jx0, price_seq=jnp.asarray(price))
    tx0 = torch.as_tensor(x0, dtype=torch.float32)
    td = tsw.assemble_stagewise(ts, tx0, price_seq=torch.as_tensor(
        price, dtype=torch.float32))
    jr = jsw.stagewise_admm_solve(js, *jd, iters=30,
                                  ext_u=jsw.assemble_stagewise_ext(js, jx0))
    tr = tsw.stagewise_admm_solve(ts, *td, iters=30,
                                  ext_u=tsw.assemble_stagewise_ext(ts, tx0))
    _close(tr.obj.numpy(), jr.obj, 1e-4)
    for name in ("x", "z", "y", "z_ext", "y_ext"):
        _close(getattr(tr, name).numpy(), getattr(jr, name), 1e-3)


FEEDBACK_SPEC = dict(capacity=64, wave_size=8, max_waves=4, qp_iters=150,
                     probe_iters=300)


def test_feedback_matches_reference_five_batteries():
    """Stagewise ``MpcController.feedback`` of the five-battery fleet (b =
    20, 6 extra rows, N = 8) on each package: the same plan's objective
    and first input."""
    M, N, window = FLEETS["five_b20_r6"]
    model, w, extra, price, x0 = _fleet_ref(M, N, window)
    jc = JController(model, N, w, solver="stagewise",
                     bnb_spec=JSpec(**FEEDBACK_SPEC))
    jc.set_extra_constraints(*extra[:2])
    jc.build()
    jr = jc.feedback(x0, price_seq=price)
    tc, tprice, tx0, _ = SMOKE.fleet_controller(M, N, "cpu", window,
                                                FEEDBACK_SPEC)
    assert (tc._sw.b, tc._sw.n_ext) == (20, 6)
    tr = tc.feedback(tx0, price_seq=tprice)
    assert bool(jr.found) and bool(tr.found)
    _close(float(tr.obj), float(jr.obj), 1e-3)
    np.testing.assert_allclose(tr.u.numpy(), np.asarray(jr.u), atol=1e-3)


def test_battery_fleet_path_shape():
    """The battery_fleet path's frame: eight batteries over a day (N = 96)
    give b = 32, m = 122 rows a stage, 8 binaries a stage and 20 extra
    rows; its plan is the global variant at bmax 32 with Aext and KiU in
    device memory (z/y/l/u take 187 KB, Aext and KiU 491 KB)."""
    c, price, x0, (A_v, b_e) = SMOKE.fleet_controller(
        SMOKE.FLEET_M, SMOKE.FLEET_N, "cpu")
    sw = c._sw
    assert (sw.N, sw.b, sw.m_k, sw.n_ext) == (96, 32, 122, 20)
    assert int(c.model.info.v_binary_mask.sum()) == 8
    assert A_v.shape == (20, 96 * 24) and price.shape == (96, 24)
    assert 4 * 4 * sw.m_k * sw.N == 187392
    assert 4 * 2 * sw.n_ext * sw.N * sw.b == 491520
    pl = cs.plan_admm(8, sw.N, sw.b, sw.m_k, n_ext=sw.n_ext)
    assert (pl.variant, pl.bmax, pl.ext, pl.staged) == (
        "global", 32, cs.EXT_RT | cs.EXT_AK, False)
    assert cs.ADMM_LAUNCH[pl.variant] == "stagewise_k5_global"


def test_runtime_r_smem_by_hand():
    """The runtime-r placements' shared memory and scratch, counted by hand
    at the five-battery frame (N = 8, b = 20, m = 77, 6 extra rows, 8 warps,
    staged, bmax 32): the factors 3·3200, J and Mc in rows of b words
    2·1540, Aext and KiU 2·960, Cw 36, ρₑ 8, z/y/l/u and w 5·616, t/mb/x
    3·160, the four r-vectors 4·8; each array placed in device memory
    drops out; a FLEX CTA at place 2 keeps only the constants left and
    its slot's vectors; the vectors' scratch 4·8 words a problem."""
    N, b, m, r = 8, 20, 77, 6
    staged_all = (3 * 3200 + 2 * 1540 + 2 * 960 + 36 + 8 + 5 * 616
                  + 3 * 160 + 4 * 8)
    assert cs.admm_smem_bytes(N, b, m, 1, 0, r, 0, False, 8, True, 32,
                              cs.EXT_RT) == 4 * staged_all
    ext = cs.EXT_RT | cs.EXT_AK | cs.EXT_CW
    assert cs.admm_smem_bytes(N, b, m, 1, 0, r, 0, False, 8, True, 32,
                              ext) == 4 * (staged_all - 2 * 960 - 36)
    every = ext | cs.EXT_JM | cs.EXT_VEC
    assert cs.admm_smem_bytes(N, b, m, 1, 0, r, 0, False, 8, False, 32,
                              every) == 4 * (5 * 616 + 3 * 160)
    assert cs.flex_smem_bytes(N, b, m, 0, r, 0, False, 8, False, 32, 1, 2,
                              cs.EXT_RT) == 4 * (2 * 1540 + 36 + 8 + 4 * 8)
    assert cs.flex_scratch_words(N, b, m, 0, False, 2, 32) == \
        5 * 616 + 3 * 160
    assert cs.ext_scratch_words(r) == 32
    # bmax 16 and below keep rows of bmax words and the register path's
    # coefficient and per-warp sums; the runtime-r path drops the sums
    assert cs.admm_smem_bytes(N, 5, 17, 1, 0, 5, 0, False, 4, False, 8,
                              cs.EXT_RT) == 4 * (
        2 * 136 + 2 * 200 + 28 + 8 + 4 * 136 + 3 * 40 + 4 * 8)


def test_runtime_r_plan_ladder():
    """The runtime-r path moves its arrays to device memory one kind at a
    time, the largest first: Aext with KiU before Cw until r² outgrows
    2·r·N·b, then J with Mc (above bmax 16), then the r-vectors; forced on
    config 6's long arm (one extra row) it keeps the register plan's warps
    and lanes, so that its sums run in the same order."""
    assert cs._ext_ladder(120, 5, 19, 5, 8, True) == (1, 3, 7, 15)
    assert cs._ext_ladder(8, 5, 19, 300, 8, True) == (1, 5, 7, 15)
    assert cs._ext_ladder(96, 32, 122, 20, 32, True) == (1, 3, 7, 23, 31)
    assert cs._ext_ladder(96, 32, 122, 20, 32, False) == (0,)
    shape = (64, 120, 5, 19, 8, 0, 1, 2, True)
    reg, rt = cs.plan_admm(*shape), cs.plan_admm(*shape, runtime_r=True)
    assert (reg.ext, rt.ext) == (0, cs.EXT_RT)
    assert (reg.variant, reg.warps, reg.tps, reg.staged) == \
        (rt.variant, rt.warps, rt.tps, rt.staged)
    assert (reg.library, rt.library) == ("stagewise", "stagewise_extra")
    # no cap on r: a thousand extra rows still plan, with every array of
    # theirs in device memory
    big = cs.plan_admm(64, 120, 5, 19, 8, 0, 1000, 2, True)
    assert big.ext == cs.EXT_RT | cs.EXT_AK | cs.EXT_CW
    assert cs.plan_admm(64, 120, 5, 19, 8, 0, 20000, 2, True).ext & \
        cs.EXT_VEC
    assert big.smem <= ca.SMEM_MAX


def test_runtime_r_wrapper_refuses_a_cpu_tensor():
    """K5's wrapper takes CUDA tensors only, past the register path too:
    a CPU tensor runs the plain loop through ``stagewise_admm_solve``."""
    M, N, window = FLEETS["five_b20_r6"]
    tc, price, x0, _ = SMOKE.fleet_controller(M, N, "cpu", window)
    sw = tc._sw
    q, l, u = tsw.assemble_stagewise(sw, torch.as_tensor(
        x0, dtype=torch.float32))
    eu = tsw.assemble_stagewise_ext(sw, torch.as_tensor(x0,
                                                        dtype=torch.float32))
    z = torch.clamp(torch.zeros_like(l), l, u)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cs.sw_admm_cuda(sw, q, l, u, torch.zeros_like(q), z,
                        torch.zeros_like(l), torch.zeros_like(eu),
                        torch.zeros_like(eu), eu, 5)
