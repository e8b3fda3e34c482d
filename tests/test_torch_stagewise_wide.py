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


# ---- the wide sweep (bmax 32 to 128): packed factors, its order, its ring
# (csrc/stagewise.cu "the wide sweep"; the kernels run only on the card) ----


def _random_factors(N, b, seed):
    """(L, U⁻¹, C), each (N, b, b) fp32, entries of N(0, 0.3²/b)."""
    rng = np.random.default_rng(seed)
    return tuple(torch.as_tensor(rng.normal(0.0, 0.3 / b ** 0.5, (N, b, b)),
                                 dtype=torch.float32) for _ in range(3))


@pytest.mark.parametrize("b", [20, 32, 33, 64, 128])
def test_wide_packing_rebuilds_the_factors(b):
    """``pack_wide``'s buffer read at the kernels' flat offsets (factor f,
    stage k, row i, column j at word (f·N + k)·pad4(b²) + j·b + i) gives L,
    U⁻¹ and C back exactly; each block's padding is zero and every block
    starts at a multiple of 4 words (16 bytes, as a bulk copy needs)."""
    N = 3
    F = _random_factors(N, b, b)
    packed = cs.pack_wide(F)
    bs = cs.wide_block_words(b)
    assert bs % 4 == 0 and b * b <= bs < b * b + 4
    assert tuple(packed.shape) == (3, N, bs) and packed.is_contiguous()
    assert cs.factor_words(N, b, 32) == N * bs
    flat = packed.reshape(-1).numpy()
    i, j = np.arange(b)[:, None], np.arange(b)[None, :]
    for f in range(3):
        for k in range(N):
            base = (f * N + k) * bs
            np.testing.assert_array_equal(flat[base + j * b + i],
                                          F[f][k].numpy())
            assert not flat[base + b * b:base + bs].any()


def _wide_sweep_emulated(packed, r):
    """x = K⁻¹ r in the wide sweep's order on its packed buffer, in fp32:
    the forward chain y_k = r_k − L_k y_{k−1}, then a_k = U⁻¹_k y_k for
    every k, then the backward chain x_k = a_k − C_k x_{k+1}; each row
    summed over the columns in order, as the kernels sum it."""
    flat = packed.reshape(-1).numpy()
    P, N, b = r.shape
    bs = cs.wide_block_words(b)

    def block(f, k):               # (i, j) from word j·b + i
        base = (f * N + k) * bs
        return flat[base:base + b * b].reshape(b, b).T

    def rows(M, v):                # Σ_j M[i, j] v[j], j = 0 … b−1 in order
        acc = np.zeros((P, b), np.float32)
        for j in range(b):
            acc = acc + M[:, j][None, :] * v[:, j:j + 1]
        return acc

    y = np.zeros((P, N, b), np.float32)
    prev = np.zeros((P, b), np.float32)
    for k in range(N):
        prev = r[:, k] - rows(block(0, k), prev)
        y[:, k] = prev
    a = np.stack([rows(block(1, k), y[:, k]) for k in range(N)], axis=1)
    x = np.zeros_like(y)
    nxt = np.zeros((P, b), np.float32)
    for k in range(N - 1, -1, -1):
        nxt = a[:, k] - rows(block(2, k), nxt)
        x[:, k] = nxt
    return x


@pytest.mark.parametrize("key", list(FLEETS))
def test_wide_sweep_order_matches_solve_K(key):
    """The wide sweep's order (forward chain, then U⁻¹_k y_k off the chain,
    then x_k = a_k − C_k x_{k+1}), emulated in fp32 on the packed factors,
    against the port's ``_solve_K`` (K4's plain version) and the JAX
    package's ``_solve_K`` at the five-battery (b = 20) and fleet (b = 32)
    frames: within 2e-5 of max |x| (fp32 rounding of the same factors
    summed in other orders; cond of the sweeps ~1e2 at these frames)."""
    M, N, window = FLEETS[key]
    model, w, extra, price, x0 = _fleet_ref(M, N, window)
    js = jsw.prepare_stagewise(model, N, w, extra=extra)
    ts = convert.stagewise_qp(js, "cpu")
    r = np.random.default_rng(M).normal(size=(4, N, ts.b)).astype(np.float32)
    got = _wide_sweep_emulated(cs.pack_wide(ts.factors), r)
    port = tsw._solve_K(ts, torch.as_tensor(r)).numpy()
    ref = np.asarray(jsw._solve_K(js, jnp.asarray(r)))
    scale = np.abs(ref).max()
    assert np.abs(port - ref).max() <= 2e-5 * scale
    assert np.abs(got - port).max() <= 2e-5 * scale
    assert np.abs(got - ref).max() <= 2e-5 * scale


def test_k4_packs_once_per_factor_tuple():
    """K4's wrapper packs a factor tuple once and reuses it while none of
    its tensors changes in place; another tuple, or an in-place change,
    packs anew."""
    F = _random_factors(4, 20, 0)
    a = cs._packed_for_k4(F)
    assert cs._packed_for_k4(F) is a
    assert torch.equal(a, cs.pack_wide(F))
    G = tuple(f.clone() for f in F)
    assert cs._packed_for_k4(G) is not a
    F[1].mul_(2.0)
    b = cs._packed_for_k4(F)
    assert b is not a and torch.equal(b, cs.pack_wide(F))


# (P, N, b, m, S, n_blk, n_ext, n_cons, mean) -> the variant, the ring's
# depth and the CTA's bytes without the ring (the plan each shape had
# before the ring):
# the fleet (N = 96, b = 32), sixteen (b = 64) and thirty-two batteries (b
# = 128), global with factors through L2; five batteries (b = 20) and the ω
# tree (b = 20, S = 16), staged, so no ring
RING_PLANS = {
    "fleet_b32": ((8, 96, 32, 122, 1, 0, 20, 0, False), ("global", 8, 70096)),
    "b64": ((8, 48, 64, 242, 1, 0, 22, 0, False), ("global", 4, 163184)),
    "b128": ((8, 24, 128, 482, 1, 0, 35, 0, False), ("global", 2, 37584)),
    "b20_shared": ((8, 8, 20, 77, 1, 0, 6, 0, False), ("shared", 0, 72944)),
    "omega_tree": ((128, 24, 20, 76, 16, 0, 4, 4, True),
                   ("grouped", 0, 229072)),
}


@pytest.mark.parametrize("key", list(RING_PLANS))
def test_wide_plan_ring_depth_and_bytes(key):
    """Above bmax 16 with the factors through L2, K5's plan adds the
    deepest ring of RING_DEPTHS that fits beside what the plan held before
    (8 at the fleet, 4 at b = 64, 2 at b = 128, whose next depth does not
    fit); staged shapes keep their plan and take no ring; the bytes are
    ``ring_words`` (the mbarriers, then the blocks)."""
    shape, (variant, depth, held) = RING_PLANS[key]
    P, N, b, m, S, n_blk, n_ext, n_cons, mean = shape
    pl = cs.plan_admm(*shape)
    assert (pl.variant, pl.ring, pl.staged) == (variant, depth, depth == 0)
    assert pl.smem == held + 4 * cs.ring_words(depth, b) <= ca.SMEM_MAX
    if pl.variant == "shared":
        bare = cs.admm_smem_bytes(N, b, m, S, n_blk, n_ext, n_cons, mean,
                                  pl.warps, pl.staged, pl.bmax, pl.ext)
    else:
        bare = cs.flex_smem_bytes(N, b, m, n_blk, n_ext, n_cons, mean,
                                  pl.warps, pl.staged, pl.bmax, pl.spc,
                                  cs.ADMM_PLACES[pl.variant], pl.ext, S=S)
    assert bare == held
    if depth:
        assert cs.ring_words(depth, b) == 2 * depth + depth * b * b
        deeper = [d for d in cs.RING_DEPTHS if d > depth]
        assert all(held + 4 * cs.ring_words(d, b) > ca.SMEM_MAX
                   for d in deeper)


def test_wide_odd_b_is_never_staged():
    """Above bmax 16 the packed blocks of an odd b are padded apart, which
    K5's staged layout (N·b² words) does not hold: the plan streams them
    through the ring, and forcing the staged variant raises; an even b
    stages as before (its blocks need no padding)."""
    for b in (17, 33, 127):
        pl = cs.plan_admm(4, 10, b, 2 * b)
        assert not pl.staged and pl.ring in cs.RING_DEPTHS, (b, pl)
        with pytest.raises(ValueError, match="odd b"):
            cs.plan_admm(4, 10, b, 2 * b, staged=True)
        assert cs.wide_block_words(b) > b * b
    for b in (20, 32, 34):
        assert cs.wide_block_words(b) == b * b
        assert cs.plan_admm(4, 10, b, 2 * b).staged


def test_wide_k4_plan_ring():
    """K4 above bmax 16 unstaged: one warp a block (each ring its own SM's
    copy engine and L2 bandwidth), the deepest ring that fits beside the
    warp's r/y buffer: 8 at the fleet's factors and at b = 64 (N = 48), 2
    at b = 128 (N = 24); staged shapes take none."""
    for (N, b), (depth, staged) in {(96, 32): (8, False),
                                    (48, 64): (8, False),
                                    (24, 128): (2, False),
                                    (8, 20): (0, True)}.items():
        pl = cs.plan_sweep(8, N, b)
        assert (pl.ring, pl.staged) == (depth, staged)
        assert pl.warps == (1 if depth else 4)
        assert pl.smem == cs.sweep_smem_bytes(N, b, pl.warps, pl.staged,
                                              pl.bmax, pl.ring)
    assert cs.plan_sweep(8, 96, 32).smem == 4 * (96 * 32 + 16 + 8 * 1024)


def test_wide_ring_mirrors_the_kernel_source():
    """The ring's words, its depths and where it lies in each layout are
    the kernel's (``ring_words``, ``ring_ok``, behind ``admm_layout``'s
    arrays, in ``flex_layout``'s slot, K4's ``smem_bytes``); the packed
    blocks' words are
    ``wide_block``; each export takes the ring."""
    import os

    src = open(os.path.join(os.path.dirname(__file__), "..",
                            "pyhybridcontrol_tpu_torch", "csrc",
                            "stagewise.cu")).read()
    for line in (
            "return pad4((size_t)b * b);",
            "return D ? pad4(2 * (size_t)D) + (size_t)D * wide_block(b) : 0;",
            "return bmax > 16 && !staged ? ring == 2 || ring == 4 || ring == 8",
            "warps, staged, bmax, ext).total +\n                          ring_words(ring, b));",
            "if constexpr (RING) rb = smem + lay.total;",
            "a.ring = sl; sl += ring_words(ring, b);",
            "constexpr bool RING = WIDE && !STAGED;",
            "const int ring = RING ? a.ring : 0;",
            "2u * (unsigned)N * (unsigned)a.iters);",
            "FactorRing g = ring_of(ys + yn, ring, b, N, L, U, C, 3, 3u * N);",
            "int bmax, int ext, int ring) {",
            "int staged, int bmax, int ring, void* stream) {"):
        assert line in src, line
    assert cs.RING_DEPTHS == (8, 4, 2)
    assert [cs.ring_words(d, 5) for d in (0, 2, 4, 8)] == [0, 4 + 56,
                                                           8 + 112, 16 + 224]


def _ring_schedule(N, D, parts, iters):
    """The ring's fills and waits as the kernels run them, mirrored: the
    D fills issued first, then per read fill n (in the order the sweeps
    read: per iteration ``parts`` passes of N blocks) fill n + D issued
    below stop = parts·N·iters. Returns (block read, block filled) of
    every read, and the fills issued."""
    stop = parts * N * iters
    issued = list(range(min(D, stop)))
    reads = []

    def block(n):
        m = n % (parts * N)
        p, j = divmod(m, N)
        return p, (N - 1 - j if p == parts - 1 else j)

    for n in range(stop):
        assert n in issued, "a wait on a fill never issued"
        # the slot's previous fill was read before this one was issued
        assert issued.index(n) < D or n - D < n
        reads.append(block(n))
        if n + D < stop:
            issued.append(n + D)
    return reads, issued


@pytest.mark.parametrize("N,D,parts,iters", [(96, 8, 2, 3), (5, 8, 2, 2),
                                             (24, 2, 3, 1), (3, 4, 3, 1)])
def test_wide_ring_reads_the_sweeps_blocks_in_order(N, D, parts, iters):
    """Every fill the sweeps wait on has been issued, each once, every
    issued fill is read (none in flight at the end), and the blocks come
    in the sweeps' order: L_0 … L_{N−1}, (K4) U⁻¹_0 … U⁻¹_{N−1}, C_{N−1} …
    C_0, iteration after iteration."""
    reads, issued = _ring_schedule(N, D, parts, iters)
    assert sorted(issued) == list(range(parts * N * iters))
    one = ([(0, k) for k in range(N)]
           + ([(1, k) for k in range(N)] if parts == 3 else [])
           + [(parts - 1, k) for k in range(N - 1, -1, -1)])
    assert reads == one * iters
