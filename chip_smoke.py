"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Run from the root of a checkout. It builds the kernels of
``pyhybridcontrol_tpu_torch/csrc/`` with nvcc, then:

  1. prints the card's name and power limit (nvidia-smi) and the build time;
  2. K1 (σ=0 batched ADMM) against its plain torch version on the card:
     config 1's enumeration batch (N=10, B=1024, 400 iterations) and the
     bench-primary batch (N=20, B=4096, 100 iterations, cold and warm),
     plus an infeasible instance; median CUDA-event times of both;
  3. K2 (fused B&B wave) against its plain version: config 1's wave
     (N=10, B=32, 400+400 iterations, stiff probe) and N=20 (B=4096),
     cold and warm-started (every B&B wave after the root is warm);
  4. K1 and K2 far from convergence (config 1, 30 iterations, 15+15 probe
     iterations), where a wrong step — over-relaxation, iteration count,
     a swapped output — shows, at batch sizes 1, 3, 32, 33 and 257, with
     and without the stiff probe; and the shape limit: asked to stage
     constants that do not fit in shared memory (N=60), the wrapper must
     refuse, not fall back, and the plan streams them; every problem-tile
     instantiation of K1/K2 (8, 4, 1 problems per block) at batches
     that are no multiple of the tile, and the instantiation, threads and
     shared memory the wrapper's plan picks at each main shape;
  5. K1's split-precision phase (``low_frac``, bf16 3-pass products on
     the tensor cores) against its plain version at the reference test's
     shape (N=12, B=128, 120 iterations) and at the bench primary (N=20,
     B=4096, 100 iterations): the tensor-core kernel's own outputs (the
     iterates z_G, y_G, z_B, y_B) after ONE split-precision iteration
     from the same warm iterates (the plain version's after 10 and 50
     iterations), before the bf16 steps drift apart, and objective and
     solution of the whole solve at ``low_frac`` 0.8 and 1.0; then the
     reference bench's own gate: max relative objective delta of
     ``low_frac=1.0`` against full-precision K1 ≤ 1e-4. Both tile widths
     of the kernel (16 and 32 problems per block) at batches that leave a
     ragged last tile (N=12: B=1, 33, 4095; N=20: B=4095) and N=21 (a tile
     of 16 only), one iteration at every width and the whole solve at the
     plan's; the plan against the library's own reckoning; its plan
     must refuse N=22, whose constants do not fit, which routes to K1's
     split mode (phase 10);
  6. no plain version behind a CUDA tensor: with the plain versions made
     to raise, ``admm_solve_auto``, ``admm_wave_auto`` and
     ``admm_solve_cuda(low_frac>0)`` still answer and count their launches,
     at N=10 and at N=27 (streamed variants, split mode);
  7. the single-state serving path: the port's serve stdin loop, in process,
     on ``--config double_integrator --device cuda`` — a ping, four
     feasible states, one state outside the box, quit. Every feasible
     objective must be within ``serve_limit`` of the port's enumeration
     solver on the card (600 iterations); the out-of-box state must come back
     found=false; K2's launch count must grow during the phase;
  8. the batched serving path: ``--config scenario_batch`` (config 4, full
     width: N=10, 1024 instances, pool 32,768, global wave 1024) — one
     2-D request of 1024 seeded states, one of them outside the box,
     through the stdin loop. The reply is list-valued; the out-of-box
     instance is found=false; on a fixed sample of 64 instances ``found``
     and the objective (``serve_limit``) agree with the enumeration
     controller on the card; every K2 launch had B=1024. Then ``solve_miqp_bnb_pooled`` with
     the reference bench's config-4 spec (wave 1024, probe_patience=3,
     pool 8·B), once from nothing and once carrying the first call's
     incumbents: objectives within ``serve_limit`` of the request's; the probe gate
     closes on the second only, where K1 must launch at B=1024. Then the
     relaxation sweep that uses the split-precision phase (N=20, B=4096,
     ``low_frac=1.0``);
  9. K1/K2 with the constants streamed from device memory (shapes whose
     Â_G and Mᵀ a block cannot stage) against their plain versions:
     random problems of the sizes of the double integrator at N=27 and of
     the reference bench's configs 3, 4b, 4c and 2 at B = 1, 37 and 300;
     the streamed variant forced at N=26 against the staged one; the
     times at the N=27 paths' shapes;
 10. K1's split mode (the split-precision phase where the tensor-core
     kernel refuses the shape, N ≥ 22): one split iteration from the
     plain version's iterates, the whole solve's objective and solution
     at N=22, 24 and 27, and the bench's 1e-4 gate at N=24;
 11. config 1 of the reference bench as a closed loop: N=10, T=20 from
     [2, 0], B&B (capacity 256, wave 32, 48 waves, 200 iterations, probe
     at ρ=10); ms per control step, found share, mean nodes; held against
     the port's enumeration loop (total cost rtol 2e-3, states 1e-2);
 12. the N=27 double integrator: a closed loop of 4 steps (K2 streamed)
     that must find every step, follow the dynamics and end nearer the
     origin, then the relaxation sweep at ``low_frac=1.0`` (K1 streamed in
     split mode) against its plain version.

Launch counts are kept per path: they are set to 0 just before each of
the served config-1 requests, the served 1024-state request, the
bench-spec pooled call, the pooled call with carried incumbents, the
relaxation sweep, the config-1 closed loop, the N=27 closed loop and the
N=27 sweep, and read just after it; launches made to compare a
kernel with its plain version or with enumeration fall in none of them.
A kernel's ``launches`` is its sum over these paths, ``launches_by_path``
the counts apart, and ``on_main_path`` says whether a served request
launched it.

Every kernel result is held against its plain version field by field:
obj, x, z, y, r_prim, r_prim_rel and r_dual within LIMITS, certificate
bits identical. Every phase draws its problems from a generator of its
own (``--seed N`` moves them all), so no phase's problems depend on what
ran before it. ``--readings`` reads every field of every kernel comparison
without stopping at the first one off its limit, lists those, and fails:
it is how the limits are set, over several seeds. Each kernel's line
carries its time at the shape the main path gives it -- ``ms`` around the
wrapper call (checks, allocation, launch), ``kernel_ms`` around the launch
alone -- its plain version's time and its bound: the larger of the
bytes it must move over the card's memory rate and its operations over
the card's peak rate for their type (NVIDIA H100 SXM data sheet).

Any failed check raises, so the script exits non-zero. It exits non-zero
without a result when no CUDA device is present or when the package is
missing beside it. The last lines are the closed loops' JSON, the card's
name and power limit, the kernels JSON and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = {"admm_k1": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_mixed": "pyhybridcontrol_tpu_torch/csrc/admm_mixed.cu",
           "admm_k1_streamed": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2_streamed": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_split": "pyhybridcontrol_tpu_torch/csrc/admm.cu"}
REPLACES = {"admm_k1": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_mixed": "pyhybridcontrol_tpu/ops/pallas_admm.py:180",
            "admm_k1_streamed": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2_streamed": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_split": "pyhybridcontrol_tpu/ops/pallas_admm.py:180"}
# the driven paths, in order; the first two are served requests
SERVED = ("serve_config1", "serve_batch_request")
PATHS = SERVED + ("pooled_bench_spec", "pooled_carried_incumbents",
                  "relax_sweep_low_frac", "closed_loop_config1",
                  "closed_loop_N27", "relax_sweep_N27_low_frac")
# peak rates of one H100 SXM at 700 W (NVIDIA data sheet): fp32 outside
# the tensor cores, dense bf16 in them, HBM3
PEAK = dict(fp32=67e12, bf16=989e12, hbm=3.35e12)
SEED = 0
# Kernel vs plain version, both fp32 on the card: the sums run in another
# order (and the kernel fuses multiply-adds), so the iterates carry fp32
# noise, which grows with the iteration count. Error of a field: max over
# the batch of |Δ| / max(|ref|, FLOOR) — for the solution fields an
# absolute error where |ref| < 1 and a relative one above; for the
# residuals an absolute error below 1e-3, the scale at which B&B reads
# them (feas_tol), and a relative one above (a swapped residual differs
# from the right one by a factor, not by an offset). Limits per regime:
# "main", the shapes of phases 2-3 (100-400 iterations), and "far",
# phase 4 (30 iterations).
FLOOR = dict(obj=1.0, x=1.0, z=1.0, y=1.0, r_prim=1e-3, r_prim_rel=1e-3,
             r_dual=1e-3)
# Limits: 3-5x the largest error of sound runs on an H100 over seeds 0-7
# (PERF.md has the readings, and the faults each regime catches). The
# split-precision phase: a last-bit difference of an operand can move its
# bf16 hi part by one step, so kernel and plain version differ at the
# 2^-17 level per product, not at fp32's 2^-24; the dual step multiplies
# that by ρ (up to 300 on boosted rows), and the iterates drift apart as
# the iterations go (y by 2e-2 after two). So the tensor-core kernel's own
# outputs are held after ONE iteration from the same warm iterates
# ("mixed_iterates"; a dropped bf16 pass reads 5e-2 and more on z there),
# and the whole solve (100-120 iterations, K1's tail and stats included)
# on objective and solution only ("mixed"): its residuals differ by 0.7
# and more on sound runs.
LIMITS = {
    "main": dict(obj=1.5e-4, x=4e-4, z=4e-4, y=1.5e-2, r_prim=0.2,
                 r_prim_rel=0.2, r_dual=4.0),
    "far": dict(obj=3e-5, x=2e-4, z=3e-4, y=8e-3, r_prim=3e-2,
                r_prim_rel=3e-2, r_dual=0.7),
    "mixed": dict(obj=1e-4, x=0.1),
    "mixed_iterates": dict(zG=3e-3, yG=8e-2, zB=3e-3, yB=1e-3),
    # the double integrator at the staging cap and above (N=26-27): a
    # longer horizon is worse conditioned, so the same fp32 noise grows
    # more in 100-400 iterations (the plain version's own fp32-vs-fp64
    # difference: tests/test_torch_kernels.py::
    # test_fp32_noise_grows_with_the_horizon); 4x the "main" limits
    "large": dict(obj=6e-4, x=1.6e-3, z=1.6e-3, y=6e-2, r_prim=0.8,
                  r_prim_rel=0.8, r_dual=16.0),
}
# the iterate check starts from the plain version's iterates after these
# many split-precision iterations
MIXED_WARM = (10, 50)
MIXED_GATE = 1e-4   # max relative objective delta, low_frac=1.0 vs full K1
# |obj(B&B) − obj(enumeration)| ≤ max(1e-3, SERVE_STEPS·2⁻²³·|obj|): the
# objectives are fp32, so above |obj| ≈ 44 the limit follows fp32's
# resolution. SERVE_STEPS is ~3× the largest reading above the floor of
# sound runs over seeds 0-7, in units of 2⁻²³·|obj|: 66.6 of them, 1.94e-3 at
# obj −243.9 (PERF.md has the readings). B&B solves its nodes with 100
# ADMM iterations, enumeration with 600, so the two objectives differ by
# more than rounding.
SERVE_FLOOR = 1e-3
SERVE_STEPS = 192
BATCH = 1024        # config 4: instances of one batched request
BATCH_SAMPLE = tuple(range(0, BATCH, 16))   # 64 instances held to enumeration
BATCH_OUT_OF_BOX = 5                        # instance replaced by OUT_OF_BOX
STATES = ([2.0, 0.0], [-3.0, 1.0], [5.0, -1.0], [0.5, 0.5])
OUT_OF_BOX = [12.0, 0.0]   # |x| ≤ 10 box of the double integrator
FAR_ITERS = 30             # far from convergence at config 1
FAR_BATCHES = (1, 3, 32, 33, 257)


def check(cond, what):
    if not cond:
        raise AssertionError(what)


def serve_limit(obj_ref):
    """Limit on |obj − obj_ref| of a served objective (scalar or array)."""
    import numpy as np

    return np.maximum(SERVE_FLOOR,
                      SERVE_STEPS * 2.0 ** -23 * np.abs(obj_ref))


def serve_reading(tag, d, obj_ref):
    """Print the worst |Δobj| of a serve phase (largest share of its limit)
    with its objective, in units of 2⁻²³·|obj|, and its limit; raise if it
    is over."""
    import numpy as np

    d, obj_ref = np.atleast_1d(d), np.atleast_1d(obj_ref)
    lim = serve_limit(obj_ref)
    i = int(np.argmax(d / lim))
    steps = d[i] / (2.0 ** -23 * max(abs(obj_ref[i]), 1e-30))
    print(f"  {tag}: worst |Δobj| {d[i]:.2e} at obj {obj_ref[i]:.1f} "
          f"({steps:.1f} × 2⁻²³·|obj|), limit {lim[i]:.2e}", flush=True)
    check(d[i] <= lim[i], f"{tag}: |Δobj|={d[i]:.3e} at obj "
          f"{obj_ref[i]:.1f}, limit {lim[i]:.3e}")


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=5):
    """Median CUDA-event time of fn() in ms (after one warmup call)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


KERNEL_FUNCTIONS = (("admm", "phc_admm_k1"), ("admm", "phc_admm_k2"),
                    ("admm_mixed", "phc_admm_k1_mixed"))


def kernel_ms(fn, reps=5):
    """Median over ``reps`` calls of fn() of the time of the kernel
    launches inside it alone: CUDA events recorded just before and after
    each call into the kernel library, summed per fn() (after one warmup
    call)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import _build

    pairs = []

    def shim(orig):
        def call(*a):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = orig(*a)
            e1.record()
            pairs.append((e0, e1))
            return rc
        return call

    saved = [(_build.load_library(lib), name) for lib, name in
             KERNEL_FUNCTIONS]
    saved = [(lib, name, getattr(lib, name)) for lib, name in saved]
    fn()
    for lib, name, orig in saved:
        setattr(lib, name, shim(orig))
    try:
        times = []
        for _ in range(reps):
            pairs.clear()
            fn()
            torch.cuda.synchronize()
            times.append(sum(a.elapsed_time(b) for a, b in pairs))
    finally:
        for lib, name, orig in saved:
            setattr(lib, name, orig)
    return sorted(times)[len(times) // 2]


def admm_work(nr, mGp, B, products, stats, warm, stiff=False, lo_products=0,
              outputs=1):
    """(bytes, {type: operations}) of a batched σ=0 ADMM kernel call, from
    its shapes: each input read once, each output written once; one
    product pair (Â_Gᵀw, M t) is 2·(mGp·nr + (mGp+nr)·nr) operations per
    problem, a stats block 2·nr² + 4·mGp·nr. ``lo_products`` of the
    products are 3-pass bf16 (tensor cores)."""
    R = mGp + nr
    per_problem_in = 3 * nr + 2 * mGp + (2 * R if warm else 0)
    per_problem_out = outputs * (3 * nr + 2 * mGp + 8)
    consts = mGp * nr + nr * R + nr * nr + 6 * nr + 3 * mGp
    if stiff:
        consts += nr * R + 6 * nr + 3 * mGp + nr
    if lo_products:
        consts += mGp * nr + nr * R      # bf16 hi/lo pairs: 2 × 2 bytes
    pair = 2 * (mGp * nr + R * nr)
    ops = dict(fp32=B * (products * pair
                         + stats * (2 * nr * nr + 4 * mGp * nr)))
    if lo_products:
        ops["bf16"] = B * lo_products * 3 * pair
    return 4 * (B * (per_problem_in + per_problem_out) + consts), ops


def bound(nbytes, ops):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type (the units work side by
    side, so the slowest of them bounds, not their sum)."""
    t_bytes = nbytes / PEAK["hbm"]
    t_ops = max(v / PEAK[k] for k, v in ops.items())
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def chain_ms(nr, mGp, iterations):
    """Reckoned floor of ONE problem's dependent iteration chain in K1/K2
    with one problem per block (what bounds a batch too small to fill the
    card, where the roofline bound says nothing): per iteration the serial
    FMA chains of the two products — mGp/8 and nr/2 FMAs at 4 cycles each —
    their 3 + 1 shuffle steps of ~25 cycles, two shared-memory load
    latencies of ~30 cycles and two block-wide barriers of ~20 cycles, at
    the 1.98 GHz boost clock. The latencies are assumed round figures, not
    measured."""
    cycles = 4 * (mGp // 8 + nr // 2) + 4 * 25 + 2 * 30 + 2 * 20
    return 1e3 * iterations * cycles / 1.98e9


def set_bound(rec, kq, B, **kw):
    rec["bound_ms"], rec["bound_by"] = bound(
        *admm_work(kq.n_pad, kq.m_pad, B, **kw))
    # no single PyTorch call computes a batch of ADMM solves
    rec["library_ms"] = None


def problem(N, B, dev, rng, fix_frac=0.0):
    """Double integrator at horizon N: prepared specs and a batch of B
    seeded states; with fix_frac>0 each problem fixes that fraction of its
    binaries at random (B&B-node boxes)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc

    c = CondensedMpc(switched_double_integrator(), N, di_default_weights())
    qp = c.device_qp(dev)
    spec = prepare_admm_mpc(c, device=dev)
    spec_p = prepare_admm_mpc(c, rho=10.0, device=dev)
    x0s = torch.as_tensor(rng.normal(size=(B, 2)).astype(np.float32),
                          device=dev)
    f, h = qp.assemble(x0s)
    lb = qp.lb.expand(B, qp.n).clone()
    ub = qp.ub.expand(B, qp.n).clone()
    if fix_frac > 0:
        nb = qp.n_binary
        fm = rng.uniform(size=(B, nb)) < fix_frac
        fv = (rng.uniform(size=(B, nb)) < 0.5).astype(np.float32)
        bidx = torch.as_tensor(qp.binary_idx, device=dev)
        fm_t = torch.as_tensor(fm, device=dev)
        fv_t = torch.as_tensor(fv, device=dev)
        lb[:, bidx] = torch.where(fm_t, fv_t, 0.0)
        ub[:, bidx] = torch.where(fm_t, fv_t, 1.0)
    return c, qp, spec, spec_p, f, h, lb, ub


def phase_rng(name):
    """Generator of one phase's problems, seeded by SEED and the phase's
    name: adding a phase or a shape elsewhere changes no other phase's
    problems."""
    import numpy as np

    return np.random.default_rng([SEED, *name.encode()])


def held(tag, regime, pairs):
    """Each (got, ref) pair of ``pairs`` within its limit of the regime:
    error = max |Δ| / max(|ref|, floor)."""
    import torch

    limits, seen = LIMITS[regime], READINGS.setdefault(regime, {})
    errs = {}
    for k, (g, r) in pairs.items():
        check(bool(torch.isfinite(g).all()), f"{tag}: non-finite {k}")
        errs[k] = float(((g - r).abs()
                         / torch.clamp_min(r.abs(), FLOOR.get(k, 1.0))).max())
        seen[k] = max(seen.get(k, 0.0), errs[k])
    print(f"  {tag}: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items()),
          flush=True)
    for k, v in errs.items():
        if v > limits[k] and READINGS_ONLY:
            OVER.append(f"{tag}: {k} off by {v:.3e}, limit {limits[k]:.1e}")
            continue
        check(v <= limits[k], f"{tag}: {k} off by {v:.3e}, limit "
              f"{limits[k]:.1e}")


def compare(tag, got, ref, record, regime="main"):
    """Kernel result vs plain result (AdmmResult), on every field the
    regime has a limit for; raises if a field is off its limit or the
    certificate bits differ."""
    import torch

    held(tag + f" certs={int(got.infeas_cert.sum())}", regime,
         {k: (getattr(got, k), getattr(ref, k)) for k in LIMITS[regime]})
    check(torch.equal(got.infeas_cert, ref.infeas_cert),
          f"{tag}: infeasibility certificate bits differ")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0),
                                float((got.obj - ref.obj).abs().max()),
                                float((got.x - ref.x).abs().max()))


# K2's probe fixes every binary to the ROUNDED relaxation, so where a
# relaxed binary lies within fp32 noise of 0.5 the kernel and the plain
# version may round it to different sides and then solve different probes.
# Such instances are left out of the probe comparison, and held instead to:
# at most FLIP_SHARE of the batch, and every binary rounded differently
# within FLIP_BAND of 0.5 in the plain version's relaxation.
FLIP_SHARE = 2e-3
FLIP_BAND = 2e-3


def compare_probe(tag, got, ref, qp, lb, ub, record, regime="main"):
    """K2's (relax, probe) against the plain version's: the relaxation on
    every instance, the probe on the instances whose binaries both rounded
    the same way (see FLIP_SHARE)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import AdmmResult

    compare(tag + " relax", got[0], ref[0], record, regime)
    bidx = torch.as_tensor(qp.binary_idx, device=lb.device)

    def rounded(res):
        return torch.round(torch.clamp(torch.clamp(
            res.x[:, bidx], lb[:, bidx], ub[:, bidx]), 0.0, 1.0))

    differ = rounded(got[0]) != rounded(ref[0])
    same = ~differ.any(-1)
    flips = int((~same).sum())
    if flips:
        off = float((ref[0].x[:, bidx][differ] - 0.5).abs().max())
        print(f"  {tag}: {flips} of {same.numel()} instances round a "
              f"relaxed binary within {off:.1e} of 0.5 to the other side; "
              f"probe held on the rest", flush=True)
        for ok, what in (
                (flips <= max(1, FLIP_SHARE * same.numel()),
                 f"{tag}: {flips} instances with probe bounds that differ"),
                (off <= FLIP_BAND, f"{tag}: a binary {off:.2e} from 0.5 "
                 f"was rounded differently")):
            if READINGS_ONLY and not ok:
                OVER.append(what)
            else:
                check(ok, what)
    got_p, ref_p = (AdmmResult(**{k: v[same] for k, v in vars(r).items()})
                    for r in (got[1], ref[1]))
    compare(tag + " probe", got_p, ref_p, record, regime)


READINGS = {}   # largest error per regime and field over the run
# --readings: a field off its limit is listed in OVER instead of stopping
# the run, so that one run reads every field (the run then fails at its end)
READINGS_ONLY = False
OVER = []


def phase_k1(dev, rng, rec):
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm
    from pyhybridcontrol_tpu_torch.solver.enumerate import _all_assignments

    print("K1 (admm_k1) vs plain:", flush=True)
    # config 1's enumeration batch: all 2^10 gear sequences of one state
    c, qp, spec, _, f, h, lb, ub = problem(10, 1, dev, rng)
    asg = torch.as_tensor(_all_assignments(qp.n_binary), device=dev)
    B = asg.shape[0]
    bidx = torch.as_tensor(qp.binary_idx, device=dev)
    lb = qp.lb.expand(B, qp.n).clone()
    ub = qp.ub.expand(B, qp.n).clone()
    lb[:, bidx] = asg
    ub[:, bidx] = asg
    args = (ca.kernel_qp_for(spec), f.expand(B, -1).contiguous(),
            h.expand(B, -1).contiguous(), lb, ub)
    got = ca.admm_solve_cuda(*args, iters=400)
    ref = ca.admm_solve_plain(*args, iters=400)
    compare("N=10 B=1024 400 it", got, ref, rec)
    rec["enum_ms"] = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=400))
    rec["enum_kernel_ms"] = kernel_ms(
        lambda: ca.admm_solve_cuda(*args, iters=400))
    rec["enum_plain_ms"] = cuda_ms(
        lambda: ca.admm_solve_plain(*args, iters=400))
    rec["enum_bound_ms"] = bound(*admm_work(
        args[0].n_pad, args[0].m_pad, B, products=401, stats=1,
        warm=False))[0]
    print(f"  N=10 B=1024 400 it: wrapper {rec['enum_ms']:.3f} ms, kernel "
          f"alone {rec['enum_kernel_ms']:.3f} ms, plain "
          f"{rec['enum_plain_ms']:.3f} ms, bound {rec['enum_bound_ms']:.4f} "
          f"ms", flush=True)

    # the shape batched serving gives K1: a probe-gated config-4 wave
    # (N=10, B=1024, 100 iterations, warm-started node boxes)
    _, _, spec4, _, f, h, lb, ub = problem(
        10, BATCH, dev, phase_rng("config4_wave"), fix_frac=0.3)
    args = (ca.kernel_qp_for(spec4), f, h, lb, ub)
    r0 = ca.admm_solve_plain(*args, iters=100)
    warm = (r0.x, r0.z, r0.y)
    got = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    ref = ca.admm_solve_plain(*args, iters=100, warm=warm)
    compare("N=10 B=1024 100 it warm (config-4 wave)", got, ref, rec)
    rec["ms"] = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=100,
                                                   warm=warm))
    rec["kernel_ms"] = kernel_ms(lambda: ca.admm_solve_cuda(
        *args, iters=100, warm=warm))
    rec["plain_ms"] = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100,
                                                          warm=warm))
    set_bound(rec, args[0], BATCH, products=101, stats=1, warm=True)
    print(f"  N=10 B=1024 100 it warm: wrapper {rec['ms']:.3f} ms, kernel "
          f"alone {rec['kernel_ms']:.3f} ms, plain {rec['plain_ms']:.3f} "
          f"ms, bound {rec['bound_ms']:.4f} ms ({rec['bound_by']})",
          flush=True)

    # bench primary: N=20, B=4096, 100 iterations, cold then warm
    _, _, spec20, _, f, h, lb, ub = problem(20, 4096, dev, rng)
    args = (ca.kernel_qp_for(spec20), f, h, lb, ub)
    got = ca.admm_solve_cuda(*args, iters=100)
    ref = ca.admm_solve_plain(*args, iters=100)
    compare("N=20 B=4096 100 it cold", got, ref, rec)
    warm = (ref.x, ref.z, ref.y)
    got_w = ca.admm_solve_cuda(*args, iters=100, warm=warm)
    ref_w = ca.admm_solve_plain(*args, iters=100, warm=warm)
    compare("N=20 B=4096 100 it warm", got_w, ref_w, rec)
    k = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=100))
    ka = kernel_ms(lambda: ca.admm_solve_cuda(*args, iters=100))
    p = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100))
    rec["n20_ms"], rec["n20_kernel_ms"], rec["n20_plain_ms"] = k, ka, p
    rec["n20_bound_ms"] = bound(*admm_work(
        args[0].n_pad, args[0].m_pad, 4096, products=101, stats=1,
        warm=False))[0]
    print(f"  N=20 B=4096 100 it: wrapper {k:.3f} ms, kernel alone "
          f"{ka:.3f} ms, plain {p:.3f} ms, bound "
          f"{rec['n20_bound_ms']:.4f} ms", flush=True)

    # infeasibility certificate: instance 0 has x0 ≤ 1 ∧ x0 ≥ 2
    n = 8
    spec_i = prepare_admm(np.vstack([np.eye(n)[:1], -np.eye(n)[:1]]),
                          np.eye(n), device=dev)
    B = 128
    q = torch.as_tensor(rng.normal(size=(B, n)).astype(np.float32),
                        device=dev)
    hh = torch.tensor([1.0, 2.0], device=dev).repeat(B, 1)
    hh[0] = torch.tensor([1.0, -2.0], device=dev)
    lo = torch.full((B, n), -10.0, device=dev)
    args = (ca.kernel_qp_for(spec_i), q, hh, lo, -lo)
    got = ca.admm_solve_cuda(*args, iters=400)
    ref = ca.admm_solve_plain(*args, iters=400)
    check(bool(got.infeas_cert[0]) and not bool(got.infeas_cert[1:].any()),
          "K1 certificate: must fire on instance 0 only")
    compare("infeasible instance 400 it", got, ref, rec)


def phase_k2(dev, rng, rec):
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K2 (admm_k2) vs plain:", flush=True)
    for N, B, iters, piters, tagk in ((10, 32, 400, 400, "cfg1"),
                                      (10, BATCH, 100, 100, ""),
                                      (20, 4096, 100, 100, "n20")):
        _, qp, spec, spec_p, f, h, lb, ub = problem(
            N, B, dev, rng if tagk else phase_rng("config4_wave"),
            fix_frac=0.3)
        args = (ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p),
                qp.binary_idx, f, h, lb, ub)
        kw = dict(iters=iters, probe_iters=piters)
        tag = f"N={N} B={B} {iters}+{piters} it"
        got = ca.admm_wave_cuda(*args, **kw)
        ref = ca.admm_wave_plain(*args, **kw)
        compare_probe(tag, got, ref, qp, lb, ub, rec)
        warm = (ref[0].x, ref[0].z, ref[0].y)
        got = ca.admm_wave_cuda(*args, warm=warm, **kw)
        ref = ca.admm_wave_plain(*args, warm=warm, **kw)
        compare_probe(tag + " warm", got, ref, qp, lb, ub, rec)
        # timed warm-started, as every wave after the root is; the bound
        # counts (iters+1) + p1 + (p2+1) product pairs and two stats blocks
        k = cuda_ms(lambda: ca.admm_wave_cuda(*args, warm=warm, **kw))
        ka = kernel_ms(lambda: ca.admm_wave_cuda(*args, warm=warm, **kw))
        p = cuda_ms(lambda: ca.admm_wave_plain(*args, warm=warm, **kw))
        b = bound(*admm_work(args[0].n_pad, args[0].m_pad, B,
                             products=iters + piters + 2, stats=2,
                             warm=True, stiff=True, outputs=2))
        pre = tagk + "_" if tagk else ""
        rec[pre + "ms"], rec[pre + "plain_ms"] = k, p
        rec[pre + "kernel_ms"] = ka
        rec[pre + "bound_ms"] = b[0]
        if not tagk:     # config 4's wave: the shape of the batched path
            rec["bound_by"], rec["library_ms"] = b[1], None
        chain = chain_ms(args[0].n_pad, args[0].m_pad, iters + piters + 2)
        rec[pre + "chain_ms"] = chain
        print(f"  {tag} warm: wrapper {k:.3f} ms, kernel alone {ka:.3f} "
              f"ms, plain {p:.3f} ms, bound "
              f"{b[0]:.4f} ms ({b[1]}), one problem's dependent chain "
              f"{chain:.4f} ms", flush=True)


def phase_far(dev, rng, recs):
    """K1 and K2 far from convergence, at odd batch sizes, with and
    without the stiff probe; then the shared-memory shape limit."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    print(f"K1/K2 far from convergence (N=10, {FAR_ITERS} it, probe "
          f"{FAR_ITERS // 2}+{FAR_ITERS - FAR_ITERS // 2}):", flush=True)
    kw = dict(iters=FAR_ITERS, probe_iters=FAR_ITERS)
    for N, B in [(10, b) for b in FAR_BATCHES] + [(21, 8)]:
        _, qp, spec, spec_p, f, h, lb, ub = problem(N, B, dev, rng,
                                                    fix_frac=0.3)
        kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
        args = (kq, f, h, lb, ub)
        compare(f"K1 N={N} B={B}",
                ca.admm_solve_cuda(*args, iters=FAR_ITERS),
                ca.admm_solve_plain(*args, iters=FAR_ITERS),
                recs["admm_k1"], "far")
        for stiff in (kq2, None):
            args = (kq, stiff, qp.binary_idx, f, h, lb, ub)
            got = ca.admm_wave_cuda(*args, **kw)
            ref = ca.admm_wave_plain(*args, **kw)
            tag = f"K2 N={N} B={B}" + (" stiff" if stiff else "")
            compare_probe(tag, got, ref, qp, lb, ub, recs["admm_k2"], "far")

    # every problem-tile instantiation at batches that are no multiple of
    # the tile: the last block's missing problems are masked in the kernel
    for N, B in ((10, 37), (21, 11)):
        _, qp, spec, spec_p, f, h, lb, ub = problem(N, B, dev, rng,
                                                    fix_frac=0.3)
        kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
        ref1 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=FAR_ITERS)
        args = (kq, kq2, qp.binary_idx, f, h, lb, ub)
        ref2 = ca.admm_wave_plain(*args, **kw)
        for pb in ca.TILES:
            tag = f"N={N} B={B} tile {pb}"
            compare("K1 " + tag,
                    ca.admm_solve_cuda(kq, f, h, lb, ub, iters=FAR_ITERS,
                                       pb=pb), ref1, recs["admm_k1"], "far")
            compare_probe("K2 " + tag + " stiff",
                          ca.admm_wave_cuda(*args, pb=pb, **kw), ref2, qp,
                          lb, ub, recs["admm_k2"], "far")

    # the plan at the main shapes, and the library's own shared-memory
    # reckoning beside the wrapper's
    lib = load_library()
    for N, B in ((10, BATCH), (10, 32), (20, 4096), (21, 8)):
        kq = ca.kernel_qp_for(problem(N, 1, dev, rng)[2])
        pl = ca.plan(B, kq.n_pad, kq.m_pad)
        need = lib.phc_admm_smem_bytes(kq.n_pad, kq.m_pad, pl.pb,
                                       int(pl.streamed))
        check(need == pl.smem, f"plan: N={N} B={B} reckons {pl.smem} bytes "
              f"of shared memory, the library {need}")
        print(f"  plan N={N} B={B}: tile of {pl.pb} problems, "
              f"{-(-B // pl.pb)} blocks of {pl.threads} threads, {pl.smem} "
              f"bytes of shared memory per block (limit {ca.SMEM_MAX}), "
              f"the same for K1 and K2", flush=True)
    fits = [N for N in range(20, 40) if ca.smem_bytes(
        -(-3 * N // 8) * 8, -(-10 * N // 8) * 8, 1) <= ca.SMEM_MAX]
    print(f"  largest horizon of this model whose constants a block can "
          f"stage: N={max(fits)}", flush=True)
    # above it the plan streams the constants (phase_streamed holds that
    # variant); asked to stage them, the wrapper refuses, it does not fall
    # back
    _, qp, spec, spec_p, f, h, lb, ub = problem(60, 2, dev, rng)
    kq = ca.kernel_qp_for(spec)
    args = (kq, ca.kernel_qp_for(spec_p), qp.binary_idx, f, h, lb, ub)
    try:
        ca.admm_wave_cuda(*args, streamed=False, **kw)
    except ValueError as e:
        print(f"  N=60 with staged constants refused by the wrapper: {e}",
              flush=True)
    else:
        raise AssertionError("N=60: the wrapper must refuse to stage the "
                             "constants")
    pl = ca.plan(2, kq.n_pad, kq.m_pad)
    check(pl.streamed, f"N=60: the plan must stream the constants: {pl}")
    print(f"  plan N=60 B=2: {pl}", flush=True)


def mixed_iterates(tag, kq16, packed, k0, tiles):
    """The tensor-core kernel's own outputs after ONE split-precision
    iteration from the plain version's iterates after ``k0`` of them, at
    each tile width of ``tiles`` (None: the plan's)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    cold = ca._init_iterates(*packed[1:], None)
    it = tuple(t.contiguous() for t in
               ca._mixed_plain(kq16, *packed, cold, k0))
    ref = ca._mixed_plain(kq16, *packed, it, 1)
    B = packed[0].shape[0]
    for tile in tiles:
        pl = ca.plan_mixed(B, kq16.n_pad, kq16.m_pad, tile=tile)
        got = ca._launch_k1_mixed(kq16, *packed, it, 1, tile=tile)
        held(f"{tag} one split-precision it after {k0}, tile {pl.tile}",
             "mixed_iterates",
             dict(zip(("zG", "yG", "zB", "yB"), zip(got, ref))))


def mixed_tiles_and_limit(dev, rng, rec):
    """The split-precision kernel's tile widths at batches that leave a
    ragged last tile, and its shape limit."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    # both tile widths at batches that leave a ragged last tile, and N=21,
    # which fits a tile of 16 only: one iteration at every width that fits,
    # the whole solve at the plan's
    lib = load_library("admm_mixed")
    for N, B in ((12, 1), (12, 33), (12, 4095), (20, 4095), (21, 37)):
        _, qp, spec, _, f, h, lb, ub = problem(N, B, dev, rng)
        kq = ca.kernel_qp_for(spec)
        kq16 = ca.pad_kernel_qp(kq)
        nr, mGp = kq16.n_pad, kq16.m_pad
        tiles = []
        for t in ca.MIXED_TILES:
            try:
                tiles.append(ca.plan_mixed(B, nr, mGp, tile=t).tile)
            except ValueError:
                pass
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        mixed_iterates(f"N={N} B={B}", kq16, packed, MIXED_WARM[0], tiles)
        pl = ca.plan_mixed(B, nr, mGp)
        need = lib.phc_admm_mixed_smem_bytes(nr, mGp, pl.tile)
        check(need == pl.smem, f"plan_mixed: N={N} B={B} reckons {pl.smem} "
              f"bytes of shared memory, the library {need}")
        iters = 120 if N == 12 else 100
        args = (kq, f, h, lb, ub)
        compare(f"N={N} B={B} {iters} it low_frac=1.0 (tile {pl.tile})",
                ca.admm_solve_cuda(*args, iters=iters, low_frac=1.0),
                ca.admm_solve_plain(*args, iters=iters, low_frac=1.0), rec,
                "mixed")
        print(f"  plan_mixed N={N} B={B}: tile of {pl.tile} problems, "
              f"{-(-B // pl.tile)} blocks of {pl.threads} threads, "
              f"{pl.smem} bytes of shared memory per block (limit "
              f"{ca.SMEM_MAX}); widths that fit {tiles}", flush=True)
    # the shape limit: the tensor-core kernel refuses N=22, where the
    # split-precision phase runs in K1's split mode (phase_split)
    _, qp, spec, _, f, h, lb, ub = problem(22, 2, dev, rng)
    kq16 = ca.pad_kernel_qp(ca.kernel_qp_for(spec))
    try:
        ca.plan_mixed(2, kq16.n_pad, kq16.m_pad)
    except ValueError as e:
        print(f"  N=22 refused by the tensor-core kernel's plan: {e}",
              flush=True)
    else:
        raise AssertionError("N=22: the tensor-core plan must refuse the "
                             "shape")
    check(ca.split_route(kq16.n_pad, kq16.m_pad) == "k1_split",
          "N=22: the split-precision phase must route to K1's split mode")


def phase_k1_mixed(dev, rng, rec):
    """K1 with its split-precision phase against the plain version (both
    tile widths, ragged batches, the shape limit), then the relaxation
    sweep's gate against full-precision K1."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K1 split-precision phase (admm_k1_mixed) vs plain:", flush=True)
    for N, B, iters in ((12, 128, 120), (20, 4096, 100)):
        _, qp, spec, _, f, h, lb, ub = problem(N, B, dev, rng)
        kq = ca.kernel_qp_for(spec)
        args = (kq, f, h, lb, ub)
        # the tensor-core kernel's own outputs, before the drift has grown
        kq16 = ca.pad_kernel_qp(kq)
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        for k0 in MIXED_WARM:
            mixed_iterates(f"N={N} B={B}", kq16, packed, k0, (None,))
        full = ca.admm_solve_cuda(*args, iters=iters)
        for lf in (0.8, 1.0):
            got = ca.admm_solve_cuda(*args, iters=iters, low_frac=lf)
            ref = ca.admm_solve_plain(*args, iters=iters, low_frac=lf)
            compare(f"N={N} B={B} {iters} it low_frac={lf}", got, ref, rec,
                    "mixed")
        gate = float(((got.obj - full.obj).abs()
                      / torch.clamp_min(full.obj.abs(), 1.0)).max())
        print(f"  N={N} B={B}: low_frac=1.0 vs full-precision K1, max "
              f"relative objective delta {gate:.2e} (gate {MIXED_GATE:.0e})",
              flush=True)
        check(gate <= MIXED_GATE, f"mixed gate: {gate:.3e} > {MIXED_GATE}")
        rec[f"n{N}_gate"] = gate
    # the bench primary is the shape the relaxation sweep gives the kernel
    times = {}
    for name, fn in (
            ("ms", lambda: ca.admm_solve_cuda(*args, iters=100,
                                              low_frac=1.0)),
            ("lf08_ms", lambda: ca.admm_solve_cuda(*args, iters=100,
                                                   low_frac=0.8)),
            ("full_ms", lambda: ca.admm_solve_cuda(*args, iters=100)),
            ("plain_ms", lambda: ca.admm_solve_plain(*args, iters=100,
                                                     low_frac=1.0)),
            ("lf08_plain_ms", lambda: ca.admm_solve_plain(
                *args, iters=100, low_frac=0.8))):
        times[name] = cuda_ms(fn)
    rec.update(times)
    for name, lf in (("kernel_ms", 1.0), ("lf08_kernel_ms", 0.8)):
        rec[name] = kernel_ms(lambda: ca.admm_solve_cuda(
            *args, iters=100, low_frac=lf))
    rec["lf08_bound_ms"] = bound(*admm_work(
        kq.n_pad, kq.m_pad, 4096, products=21, stats=1, warm=False,
        lo_products=80))[0]
    # the function's own shape (nr=64, mGp=200), not the 16-grain padding
    set_bound(rec, kq, 4096, products=1, stats=1, warm=False,
              lo_products=100)
    print(f"  N=20 B=4096 100 it: low_frac=1.0 wrapper {rec['ms']:.3f} ms, "
          f"kernels alone {rec['kernel_ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']}); low_frac=0.8 wrapper "
          f"{rec['lf08_ms']:.3f} ms, kernels alone "
          f"{rec['lf08_kernel_ms']:.3f} ms, plain "
          f"{rec['lf08_plain_ms']:.3f} ms, bound "
          f"{rec['lf08_bound_ms']:.4f} ms; full-precision K1 "
          f"{rec['full_ms']:.3f} ms", flush=True)
    mixed_tiles_and_limit(dev, rng, rec)
    return args


def phase_dispatch(dev, rng):
    """On a CUDA tensor no path reaches a plain version: with the plain
    versions made to raise, the entry points still answer, and each counts
    a launch of its kernel."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    _, qp, spec, spec_p, f, h, lb, ub = problem(10, 48, dev, rng)
    _, qp27, spec27, spec27_p, f27, h27, lb27, ub27 = problem(27, 8, dev, rng)
    saved = {k: getattr(ca, k) for k in
             ("admm_solve_plain", "admm_wave_plain", "_solve_plain",
              "_mixed_plain", "_relax", "_phase")}
    for k in saved:
        setattr(ca, k, refuse)
    none = dict.fromkeys(ca.LAUNCHES, 0)
    try:
        ca.reset_launch_counts()
        ca.admm_solve_auto(spec, f, h, lb, ub, iters=10)
        check(ca.LAUNCHES["admm_k1"] == 1, "admm_solve_auto: no K1 launch")
        ca.admm_wave_auto(spec, spec_p, qp.binary_idx, f, h, lb, ub,
                          iters=10, probe_iters=10)
        check(ca.LAUNCHES["admm_k2"] == 1, "admm_wave_auto: no K2 launch")
        ca.admm_solve_cuda(ca.kernel_qp_for(spec), f, h, lb, ub, iters=10,
                           low_frac=0.5)
        check(ca.LAUNCHES == {**none, "admm_k1": 2, "admm_k2": 1,
                              "admm_k1_mixed": 1},
              f"admm_solve_cuda(low_frac): launches {ca.LAUNCHES}")
        # above the shared-memory cap: the streamed variants and split mode
        ca.reset_launch_counts()
        ca.admm_solve_auto(spec27, f27, h27, lb27, ub27, iters=10)
        ca.admm_wave_auto(spec27, spec27_p, qp27.binary_idx, f27, h27, lb27,
                          ub27, iters=10, probe_iters=10)
        ca.admm_solve_cuda(ca.kernel_qp_for(spec27), f27, h27, lb27, ub27,
                           iters=10, low_frac=0.5)
        check(ca.LAUNCHES == {**none, "admm_k1_streamed": 2,
                              "admm_k2_streamed": 1, "admm_k1_split": 1},
              f"N=27: launches {ca.LAUNCHES}")
    finally:
        for k, v in saved.items():
            setattr(ca, k, v)
    print(f"no plain version behind a CUDA tensor: launches {ca.LAUNCHES}, "
          f"batch sizes {ca.LAUNCH_BATCHES}", flush=True)


# (n, m) of the shapes whose constants a block cannot stage: the double
# integrator at N=27 and the reference bench's configs 3, 4b, 4c and 2/2b
# (their condensed sizes; random problems of these sizes stand in for the
# configurations, which the port does not build yet)
BIG_SHAPES = {"N27": (81, 270), "config3": (108, 216), "config4b": (120, 216),
              "config4c": (120, 444), "config2": (220, 680)}
BIG_BATCHES = (1, 37, 300)
SPLIT_HORIZONS = (22, 24, 27)     # K1's split mode, above the tensor cores'


def random_problem(n, m, B, dev, rng, fix_frac=0.3):
    """A random box-QP of n variables and m rows G x ≤ h: H = MMᵀ/n + I,
    G with unit-variance rows, h feasible for a point of the box with a
    margin, |x| ≤ 1, the first n/5 variables binary (node boxes fixing
    ``fix_frac`` of them). Returns prepared specs (ρ and stiff ρ), the
    binary indices and a batch of B problems (q, h, lb, ub)."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm

    Mh = rng.normal(size=(n, n))
    H = Mh @ Mh.T / n + np.eye(n)
    G = rng.normal(size=(m, n)) / np.sqrt(n)
    nb = max(1, n // 5)
    spec = prepare_admm(G, H, device=dev)
    spec_p = prepare_admm(G, H, rho=10.0, device=dev)
    xf = rng.uniform(-0.5, 0.5, size=(B, n))
    xf[:, :nb] = rng.uniform(0.0, 1.0, size=(B, nb))
    h = xf @ G.T + rng.uniform(0.1, 1.0, size=(B, m))
    q = rng.normal(size=(B, n))
    lb, ub = -np.ones((B, n)), np.ones((B, n))
    fm = rng.uniform(size=(B, nb)) < fix_frac
    fv = (rng.uniform(size=(B, nb)) < 0.5).astype(float)
    lb[:, :nb] = np.where(fm, fv, 0.0)
    ub[:, :nb] = np.where(fm, fv, 1.0)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return spec, spec_p, tuple(range(nb)), t(q), t(h), t(lb), t(ub)


def timed(rec, pre, wrapper, plain, work):
    """Wrapper ms, kernels-alone ms, plain ms and the bound of one shape
    into ``rec`` under keys prefixed ``pre``."""
    rec[pre + "ms"] = cuda_ms(wrapper)
    rec[pre + "kernel_ms"] = kernel_ms(wrapper)
    rec[pre + "plain_ms"] = cuda_ms(plain)
    rec[pre + "bound_ms"], by = bound(*work)
    print(f"  {pre.rstrip('_') or 'main shape'}: wrapper "
          f"{rec[pre + 'ms']:.3f} ms, kernel alone "
          f"{rec[pre + 'kernel_ms']:.3f} ms, plain "
          f"{rec[pre + 'plain_ms']:.3f} ms, bound "
          f"{rec[pre + 'bound_ms']:.4f} ms ({by})", flush=True)
    return by


def phase_streamed(dev, rng, recs):
    """K1 and K2 with the constants streamed from device memory (L2)
    against their plain versions at the five shapes a block cannot stage
    (random problems, "main" limits, B = 1, 37, 300); the forced streamed
    variant against the staged one at N=26; the times at the main paths'
    shapes (N=27: K1 at B=4096, 100 iterations; K2 at the closed loop's
    wave, B=32, 200 + 100/100 iterations)."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    r1, r2 = recs["admm_k1_streamed"], recs["admm_k2_streamed"]
    print("K1/K2 with streamed constants (admm_k1_streamed, "
          "admm_k2_streamed) vs plain:", flush=True)
    for name, (n, m) in BIG_SHAPES.items():
        for B in BIG_BATCHES:
            spec, spec_p, bidx, q, h, lb, ub = random_problem(
                n, m, B, dev, rng)
            kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
            pl = ca.plan(B, kq.n_pad, kq.m_pad)
            check(pl.streamed, f"{name}: the plan must stream, got {pl}")
            need = load_library().phc_admm_smem_bytes(kq.n_pad, kq.m_pad,
                                                      pl.pb, 1)
            check(need == pl.smem, f"{name}: the plan reckons {pl.smem} "
                  f"bytes of shared memory, the library {need}")
            tag = f"{name} (n={n}, m={m}) B={B} tile {pl.pb}"
            args = (kq, q, h, lb, ub)
            compare("K1 " + tag, ca.admm_solve_cuda(*args, iters=100),
                    ca.admm_solve_plain(*args, iters=100), r1)
            wargs = (kq, kq2, bidx, q, h, lb, ub)
            kw = dict(iters=100, probe_iters=100)
            compare_probe("K2 " + tag, ca.admm_wave_cuda(*wargs, **kw),
                          ca.admm_wave_plain(*wargs, **kw),
                          types.SimpleNamespace(binary_idx=bidx), lb, ub,
                          r2)
        # the time at a few hundred problems, where the card is filled
        timed(r1, f"{name}_", lambda: ca.admm_solve_cuda(*args, iters=100),
              lambda: ca.admm_solve_plain(*args, iters=100),
              admm_work(kq.n_pad, kq.m_pad, 300, products=101, stats=1,
                        warm=False))

    # N=26: the largest staged shape, forced through the streamed variant
    _, qp, spec, spec_p, f, h, lb, ub = problem(26, 4096, dev, rng,
                                                 fix_frac=0.3)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    args = (kq, f, h, lb, ub)
    staged = ca.admm_solve_cuda(*args, iters=100)
    # at the same tile the two variants run the same arithmetic in the
    # same order: bitwise the same results
    check(torch_equal(ca.admm_solve_cuda(*args, iters=100, pb=1,
                                         streamed=True), staged),
          "N=26: streamed and staged K1 with a tile of 1 differ")
    # the streamed plan's tile of 8 sums in another order: N=26's noise
    streamed = ca.admm_solve_cuda(*args, iters=100, streamed=True)
    compare("K1 N=26 B=4096 streamed (tile 8) vs staged (tile 1)",
            streamed, staged, r1, "large")
    print(f"  N=26: plans staged {ca.plan(4096, kq.n_pad, kq.m_pad)}, "
          f"streamed {ca.plan(4096, kq.n_pad, kq.m_pad, streamed=True)}; "
          f"with a tile of 1 both bitwise equal", flush=True)
    for st in (False, True):
        r1[f"n26_{'streamed' if st else 'staged'}_kernel_ms"] = kernel_ms(
            lambda: ca.admm_solve_cuda(*args, iters=100, streamed=st))
    print(f"  N=26 B=4096 100 it, kernel alone: staged "
          f"{r1['n26_staged_kernel_ms']:.3f} ms, streamed "
          f"{r1['n26_streamed_kernel_ms']:.3f} ms", flush=True)
    wargs = (kq, kq2, qp.binary_idx, f[:300], h[:300], lb[:300], ub[:300])
    kw = dict(iters=100, probe_iters=100)
    got, ref = (ca.admm_wave_cuda(*wargs, pb=1, streamed=st, **kw)
                for st in (True, False))
    check(torch_equal(got[0], ref[0]) and torch_equal(got[1], ref[1]),
          "N=26: streamed and staged K2 with a tile of 1 differ")
    compare_probe("K2 N=26 B=300 streamed vs staged",
                  ca.admm_wave_cuda(*wargs, streamed=True, **kw),
                  ca.admm_wave_cuda(*wargs, streamed=False, **kw), qp,
                  lb[:300], ub[:300], r2, "large")

    # the main paths' shapes at N=27
    _, qp, spec, spec_p, f, h, lb, ub = problem(27, 4096, dev, rng)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    args = (kq, f, h, lb, ub)
    compare("K1 N=27 B=4096 100 it", ca.admm_solve_cuda(*args, iters=100),
            ca.admm_solve_plain(*args, iters=100), r1, "large")
    r1["bound_by"] = timed(
        r1, "", lambda: ca.admm_solve_cuda(*args, iters=100),
        lambda: ca.admm_solve_plain(*args, iters=100),
        admm_work(kq.n_pad, kq.m_pad, 4096, products=101, stats=1,
                  warm=False))
    r1["library_ms"] = None
    _, qp, spec, spec_p, f, h, lb, ub = problem(27, 32, dev, rng,
                                                 fix_frac=0.3)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    wargs = (kq, kq2, qp.binary_idx, f, h, lb, ub)
    kw = dict(iters=200, probe_iters=200)
    ref = ca.admm_wave_plain(*wargs, **kw)
    warm = (ref[0].x, ref[0].z, ref[0].y)
    compare_probe("K2 N=27 B=32 200+100/100 it warm",
                  ca.admm_wave_cuda(*wargs, warm=warm, **kw),
                  ca.admm_wave_plain(*wargs, warm=warm, **kw), qp, lb, ub, r2,
                  "large")
    r2["bound_by"] = timed(
        r2, "", lambda: ca.admm_wave_cuda(*wargs, warm=warm, **kw),
        lambda: ca.admm_wave_plain(*wargs, warm=warm, **kw),
        admm_work(kq.n_pad, kq.m_pad, 32, products=402, stats=2, warm=True,
                  stiff=True, outputs=2))
    r2["library_ms"] = None


def torch_equal(a, b):
    import torch

    return all(torch.equal(getattr(a, k), getattr(b, k))
               for k in ("x", "z", "y", "obj"))


def phase_split(dev, rng, rec):
    """K1 in split mode (the split-precision phase above N=21) against its
    plain version: after ONE split iteration from the plain version's
    iterates, on the whole solve's obj and x, at N=22, 24 and 27; the
    bench's gate (low_frac=1.0 against full-precision K1, 1e-4) at N=24;
    and its time at the sweep's shape (N=27, B=4096, 100 iterations)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print("K1 split mode (admm_k1_split) vs plain:", flush=True)
    for N in SPLIT_HORIZONS:
        _, qp, spec, _, f, h, lb, ub = problem(N, 300, dev, rng)
        kq = ca.kernel_qp_for(spec)
        kq16 = ca.pad_kernel_qp(kq)
        check(ca.split_route(kq16.n_pad, kq16.m_pad) == "k1_split",
              f"N={N}: low_frac must route to K1's split mode")
        m, n = spec.m_ineq, spec.n
        packed = ca._pack(kq16, f, h, lb, ub, None)[:5]
        cold = ca._init_iterates(*packed[1:], None)
        it = tuple(t.contiguous() for t in
                   ca._mixed_plain(kq16, *packed, cold, MIXED_WARM[0]))
        ref = ca._mixed_plain(kq16, *packed, it, 1)
        got = ca.admm_solve_cuda(kq, f, h, lb, ub, iters=1, warm=it,
                                 low_frac=1.0)
        held(f"N={N} B=300 one split iteration after {MIXED_WARM[0]} "
             f"(plan {ca.plan(300, kq16.n_pad, kq16.m_pad)})",
             "mixed_iterates",
             dict(zG=(got.z[:, :m], ref[0][:, :m]),
                  yG=(got.y[:, :m], ref[1][:, :m]),
                  zB=(got.z[:, m:], ref[2][:, :n]),
                  yB=(got.y[:, m:], ref[3][:, :n])))
        args = (kq, f, h, lb, ub)
        for lf in (0.8, 1.0):
            compare(f"N={N} B=300 100 it low_frac={lf}",
                    ca.admm_solve_cuda(*args, iters=100, low_frac=lf),
                    ca.admm_solve_plain(*args, iters=100, low_frac=lf), rec,
                    "mixed")
        if N == 24:
            full = ca.admm_solve_cuda(*args, iters=100)
            got = ca.admm_solve_cuda(*args, iters=100, low_frac=1.0)
            gate = float(((got.obj - full.obj).abs()
                          / torch.clamp_min(full.obj.abs(), 1.0)).max())
            print(f"  N=24 B=300: low_frac=1.0 vs full-precision K1, max "
                  f"relative objective delta {gate:.2e} (gate "
                  f"{MIXED_GATE:.0e})", flush=True)
            check(gate <= MIXED_GATE, f"split gate: {gate:.3e} > "
                  f"{MIXED_GATE}")
            rec["n24_gate"] = gate
    # the sweep's shape
    _, qp, spec, _, f, h, lb, ub = problem(27, 4096, dev, rng)
    kq = ca.kernel_qp_for(spec)
    args = (kq, f, h, lb, ub)
    compare("N=27 B=4096 100 it low_frac=1.0",
            ca.admm_solve_cuda(*args, iters=100, low_frac=1.0),
            ca.admm_solve_plain(*args, iters=100, low_frac=1.0), rec,
            "mixed")
    rec["bound_by"] = timed(
        rec, "", lambda: ca.admm_solve_cuda(*args, iters=100, low_frac=1.0),
        lambda: ca.admm_solve_plain(*args, iters=100, low_frac=1.0),
        admm_work(kq.n_pad, kq.m_pad, 4096, products=1, stats=1,
                  warm=False, lo_products=100))
    rec["library_ms"] = None
    return args


CL_SPEC = dict(capacity=256, wave_size=32, max_waves=48, qp_iters=200)
CL_T = 20           # config 1 of the reference bench: T=20 from [2, 0]
CL_T27 = 4


def closed_loop_steps(N, dev):
    """Config 1's bench step at horizon N (B&B with the probe prepared at
    ρ=10) and the enumeration step that holds it, on the card."""
    from pyhybridcontrol_tpu_torch.loop import make_mpc_step
    from pyhybridcontrol_tpu_torch.models import (
        di_default_weights, switched_double_integrator)
    from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
    from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    model = switched_double_integrator()
    c = CondensedMpc(model, N, di_default_weights())
    qp, admm = c.device_qp(dev), prepare_admm_mpc(c, device=dev)
    step = make_mpc_step(model, qp, admm, method="bnb",
                         bnb_spec=BnbSpec(**CL_SPEC),
                         admm_probe=prepare_admm_mpc(c, rho=10.0,
                                                     device=dev))
    return model, step, (model, qp, admm)


def phase_closed_loop(dev):
    """Config 1 of the reference bench as the port runs it: the switched
    double integrator, N=10, T=20 from [2, 0], B&B with capacity 256, wave
    32, 48 waves, 200 iterations and the probe at ρ=10. ms per control
    step (host clock around a run that ends in a synchronise, best of 3
    after a warm-up), found share, mean nodes; held against the port's
    enumeration loop on the card (600 iterations): total cost within
    rtol 2e-3, states within 1e-2."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch.loop import closed_loop, make_mpc_step

    print("closed loop, config 1 (N=10, T=20):", flush=True)
    model, step, (m, qp, admm) = closed_loop_steps(10, dev)
    x0 = [2.0, 0.0]
    closed_loop(model, step, x0, T=2)                 # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, _ = drive(PATHS[5], lambda: closed_loop(model, step, x0,
                                                     T=CL_T))
        times.append(time.perf_counter() - t0)
    ms = 1e3 * min(times) / CL_T
    check(PATH_LAUNCHES[PATHS[5]]["admm_k2"] > 0,
          "closed loop: K2 was never launched")
    found = float(res.found.float().mean())
    nodes = float(res.nodes.float().mean())
    print(f"  {ms:.2f} ms per control step (runs of "
          f"{', '.join(f'{1e3 * t:.1f}' for t in times)} ms for {CL_T} "
          f"steps), found share {found:.3f}, mean nodes {nodes:.1f}",
          flush=True)
    enum = make_mpc_step(m, qp, admm, method="enumerate", qp_iters=600)
    ref = closed_loop(model, enum, x0, T=CL_T)
    tot, tot_ref = float(res.objs.sum()), float(ref.objs.sum())
    dx = float((res.xs - ref.xs).abs().max())
    print(f"  total cost {tot:.4f}, enumeration {tot_ref:.4f} (rel "
          f"{abs(tot - tot_ref) / abs(tot_ref):.2e}, limit 2e-3); max |Δx| "
          f"{dx:.2e} (limit 1e-2 + 1e-2·|x|)", flush=True)
    check(bool(res.found.all()), "closed loop: a step without a plan")
    check(abs(tot - tot_ref) <= 2e-3 * abs(tot_ref),
          f"closed loop: total cost {tot} vs enumeration {tot_ref}")
    check(np.allclose(res.xs.cpu().numpy(), ref.xs.cpu().numpy(),
                      rtol=1e-2, atol=1e-2),
          f"closed loop: states off enumeration's by {dx}")
    return dict(ms_per_control_step=ms, found_frac=found, mean_nodes=nodes,
                run_ms=[1e3 * t for t in times], total_cost=tot,
                total_cost_enumeration=tot_ref)


def phase_closed_loop_n27(dev, sweep_args, rec):
    """The N=27 double integrator, whose constants no block can stage: a
    short closed loop (T=4, config 1's B&B spec, K2 streamed) that must
    find every step, follow the dynamics and move the state toward the
    origin; then the relaxation sweep at low_frac=1.0 (K1 streamed, in
    split mode), held against its plain version."""
    import torch

    from pyhybridcontrol_tpu_torch.loop import closed_loop
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    print(f"closed loop, N=27 (T={CL_T27}):", flush=True)
    model, step, _ = closed_loop_steps(27, dev)
    x0 = [2.0, 0.0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res, batches = drive(PATHS[6], lambda: closed_loop(model, step, x0,
                                                       T=CL_T27))
    ms = 1e3 * (time.perf_counter() - t0) / CL_T27
    got = PATH_LAUNCHES[PATHS[6]]
    check(got["admm_k2_streamed"] > 0 and got["admm_k2"] == 0,
          f"closed loop N=27: K2 must run streamed, launches {got}")
    md = model.to(dev)
    for k in range(CL_T27):
        want = md.step_v(res.xs[k], res.vs[k])
        check(bool(torch.allclose(res.xs[k + 1], want, rtol=1e-5,
                                  atol=1e-6)),
              f"closed loop N=27: step {k} does not follow the dynamics")
    check(bool(res.found.all()), "closed loop N=27: a step without a plan")
    norms = res.xs.norm(dim=-1).tolist()
    check(norms[-1] < norms[0], f"closed loop N=27: |x| {norms}")
    print(f"  {ms:.1f} ms per control step, nodes "
          f"{res.nodes.tolist()}, |x| {[round(v, 4) for v in norms]}, "
          f"objectives {[round(v, 3) for v in res.objs.tolist()]}",
          flush=True)
    sweep, _ = drive(PATHS[7], lambda: ca.admm_solve_cuda(
        *sweep_args, iters=100, low_frac=1.0))
    check(PATH_LAUNCHES[PATHS[7]] == {
        **dict.fromkeys(ca.LAUNCHES, 0), "admm_k1_streamed": 1,
        "admm_k1_split": 1}, f"N=27 sweep: launches "
        f"{PATH_LAUNCHES[PATHS[7]]}")
    compare("N=27 sweep low_frac=1.0", sweep, ca.admm_solve_plain(
        *sweep_args, iters=100, low_frac=1.0), rec, "mixed")
    return dict(ms_per_control_step=ms, nodes=res.nodes.tolist(),
                total_cost=float(res.objs.sum()))


PATH_LAUNCHES = {}   # path -> launch counts of that path alone


def drive(path, fn):
    """Run one path with the launch counts set to 0 just before it and
    read just after it. Returns (what fn returned, batch sizes per
    kernel)."""
    import torch

    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    ca.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    PATH_LAUNCHES[path] = dict(ca.LAUNCHES)
    batches = {k: dict(v) for k, v in ca.LAUNCH_BATCHES.items() if v}
    print(f"  launches on {path}: {PATH_LAUNCHES[path]}, batch sizes "
          f"{batches}", flush=True)
    return out, batches


def phase_serve_batch(dev, sweep_args):
    """The batched serving path: one 1024-instance request through the
    serve loop (pooled B&B, K2 at B=1024); the reference bench's config-4
    call from nothing and with carried incumbents (probe-gated waves:
    K1); the split-precision relaxation sweep. Each is a path with launch
    counts of its own."""
    import numpy as np
    import torch

    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
    from pyhybridcontrol_tpu_torch.solver.bnb_pooled import (
        solve_miqp_bnb_pooled)

    print("serve --config scenario_batch --device cuda:", flush=True)
    t0 = time.perf_counter()
    ctrl, ready = serve.build_controller("scenario_batch", "bnb", dev.type)
    print(f"  controller built + warmup solve: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    x0s = np.random.default_rng(SEED).normal(size=(BATCH, 2)).astype(
        np.float32)
    drawn = x0s[BATCH_OUT_OF_BOX].copy()
    x0s[BATCH_OUT_OF_BOX] = OUT_OF_BOX
    lines = [json.dumps({"x": x0s.tolist(), "id": "batch"}),
             '{"cmd": "quit"}']
    out = io.StringIO()
    _, batches = drive(SERVED[1], lambda: serve.stdin_loop(
        ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"), out=out))
    served = PATH_LAUNCHES[SERVED[1]]
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(len(replies) == 2 and replies[0].get("ready") is True,
          "serve_batch: expected a ready line and one reply")
    r = replies[1]
    check("error" not in r, f"serve_batch: error reply {r}")
    check(r["batch"] == BATCH and r["id"] == "batch",
          "serve_batch: batch/id not echoed")
    for k in ("u", "delta", "obj", "found"):
        check(isinstance(r[k], list) and len(r[k]) == BATCH,
              f"serve_batch: {k} is not a list of {BATCH}")
    obj, found = np.asarray(r["obj"]), np.asarray(r["found"])
    check(not found[BATCH_OUT_OF_BOX],
          "serve_batch: the out-of-box instance must be found=false")
    check(bool(np.isfinite(obj[found]).all()), "serve_batch: non-finite obj")
    print(f"  request of {BATCH}: {r['ms']} ms, {r['ms'] / BATCH:.4f} ms per "
          f"instance, found share {found.mean():.4f}", flush=True)
    check(served["admm_k2"] > 0, "serve_batch: K2 was never launched")
    check(set(batches["admm_k2"]) == {BATCH},
          f"serve_batch: K2 launches not all at B={BATCH}: {batches}")

    enum = MpcController(ctrl.model, ctrl.N, ctrl.weights,
                         solver="enumerate", qp_iters=600, device=dev)
    diffs, refs = [], []
    for i in BATCH_SAMPLE:
        ref = enum.feedback(x0s[i])
        check(bool(ref.found) == bool(found[i]),
              f"serve_batch: instance {i} found={found[i]}, enumeration "
              f"{bool(ref.found)}")
        if found[i]:
            diffs.append(abs(obj[i] - float(ref.obj)))
            refs.append(float(ref.obj))
    serve_reading(f"serve_batch, {len(diffs)} sampled instances vs "
                  f"enumeration", diffs, refs)

    # the reference bench's config-4 call: no seed, gated probes, pool 8·B,
    # on the states as the bench draws them (all inside the box: the gate
    # closes only once EVERY instance has an incumbent)
    spec4 = BnbSpec(capacity=1024, wave_size=1024, max_waves=4096,
                    qp_iters=100, probe_patience=3)
    x0s_bench = x0s.copy()
    x0s_bench[BATCH_OUT_OF_BOX] = drawn
    others = np.arange(BATCH) != BATCH_OUT_OF_BOX   # compared on these
    f, h = ctrl._qp.assemble(torch.as_tensor(x0s_bench, device=dev))

    def solve4(seed=None):
        return solve_miqp_bnb_pooled(ctrl._admm, ctrl._qp, f, h, spec4,
                                     pool_slots=8 * BATCH,
                                     init_incumbent=seed,
                                     admm_probe=ctrl._admm_probe)

    def timed4(path, tag, seed=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, batches = drive(path, lambda: solve4(seed))
        ms = 1e3 * (time.perf_counter() - t0)
        k1 = PATH_LAUNCHES[path]["admm_k1"]
        check(PATH_LAUNCHES[path]["admm_k2"] + k1 == res.waves,
              f"pooled call: {res.waves} waves, launches "
              f"{PATH_LAUNCHES[path]}")
        check(all(set(b) == {BATCH} for b in batches.values()),
              f"pooled call: launches not all at B={BATCH}: {batches}")
        nodes = int(res.nodes_solved)
        found4 = res.found.cpu().numpy()
        both = found & found4 & others
        dobj = np.where(both, np.abs(res.obj.cpu().numpy() - obj), 0.0)
        print(f"  solve_miqp_bnb_pooled (wave 1024, probe_patience=3, pool "
              f"8·B{tag}): {ms:.1f} ms, {res.waves} waves, {nodes} nodes, "
              f"{1e3 * BATCH / ms:.1f} MIQP/s, {1e3 * nodes / ms:.0f} "
              f"nodes/s, found share {found4.mean():.4f}, overflow "
              f"{bool(res.overflow)}, K1 launches (gated waves) {k1}",
              flush=True)
        check(bool((found4 == found)[others].all()) and
              bool(found4[BATCH_OUT_OF_BOX]),
              "pooled call: found differs from the served request")
        serve_reading(f"pooled call{tag} vs the request", dobj[both],
                      obj[both])
        return res, k1

    solve4()                                   # warm-up, as the bench's
    # The gate closes after probe_patience waves in which NO instance found
    # a better incumbent. With 1024 instances searching from nothing some
    # probe improves in nearly every wave, so this call gates no wave and
    # launches K1 no time, here as in the reference (its pooled engine with
    # the Pallas kernels in interpret mode gates none of its 38 waves on
    # these states: tests/test_torch_pooled.py holds the two together).
    # The count is printed as measured and not checked.
    res, _ = timed4(PATHS[2], "")
    # A re-solve that carries its incumbents (a receding-horizon step does)
    # finds few better ones, so some of its probes are gated and those
    # waves run K1 alone. How many is up to the data: 4 of 38 waves on the
    # states of seed 0, where it is checked; 0-4 on those of seeds 1-7,
    # where the count is printed as measured.
    _, k1 = timed4(PATHS[3], ", incumbents carried",
                   (res.obj, res.x, res.found))
    check(k1 > 0 or SEED != 0,
          "pooled call: K1 never launched on the gated waves")

    # the relaxation sweep that uses the split-precision phase
    sweep, _ = drive(PATHS[4], lambda: ca.admm_solve_cuda(
        *sweep_args, iters=100, low_frac=1.0))
    check(bool(torch.isfinite(sweep.obj).all()), "relax sweep: non-finite")
    check(PATH_LAUNCHES[PATHS[4]] == {**dict.fromkeys(ca.LAUNCHES, 0),
                                      "admm_k1": 1, "admm_k1_mixed": 1},
          f"relax sweep: launches {PATH_LAUNCHES[PATHS[4]]}")


def phase_serve(dev):
    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController

    print("serve --config double_integrator --device cuda:", flush=True)
    t0 = time.perf_counter()
    ctrl, ready = serve.build_controller("double_integrator", "bnb",
                                         dev.type)
    print(f"  controller built + warmup solve: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    lines = ['{"cmd": "ping"}']
    lines += [json.dumps({"x": x, "id": i}) for i, x in enumerate(STATES)]
    lines += [json.dumps({"x": OUT_OF_BOX, "id": "out_of_box"}),
              '{"cmd": "quit"}']
    out = io.StringIO()
    drive(SERVED[0], lambda: serve.stdin_loop(
        ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"), out=out))
    launches = PATH_LAUNCHES[SERVED[0]]
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(replies[0].get("ready") is True, "serve: no ready line")
    check(replies[1] == {"pong": True}, "serve: ping not answered")
    check(len(replies) == 2 + len(STATES) + 1, "serve: missing replies")
    check(launches["admm_k2"] > 0, "serve: K2 was never launched")

    enum = MpcController(ctrl.model, ctrl.N, ctrl.weights,
                         solver="enumerate", qp_iters=600, device=dev)
    diffs, refs = [], []
    for x, r in zip(STATES, replies[2:2 + len(STATES)]):
        check("error" not in r, f"serve: error reply {r}")
        ref = enum.feedback(x)
        check(r["found"] and bool(ref.found), f"serve: x0={x} not found")
        d = abs(r["obj"] - float(ref.obj))
        print(f"  x0={x}: obj={r['obj']:.6f} enumeration="
              f"{float(ref.obj):.6f} |Δ|={d:.2e} ms={r['ms']}", flush=True)
        diffs.append(d)
        refs.append(float(ref.obj))
    serve_reading("serve vs enumeration", diffs, refs)
    bad = replies[-1]
    check("error" not in bad and bad["found"] is False,
          f"serve: out-of-box state must come back found=false, got {bad}")
    print(f"  x0={OUT_OF_BOX}: found=false ms={bad['ms']}", flush=True)


def main(argv=None):
    global SEED, READINGS_ONLY
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--readings" in argv:
        argv.remove("--readings")
        READINGS_ONLY = True
    if argv[:1] == ["--seed"] and len(argv) == 2:
        SEED = int(argv[1])
    elif argv:
        print("usage: chip_smoke.py [--seed N] [--readings]",
              file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if not (ROOT / "pyhybridcontrol_tpu_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository "
              "(pyhybridcontrol_tpu_torch/ not found beside it)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from pyhybridcontrol_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    _build.load_library("admm_mixed")
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_INFO.get('paths')})", flush=True)
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    recs = {k: dict(name=k, route="cuda", source=SOURCES[k], replaces=v)
            for k, v in REPLACES.items()}
    phase_k1(dev, phase_rng("k1"), recs["admm_k1"])
    phase_k2(dev, phase_rng("k2"), recs["admm_k2"])
    phase_far(dev, phase_rng("far"), recs)
    sweep_args = phase_k1_mixed(dev, phase_rng("k1_mixed"),
                                recs["admm_k1_mixed"])
    phase_streamed(dev, phase_rng("streamed"), recs)
    sweep27_args = phase_split(dev, phase_rng("split"),
                               recs["admm_k1_split"])
    for regime, seen in READINGS.items():
        print(f"largest error, {regime} (limit): " + " ".join(
            f"{k}={v:.2e} ({LIMITS[regime][k]:.0e})"
            for k, v in seen.items()), flush=True)
    if OVER:
        print("off their limits:\n  " + "\n  ".join(OVER), flush=True)
        return 1
    phase_dispatch(dev, phase_rng("dispatch"))
    phase_serve(dev)
    phase_serve_batch(dev, sweep_args)
    loops = dict(config1=phase_closed_loop(dev),
                 N27=phase_closed_loop_n27(dev, sweep27_args,
                                           recs["admm_k1_split"]))
    print(json.dumps({"closed_loop": loops}), flush=True)
    kernels = []
    for k, r in recs.items():
        r["launches_by_path"] = {p: PATH_LAUNCHES[p][k] for p in PATHS}
        r["launches"] = sum(r["launches_by_path"].values())
        r["on_main_path"] = any(PATH_LAUNCHES[p][k] > 0 for p in SERVED)
        check(r["launches"] > 0, f"{k} was launched on none of the paths")
        kernels.append(r)
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
