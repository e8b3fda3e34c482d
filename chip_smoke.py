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
     and without the stiff probe; and the shape limit: the wrapper must
     refuse, not fall back, where the constants do not fit in shared
     memory (N=60);
  5. K1's split-precision phase (``low_frac``, bf16 3-pass products on
     the tensor cores) against its plain version at the reference test's
     shape (N=12, B=128, 120 iterations) and at the bench primary (N=20,
     B=4096, 100 iterations): the tensor-core kernel's own outputs (the
     iterates z_G, y_G, z_B, y_B) after ONE split-precision iteration
     from the same warm iterates (the plain version's after 10 and 50
     iterations), before the bf16 steps drift apart, and objective and
     solution of the whole solve at ``low_frac`` 0.8 and 1.0; then the
     reference bench's own gate: max relative objective delta of
     ``low_frac=1.0`` against full-precision K1 ≤ 1e-4;
  6. no plain version behind a CUDA tensor: with the plain versions made
     to raise, ``admm_solve_auto``, ``admm_wave_auto`` and
     ``admm_solve_cuda(low_frac>0)`` still answer and count their launches;
  7. the single-state serving path: the port's serve stdin loop, in process,
     on ``--config double_integrator --device cuda`` — a ping, four
     feasible states, one state outside the box, quit. Every feasible
     objective must be within 1e-3 of the port's enumeration solver on the
     card (600 iterations); the out-of-box state must come back
     found=false; K2's launch count must grow during the phase;
  8. the batched serving path: ``--config scenario_batch`` (config 4, full
     width: N=10, 1024 instances, pool 32,768, global wave 1024) — one
     2-D request of 1024 seeded states, one of them outside the box,
     through the stdin loop. The reply is list-valued; the out-of-box
     instance is found=false; on a fixed sample of 64 instances ``found``
     and the objective (1e-3) agree with the enumeration controller on the
     card; every K2 launch had B=1024. Then ``solve_miqp_bnb_pooled`` with
     the reference bench's config-4 spec (wave 1024, probe_patience=3,
     pool 8·B), once from nothing and once carrying the first call's
     incumbents: objectives within 1e-3 of the request's; the probe gate
     closes on the second only, where K1 must launch at B=1024. Then the
     relaxation sweep that uses the split-precision phase (N=20, B=4096,
     ``low_frac=1.0``).

Launch counts are kept per path: they are set to 0 just before each of
the served config-1 requests, the served 1024-state request, the
bench-spec pooled call, the pooled call with carried incumbents and the
relaxation sweep, and read just after it; launches made to compare a
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
carries its time at the shape the main path gives it, its plain version's
time and its bound: the larger of the
bytes it must move over the card's memory rate and its operations over
the card's peak rate for their type (NVIDIA H100 SXM data sheet).

Any failed check raises, so the script exits non-zero. It exits non-zero
without a result when no CUDA device is present or when the package is
missing beside it. The last two lines are the kernels JSON and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SOURCES = {"admm_k1": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k2": "pyhybridcontrol_tpu_torch/csrc/admm.cu",
           "admm_k1_mixed": "pyhybridcontrol_tpu_torch/csrc/admm_mixed.cu"}
REPLACES = {"admm_k1": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2": "pyhybridcontrol_tpu/ops/pallas_admm.py:357",
            "admm_k1_mixed": "pyhybridcontrol_tpu/ops/pallas_admm.py:180"}
# the driven paths, in order; the first two are served requests
SERVED = ("serve_config1", "serve_batch_request")
PATHS = SERVED + ("pooled_bench_spec", "pooled_carried_incumbents",
                  "relax_sweep_low_frac")
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
    "far": dict(obj=3e-5, x=2e-4, z=3e-4, y=2.5e-3, r_prim=3e-2,
                r_prim_rel=3e-2, r_dual=0.7),
    "mixed": dict(obj=1e-4, x=0.1),
    "mixed_iterates": dict(zG=3e-3, yG=8e-2, zB=3e-3, yB=1e-3),
}
# the iterate check starts from the plain version's iterates after these
# many split-precision iterations
MIXED_WARM = (10, 50)
MIXED_GATE = 1e-4   # max relative objective delta, low_frac=1.0 vs full K1
SERVE_ATOL = 1e-3   # |obj(B&B) − obj(enumeration)|
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


def chain_ms(nr, mGp, iterations, threads=256):
    """Reckoned floor of ONE problem's dependent iteration chain in K1/K2
    (what bounds a batch too small to fill the card, where the roofline
    bound says nothing): per iteration the serial accumulate chains of the
    kernel's three steps — mGp/(threads/nr) FMAs, threads/nr adds, nr FMAs
    — at 4 cycles each, three shared-memory load latencies of ~30 cycles
    and three block-wide barriers of ~20 cycles, at the 1.98 GHz boost
    clock. The latencies are assumed round figures, not measured."""
    S = max(threads // nr, 1)
    cycles = 4 * (-(-mGp // S) + S + nr) + 3 * 30 + 3 * 20
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
    rec["enum_plain_ms"] = cuda_ms(
        lambda: ca.admm_solve_plain(*args, iters=400))
    print(f"  N=10 B=1024 400 it: kernel {rec['enum_ms']:.3f} ms, plain "
          f"{rec['enum_plain_ms']:.3f} ms", flush=True)

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
    rec["plain_ms"] = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100,
                                                          warm=warm))
    set_bound(rec, args[0], BATCH, products=101, stats=1, warm=True)
    print(f"  N=10 B=1024 100 it warm: kernel {rec['ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)

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
    p = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=100))
    rec["n20_ms"], rec["n20_plain_ms"] = k, p
    rec["n20_bound_ms"] = bound(*admm_work(
        args[0].n_pad, args[0].m_pad, 4096, products=101, stats=1,
        warm=False))[0]
    print(f"  N=20 B=4096 100 it: kernel {k:.3f} ms, plain {p:.3f} ms, "
          f"bound {rec['n20_bound_ms']:.4f} ms", flush=True)

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
        compare(tag + " relax", got[0], ref[0], rec)
        compare(tag + " probe", got[1], ref[1], rec)
        warm = (ref[0].x, ref[0].z, ref[0].y)
        got = ca.admm_wave_cuda(*args, warm=warm, **kw)
        ref = ca.admm_wave_plain(*args, warm=warm, **kw)
        compare(tag + " warm relax", got[0], ref[0], rec)
        compare(tag + " warm probe", got[1], ref[1], rec)
        # timed warm-started, as every wave after the root is; the bound
        # counts (iters+1) + p1 + (p2+1) product pairs and two stats blocks
        k = cuda_ms(lambda: ca.admm_wave_cuda(*args, warm=warm, **kw))
        p = cuda_ms(lambda: ca.admm_wave_plain(*args, warm=warm, **kw))
        b = bound(*admm_work(args[0].n_pad, args[0].m_pad, B,
                             products=iters + piters + 2, stats=2,
                             warm=True, stiff=True, outputs=2))
        pre = tagk + "_" if tagk else ""
        rec[pre + "ms"], rec[pre + "plain_ms"] = k, p
        rec[pre + "bound_ms"] = b[0]
        if not tagk:     # config 4's wave: the shape of the batched path
            rec["bound_by"], rec["library_ms"] = b[1], None
        chain = chain_ms(args[0].n_pad, args[0].m_pad, iters + piters + 2)
        rec[pre + "chain_ms"] = chain
        print(f"  {tag} warm: kernel {k:.3f} ms, plain {p:.3f} ms, bound "
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
            compare(tag + " relax", got[0], ref[0], recs["admm_k2"], "far")
            compare(tag + " probe", got[1], ref[1], recs["admm_k2"], "far")

    lib = load_library()
    for N in (21, 22):
        kq = ca.kernel_qp_for(problem(N, 1, dev, rng)[2])
        need = lib.phc_admm_smem_bytes(kq.n_pad, kq.m_pad, 1, 1)
        print(f"  N={N}: K2 with the stiff probe needs {need} bytes of "
              f"shared memory per block (limit {ca.SMEM_MAX})", flush=True)
    _, qp, spec, spec_p, f, h, lb, ub = problem(60, 2, dev, rng)
    args = (ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p), qp.binary_idx,
            f, h, lb, ub)
    try:
        ca.admm_wave_cuda(*args, **kw)
    except ValueError as e:
        print(f"  N=60 refused by the wrapper: {e}", flush=True)
    else:
        raise AssertionError("N=60: the wrapper must refuse the shape")


def phase_k1_mixed(dev, rng, rec):
    """K1 with its split-precision phase against the plain version, then
    the relaxation sweep's gate against full-precision K1."""
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
        cold = ca._init_iterates(*packed[1:], None)
        for k0 in MIXED_WARM:
            it = tuple(t.contiguous() for t in
                       ca._mixed_plain(kq16, *packed, cold, k0))
            held(f"N={N} B={B} one split-precision it after {k0}",
                 "mixed_iterates",
                 dict(zip(("zG", "yG", "zB", "yB"),
                          zip(ca._launch_k1_mixed(kq16, *packed, it, 1),
                              ca._mixed_plain(kq16, *packed, it, 1)))))
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
                                                     low_frac=1.0))):
        times[name] = cuda_ms(fn)
    rec.update(times)
    # the function's own shape (nr=64, mGp=200), not the 16-grain padding
    set_bound(rec, kq, 4096, products=1, stats=1, warm=False,
              lo_products=100)
    print(f"  N=20 B=4096 100 it: low_frac=1.0 {rec['ms']:.3f} ms, "
          f"low_frac=0.8 {rec['lf08_ms']:.3f} ms, full-precision K1 "
          f"{rec['full_ms']:.3f} ms, plain (low_frac=1.0) "
          f"{rec['plain_ms']:.3f} ms, bound {rec['bound_ms']:.4f} ms "
          f"({rec['bound_by']})", flush=True)
    return args


def phase_dispatch(dev, rng):
    """On a CUDA tensor no path reaches a plain version: with the plain
    versions made to raise, the entry points still answer, and each counts
    a launch of its kernel."""
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

    def refuse(*a, **kw):
        raise AssertionError("a CUDA tensor reached a plain version")

    _, qp, spec, spec_p, f, h, lb, ub = problem(10, 48, dev, rng)
    saved = {k: getattr(ca, k) for k in
             ("admm_solve_plain", "admm_wave_plain", "_solve_plain",
              "_mixed_plain", "_relax", "_phase")}
    for k in saved:
        setattr(ca, k, refuse)
    try:
        ca.reset_launch_counts()
        ca.admm_solve_auto(spec, f, h, lb, ub, iters=10)
        check(ca.LAUNCHES["admm_k1"] == 1, "admm_solve_auto: no K1 launch")
        ca.admm_wave_auto(spec, spec_p, qp.binary_idx, f, h, lb, ub,
                          iters=10, probe_iters=10)
        check(ca.LAUNCHES["admm_k2"] == 1, "admm_wave_auto: no K2 launch")
        ca.admm_solve_cuda(ca.kernel_qp_for(spec), f, h, lb, ub, iters=10,
                           low_frac=0.5)
        check(ca.LAUNCHES == {"admm_k1": 2, "admm_k2": 1,
                              "admm_k1_mixed": 1},
              f"admm_solve_cuda(low_frac): launches {ca.LAUNCHES}")
    finally:
        for k, v in saved.items():
            setattr(ca, k, v)
    print(f"no plain version behind a CUDA tensor: launches {ca.LAUNCHES}, "
          f"batch sizes {ca.LAUNCH_BATCHES}", flush=True)


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
    worst, at = 0.0, 0.0
    for i in BATCH_SAMPLE:
        ref = enum.feedback(x0s[i])
        check(bool(ref.found) == bool(found[i]),
              f"serve_batch: instance {i} found={found[i]}, enumeration "
              f"{bool(ref.found)}")
        if found[i] and abs(obj[i] - float(ref.obj)) > worst:
            worst, at = abs(obj[i] - float(ref.obj)), float(ref.obj)
    print(f"  {len(BATCH_SAMPLE)} sampled instances vs enumeration: max "
          f"|Δobj| {worst:.2e} (at obj {at:.1f})", flush=True)
    check(worst <= SERVE_ATOL, f"serve_batch: |Δobj|={worst:.3e} vs "
          "enumeration")

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
        d = float(dobj.max())
        print(f"  solve_miqp_bnb_pooled (wave 1024, probe_patience=3, pool "
              f"8·B{tag}): {ms:.1f} ms, {res.waves} waves, {nodes} nodes, "
              f"{1e3 * BATCH / ms:.1f} MIQP/s, {1e3 * nodes / ms:.0f} "
              f"nodes/s, found share {found4.mean():.4f}, overflow "
              f"{bool(res.overflow)}, K1 launches (gated waves) {k1}, max "
              f"|Δobj| vs the request {d:.2e} (at obj "
              f"{obj[dobj.argmax()]:.1f})", flush=True)
        check(bool((found4 == found)[others].all()) and
              bool(found4[BATCH_OUT_OF_BOX]),
              "pooled call: found differs from the served request")
        check(d <= SERVE_ATOL, f"pooled call: |Δobj|={d:.3e} vs the request")
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
    # waves run K1 alone.
    _, k1 = timed4(PATHS[3], ", incumbents carried",
                   (res.obj, res.x, res.found))
    check(k1 > 0, "pooled call: K1 never launched on the gated waves")

    # the relaxation sweep that uses the split-precision phase
    sweep, _ = drive(PATHS[4], lambda: ca.admm_solve_cuda(
        *sweep_args, iters=100, low_frac=1.0))
    check(bool(torch.isfinite(sweep.obj).all()), "relax sweep: non-finite")
    check(PATH_LAUNCHES[PATHS[4]] == {"admm_k1": 1, "admm_k2": 0,
                                      "admm_k1_mixed": 1},
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
    for x, r in zip(STATES, replies[2:2 + len(STATES)]):
        check("error" not in r, f"serve: error reply {r}")
        ref = enum.feedback(x)
        check(r["found"] and bool(ref.found), f"serve: x0={x} not found")
        d = abs(r["obj"] - float(ref.obj))
        print(f"  x0={x}: obj={r['obj']:.6f} enumeration="
              f"{float(ref.obj):.6f} |Δ|={d:.2e} ms={r['ms']}", flush=True)
        check(d <= SERVE_ATOL, f"serve: x0={x} |Δobj|={d:.3e} vs "
              "enumeration")
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
