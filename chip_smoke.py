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
  5. the main path: the port's serve stdin loop, in process, on
     ``--config double_integrator --device cuda`` — a ping, four feasible
     states, one state outside the box, quit. Every feasible objective
     must be within 1e-3 of the port's enumeration solver on the card
     (600 iterations); the out-of-box state must come back found=false;
     K2's launch count must grow during the phase.

Every kernel result is held against its plain version field by field:
obj, x, z, y, r_prim, r_prim_rel and r_dual within LIMITS, certificate
bits identical.

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
SOURCE = "pyhybridcontrol_tpu_torch/csrc/admm.cu"
REPLACES = {"admm_k1": "pyhybridcontrol_tpu/ops/pallas_admm.py:312",
            "admm_k2": "pyhybridcontrol_tpu/ops/pallas_admm.py:357"}
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
# Limits: 3-5x the largest error of sound runs on an H100 (PERF.md has
# the readings, and the faults each regime catches).
LIMITS = {
    "main": dict(obj=1e-4, x=3e-4, z=3e-4, y=1e-2, r_prim=0.2,
                 r_prim_rel=0.2, r_dual=2.0),
    "far": dict(obj=2e-5, x=1e-4, z=1e-4, y=1e-3, r_prim=1e-2,
                r_prim_rel=1e-2, r_dual=5e-2),
}
SERVE_ATOL = 1e-3   # |obj(B&B) − obj(enumeration)|
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


def compare(tag, got, ref, record, regime="main"):
    """Kernel result vs plain result (AdmmResult), field by field; raises
    if a field is off its limit or the certificate bits differ."""
    import torch

    limits, seen = LIMITS[regime], READINGS.setdefault(regime, {})
    errs = {}
    for k, floor in FLOOR.items():
        g, r = getattr(got, k), getattr(ref, k)
        check(bool(torch.isfinite(g).all()), f"{tag}: non-finite {k}")
        errs[k] = float(((g - r).abs() / torch.clamp_min(r.abs(), floor))
                        .max())
        seen[k] = max(seen.get(k, 0.0), errs[k])
    print(f"  {tag}: " + " ".join(f"{k}={v:.2e}" for k, v in errs.items())
          + f" certs={int(got.infeas_cert.sum())}", flush=True)
    for k, v in errs.items():
        check(v <= limits[k], f"{tag}: {k} off by {v:.3e}, limit "
              f"{limits[k]:.1e}")
    check(torch.equal(got.infeas_cert, ref.infeas_cert),
          f"{tag}: infeasibility certificate bits differ")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0),
                                float((got.obj - ref.obj).abs().max()),
                                float((got.x - ref.x).abs().max()))


READINGS = {}   # largest error per regime and field over the run


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
    rec["ms"] = cuda_ms(lambda: ca.admm_solve_cuda(*args, iters=400))
    rec["plain_ms"] = cuda_ms(lambda: ca.admm_solve_plain(*args, iters=400))
    print(f"  N=10 B=1024 400 it: kernel {rec['ms']:.3f} ms, plain "
          f"{rec['plain_ms']:.3f} ms", flush=True)

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
    print(f"  N=20 B=4096 100 it: kernel {k:.3f} ms, plain {p:.3f} ms",
          flush=True)

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
    for N, B, iters, piters, main in ((10, 32, 400, 400, True),
                                      (20, 4096, 100, 100, False)):
        _, qp, spec, spec_p, f, h, lb, ub = problem(N, B, dev, rng,
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
        k = cuda_ms(lambda: ca.admm_wave_cuda(*args, **kw))
        p = cuda_ms(lambda: ca.admm_wave_plain(*args, **kw))
        if main:
            rec["ms"], rec["plain_ms"] = k, p
        else:
            rec["n20_ms"], rec["n20_plain_ms"] = k, p
        print(f"  {tag}: kernel {k:.3f} ms, plain {p:.3f} ms", flush=True)


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


def phase_serve(dev):
    import torch

    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.ops import cuda_admm as ca

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
    ca.reset_launch_counts()
    serve.stdin_loop(ctrl, ready, inp=io.StringIO("\n".join(lines) + "\n"),
                     out=out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(ca.LAUNCHES)
    replies = [json.loads(s) for s in out.getvalue().splitlines()]
    check(replies[0].get("ready") is True, "serve: no ready line")
    check(replies[1] == {"pong": True}, "serve: ping not answered")
    check(len(replies) == 2 + len(STATES) + 1, "serve: missing replies")
    print(f"  launches during the serve phase: {launches}", flush=True)
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
    return launches


def main(argv=None):
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
    import numpy as np

    from pyhybridcontrol_tpu_torch.ops import _build

    dev = torch.device("cuda")
    gpu = gpu_line()
    print(gpu, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel build + load: {time.perf_counter() - t0:.2f} s "
          f"({_build.BUILD_INFO.get('path')})", flush=True)
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "registers" in line or "bytes stack" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    rng = np.random.default_rng(SEED)
    recs = {k: dict(name=k, route="cuda", source=SOURCE, replaces=v)
            for k, v in REPLACES.items()}
    phase_k1(dev, rng, recs["admm_k1"])
    phase_k2(dev, rng, recs["admm_k2"])
    phase_far(dev, rng, recs)
    for regime, seen in READINGS.items():
        print(f"largest error, {regime} (limit): " + " ".join(
            f"{k}={v:.2e} ({LIMITS[regime][k]:.0e})"
            for k, v in seen.items()), flush=True)
    launches = phase_serve(dev)
    kernels = []
    for k, r in recs.items():
        r["launches"] = launches[k]
        r["on_main_path"] = k == "admm_k2"
        kernels.append(r)
    print(gpu, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
