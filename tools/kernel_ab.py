"""Kernel-alone times of K1, K2 and the split-precision kernel of two
checkouts on one card, in one run, and the end-to-end times of the real
frames' paths (a development tool, not part of the package):

    python tools/kernel_ab.py --parent DIR [--ablate] [--e2e]
    python tools/kernel_ab.py --parent DIR --stagewise
    python tools/kernel_ab.py --parent DIR --wide
    python tools/kernel_ab.py --parent DIR --flex
    python tools/kernel_ab.py --parent DIR --k6 [--e2e]

Run from the root of a checkout ("change"); DIR is a checkout of the commit
to compare with ("parent", for example ``git archive`` of it unpacked into
a directory that .gitignore lists). Each tree is copied into a fresh
temporary directory, builds its own kernels there and is timed by the same
worker, in the order parent, change, change, parent. Times are CUDA events
recorded just before and after each call into a kernel library (so the
wrapper's packing, checks and allocations are outside), median of 7 after a
warm-up, at the shapes of PERF.md's kernel table (N=27 and the real
frames of configs 2, 3, 4b and 4c: the plan's variant, L2-streamed in
the parent of the cluster variant, resident since); each shape is also run
with twice the iterations, which splits its time into a part per iteration
and a fixed part (staging, loads, stats, stores). The split-precision row
("K1mixed", ``low_frac=1.0``) times ``phc_admm_k1_mixed`` alone; K1's
0-iteration launch that follows it (half step and stats) is timed apart
("tail").

``--ablate`` also builds, per tree, copies of a kernel source with the loop
of one product taken out (results are wrong, times are what is left): in
``csrc/admm.cu`` the multiply-add loop of t = Â_Gᵀw (A) or ẑ = M t (B), in
``csrc/admm_mixed.cu`` the tensor-core loop of the t or the u = M t
product. That gives the time each loop costs per iteration, and what
barriers, reductions and the row update cost.

``--e2e`` also runs, per tree and in the same order, the real frames'
paths end to end (host clock around work that ends in a synchronise):
three served config-2 requests (``serve --config pwa_actuator``, the
reply's ms), the config-2 and 2b calls and config 3's and 4b's loops
(``chip_smoke.py``'s phases 14, 16 and 17, their checks included) and two
repetitions of the config-4c call (256 trees, ``feedback_batch`` pooled).

``--stagewise`` runs, per tree and in the same order, ``chip_smoke.py``'s
phase 21 instead (its checks included): config 6's parity arm (ms), its
long arm (a warm-up and the median of 3 solves, ms a solve), the three
served ``--solver stagewise`` requests (the replies' ms) and the
stagewise transforms hold (ms), with the device's idle share over one
long-arm wave's relaxation; then phase 22 (K5 against its plain version
at every driven stagewise shape) for K5's times alone there (the long
arm's relaxation and probe, the parity arm, the served frame, the
transforms hold); and each tree's ``-Xptxas -v`` lines of K5.

``--wide`` runs, per tree and in the same order, K4 and K5 on the same
inputs at the wide sweep's shapes (bmax 32 to 128): the battery fleets of
``chip_smoke.py`` at b = 32 (``battery_fleet``'s frame, N = 96), 20 (five
batteries, shared), 64 and 128, and the ω tree (b = 20, S = 16, grouped),
each K5 launch the wave's cold relaxation (150 iterations) as its B&B
makes it and then 20 iterations warm from it, K4 on the same factors (P =
8), and K4 at phase 20's random wide factors, staged and through L2. It
times each alone (CUDA events around the library calls, median), runs
the ``battery_fleet`` path once (solve seconds, a relaxation's and a
probe's K5 time), profiles one more of its solves (device busy time, idle
share), and reports, against the first parent run, whether every output
of every launch (K4's x; K5's x, z, y, dy, z_e, y_e, dy_e) is bitwise
equal, and whether the inputs were (a digest of each).

``--flex`` runs, per tree and in the same order, K5 on the same inputs at
``chip_smoke.flex_waves``' long_horizon waves (the double integrator at
N=1000, the hull model at N=300, 8 nodes each): the wave's cold
relaxation (150 iterations) as its B&B makes it and 20 iterations warm
from it, in the variant each tree's plan takes there (the global variant
in the parent, the horizon variant's sequential sweep here, forced at the
parent's lanes a stage, the global plan's), each alone at 20 and 150
iterations; where the tree has the horizon variant, also at its plan's
lanes and in its parallel sweep; at the wide trees' waves (config 6's
tree at S = 16, 27, 64) the same two launches at the grouped variant's
placement of the parent (⌈S/16⌉ scenarios a CTA: the parent's plan, forced
in a tree whose plan deals portable clusters), each alone at 20 and 150
iterations, and in such a tree also its plan's (with the clusters the card
holds at once); then each wide tree's stagewise tree MIQP solved four
times (``chip_smoke.py``'s ``wide_tree``: a warm-up and three on the host
clock, its objective, found flag, nodes and waves, the last one's K5
launches, iterations and CUDA-event time) and once more under
torch.profiler (the idle share against that run's wall time), the last
two as ``chip_smoke.long_warm_reading`` reads them. It
reports, against the first parent run, whether the seven carries of each
launch are bitwise equal and whether the inputs were.

``--k6`` runs, per tree and in the same order, K6 (the stagewise sweep
at any b, ``csrc/stagewise_any.cu``; only that library is built) on the
same inputs at every shape of ``chip_smoke.K6_SHAPES`` (P = 1 and 64, and
fleet_b160's wave P = 8 at b = 160), sequential and over
``any_windows(N)`` windows, each timed alone (CUDA events around the
library call, median of 7), and reports, against the first parent run,
whether every output is bitwise equal (else its largest |Δ|) and whether
the inputs were. With ``--e2e`` each run then drives ``chip_smoke.py``'s
phase 41 (fleet_b160 and its ``parallel_sweeps`` twin: seconds a solve,
objective, nodes, K6's launches, and a warm re-solve under
torch.profiler: idle share and K6's device milliseconds).

Prints one JSON line per run and a table at the end.
"""

from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = "pyhybridcontrol_tpu_torch/csrc/"
# ablation -> (kernel source, [(text, replacement), ...]): the loop of one
# product, by the texts each tree's source has it in (the block variants'
# and the resident variant's; each found occurs once, and at least one)
ABLATIONS = {
    "no loop A": ("admm.cu", [
        ("for (int i = sl; i < mGp; i += S) acc = fmaf(s.AG[i * nr + j], "
         "s.wG[i], acc);", ""),
        ("s.AG, s.AS, s.w, mGp, nr, [&](int j, int p, const auto& v) {",
         "s.AG, s.AS, s.w, 0, nr, [&](int j, int p, const auto& v) {"),
        ("s.AG, s.AS, s.w, mGp, nr, pt.a0, pt.a1, pt.jA,",
         "s.AG, s.AS, s.w, 0, nr, pt.a0, pt.a1, pt.jA,")]),
    "no loop B": ("admm.cu", [
        ("for (int c = 0; c < nr; ++c) u = fmaf(MT[c * R + r], s.t[c], u);",
         ""),
        ("s.MT, s.RS, s.t, nr, R, [&](int r, int p, const auto& u) {",
         "s.MT, s.RS, s.t, 0, R, [&](int r, int p, const auto& u) {"),
        ("s.MT, s.RS, s.t, nr, R, pt.b0, pt.b1, pt.rB,",
         "s.MT, s.RS, s.t, 0, R, pt.b0, pt.b1, pt.rB,")]),
    "mixed: no t loop": ("admm_mixed.cu", [
        ("mma3(acc, s.Ahi", "if (0) mma3(acc, s.Ahi"),
        ("product<T>(acc, base + s.Ahi", "if (0) product<T>(acc, base + s.Ahi")]),
    "mixed: no u loop": ("admm_mixed.cu", [
        ("mma3(acc, s.Mhi", "if (0) mma3(acc, s.Mhi"),
        ("product<T>(acc, base + s.Mhi", "if (0) product<T>(acc, base + s.Mhi")]),
}
WORKER = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build, cuda_admm as ca

dev = torch.device("cuda")
pairs = []

def shim(name, orig):
    def call(*a):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record(); rc = orig(*a); e1.record()
        pairs.append((name, e0, e1))
        return rc
    return call

for lib, name in (("admm", "phc_admm_k1"), ("admm", "phc_admm_k2"),
                  ("admm_mixed", "phc_admm_k1_mixed")):
    lib = _build.load_library(lib)
    setattr(lib, name, shim(name, getattr(lib, name)))

# per entry of ``names`` (a tuple of library functions): the median over
# ``reps`` calls of fn() of the summed time of those functions' launches
def alone(fn, names, reps=7):
    fn()
    times = {k: [] for k in names}
    for _ in range(reps):
        pairs.clear(); fn(); torch.cuda.synchronize()
        for k in names:
            times[k].append(sum(a.elapsed_time(b) for n, a, b in pairs
                                if n in k))
    return [sorted(v)[reps // 2] for v in times.values()]

out = {}
for kind, N, B, iters in (("K2", 10, 1024, 100), ("K2", 10, 32, 400),
                          ("K2", 20, 4096, 100), ("K1", 20, 4096, 100),
                          ("K1mixed", 20, 4096, 100), ("K1", 10, 1024, 100),
                          ("K2", 27, 32, 200), ("K1", 27, 300, 100)):
    _, qp, spec, spec_p, f, h, lb, ub = cs.problem(
        N, B, dev, cs.phase_rng(f"ab{N}_{B}"), fix_frac=0.3)
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    r0 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=50)
    warm = (r0.x, r0.z, r0.y)
    for mult in (1, 2):
        it = iters * mult
        if kind == "K2":
            fn = lambda: ca.admm_wave_cuda(kq, kq2, qp.binary_idx, f, h, lb,
                                           ub, iters=it, probe_iters=it,
                                           warm=warm)
            n_it = 2 * it + 2
        elif kind == "K1":
            fn = lambda: ca.admm_solve_cuda(kq, f, h, lb, ub, iters=it,
                                            warm=warm)
            n_it = it + 1
        else:   # the split-precision kernel alone, then K1's tail apart
            fn = lambda: ca.admm_solve_cuda(kq, f, h, lb, ub, iters=it,
                                            warm=warm, low_frac=1.0)
            mixed, tail = alone(fn, (("phc_admm_k1_mixed",),
                                     ("phc_admm_k1",)))
            out[f"{kind} N={N} B={B} x{mult}"] = (mixed, it, tail)
            continue
        out[f"{kind} N={N} B={B} x{mult}"] = (
            alone(fn, (("phc_admm_k1", "phc_admm_k2"),))[0], n_it)

# the real frames' path shapes (warm from 50 plain iterations); "K1probe":
# the two launches of config 4c's probe (ρ·10, then ρ, chained)
for kind, name, B, iters, piters in (
        ("K2", "config2", 128, 200, 600), ("K2", "config2", 64, 400, 400),
        ("K2", "config3", 64, 200, 200), ("K2", "config4b", 1024, 150, 150),
        ("K1", "config2", 128, 200, 0), ("K1", "config4b", 1024, 150, 0),
        ("K1", "config4c", 1024, 100, 0), ("K1probe", "config4c", 1024, 200, 200),
        ("K2", "config4c", 64, 100, 400)):
    spec, spec_p, bidx, f, h, lb, ub = cs.real_problem(
        name, B, dev, cs.phase_rng(f"ab_{name}_{B}"))
    kq, kq2 = ca.kernel_qp_for(spec), ca.kernel_qp_for(spec_p)
    r0 = ca.admm_solve_plain(kq, f, h, lb, ub, iters=50)
    warm = (r0.x, r0.z, r0.y)
    for mult in (1, 2):
        it, pit = iters * mult, piters * mult
        if kind == "K2":
            fn = lambda: ca.admm_wave_cuda(kq, kq2, bidx, f, h, lb, ub,
                                           iters=it, probe_iters=pit,
                                           warm=warm)
            n_it = it + pit + 2
        elif kind == "K1":
            fn = lambda: ca.admm_solve_cuda(kq, f, h, lb, ub, iters=it,
                                            warm=warm)
            n_it = it + 1
        else:
            def fn():
                a = ca.admm_solve_cuda(kq2, f, h, lb, ub, iters=it, warm=warm)
                return ca.admm_solve_cuda(kq, f, h, lb, ub, iters=pit,
                                          warm=(a.x, a.z, a.y))
            n_it = it + pit + 2
        out[f"{kind} {name} B={B} {iters}+{piters} x{mult}"] = (
            alone(fn, (("phc_admm_k1", "phc_admm_k2"),))[0], n_it)

if E2E:
    import io
    import time
    import numpy as np
    from pyhybridcontrol_tpu_torch import serve
    from pyhybridcontrol_tpu_torch.control.mpc import MpcController
    from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

    e2e = {}
    ctrl, ready = serve.build_controller("pwa_actuator", "bnb", "cuda")
    lines = [json.dumps({"x": x}) for x in cs.CFG2_STATES]
    buf = io.StringIO()
    serve.stdin_loop(ctrl, ready, inp=io.StringIO(
        "\n".join(lines + ['{"cmd": "quit"}']) + "\n"), out=buf)
    e2e["config2 served request ms"] = [
        json.loads(ln)["ms"] for ln in buf.getvalue().splitlines()[1:]]
    calls = cs.phase_config2_calls(dev)
    e2e["config2 call ms"] = calls["config2_call"]["ms_per_solve"]
    e2e["config2b call ms"] = calls["config2b_call"]["ms_per_solve"]
    e2e["config3 loop ms/step"] = cs.phase_config3_loop(dev)[
        "ms_per_control_step"]
    e2e["config4b loop s"] = cs.phase_config4b_loop(dev)["seconds"]
    tree, rng = cs.config4c_tree()
    model, w, c = cs.bench_frame("config4c")
    ctrl = MpcController(model, cs.CFG4C_N, w, device=dev)
    ctrl.set_scenario_tree(tree)
    ctrl.bnb_spec = BnbSpec(**cs.CFG4C_SPEC)
    xs = torch.as_tensor(rng.normal(size=(cs.CFG4C_B, 2)).astype(np.float32),
                         device=dev)
    e2e["config4c call s"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctrl.feedback_batch(xs, engine="pooled", pooled_wave=1024,
                            pool_slots=8 * cs.CFG4C_B)
        torch.cuda.synchronize()
        e2e["config4c call s"].append(time.perf_counter() - t0)
    print("E2E " + json.dumps(e2e), flush=True)
print("AB " + json.dumps(out), flush=True)
"""


STAGEWISE_WORKER = r"""
import json, sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build

for lib in _build.LIBRARIES:
    _build.load_library(lib)
dev = torch.device("cuda")
out = cs.phase_config6(dev)
rec = {}
cs.phase_k5(dev, cs.phase_rng("k5"), rec)
print("SW " + json.dumps({
    "parity ms": out["parity"]["ms"],
    "long arm ms a solve": out["long"]["ms_per_solve"],
    "long arm s": out["long"]["seconds"],
    "long arm wave idle share": out["long"]["profile"]["idle_share"],
    "served ms": out["serve_ms"],
    "transforms ms": out["transforms"]["ms"],
    "K5 alone ms, long arm relaxation": rec["kernel_ms"],
    "K5 alone ms, long arm probe": rec["cfg6_probe_kernel_ms"],
    "K5 alone ms, parity arm": rec["cfg6_parity_kernel_ms"],
    "K5 alone ms, served frame": rec["serve_sw_kernel_ms"],
    "K5 alone ms, transforms hold": rec["transforms_kernel_ms"],
    "ptxas": [ln for ln in cs.ptxas_report(_build.BUILD_INFO.get("log", ""))
              if "sw_admm" in ln]}), flush=True)
"""


WIDE_WORKER = r"""
import hashlib, json, sys, time
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as k
from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
    StagewiseTreeBackend, assemble_stagewise_tree,
    assemble_stagewise_tree_ext, pack_stagewise_tree_data)
from pyhybridcontrol_tpu_torch.profile_serve import profile_request

for lib in _build.LIBRARIES:
    _build.load_library(lib)
dev = torch.device("cuda")
saved, res = {}, {}


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def waves():
    rng = cs.phase_rng("kernel_ab_wide")
    for M, N in ((cs.FLEET_M, cs.FLEET_N), (5, 8), (16, 48), (32, 24)):
        _, be, fb, hb, lb, ub = cs.fleet_wave(dev, rng, M, N)
        yield f"{M} batteries N={N}", be, fb, hb, lb, ub
    swt, x0 = cs.omega_fleet_tree(dev)
    xt = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    be = StagewiseTreeBackend(swt, ext_u=assemble_stagewise_tree_ext(swt, xt))
    f, h = pack_stagewise_tree_data(*assemble_stagewise_tree(swt, xt))
    yield (f"omega tree S={cs.ANY_TREE_S} N={cs.ANY_TREE_N}", be,
           *cs.wave_boxes(be, f, h, 8, rng, cs.K4_HOLD_FIX))


for tag, be, fb, hb, lb, ub in waves():
    with cs.k5_calls() as calls:
        be.solve(fb, hb, lb, ub, cs.K5_RELAX)
    args = calls[0]
    sw = args[0]
    P, pl = cs.k5_plan_of(args)
    relax = k.sw_admm_cuda(*args)
    held = cs.with_warm(args, relax, 20)
    saved[tag + ", K5 relaxation"] = relax
    saved[tag + ", K5 20 it warm"] = k.sw_admm_cuda(*held)
    t = torch.as_tensor(np.random.default_rng(sw.b).normal(
        size=(8, sw.N, sw.b)), dtype=torch.float32, device=dev)
    saved[tag + ", K4"] = (k.sw_solve_k_cuda(t, sw.factors),)
    res[tag] = dict(
        inputs=digest(list(args[1:10]) + [t] + list(sw.factors)),
        plan=str(pl), k4_plan=str(k.plan_sweep(8, sw.N, sw.b)),
        k4_ms=cs.kernel_ms(lambda: k.sw_solve_k_cuda(t, sw.factors), 7),
        k5_20_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*held), 7),
        k5_relax_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*args), 3))
    print(tag, json.dumps(res[tag]), flush=True)
for tag, factors, P in cs.k4_wide(dev, cs.phase_rng("kernel_ab_k4")):
    N, b = factors[0].shape[:2]
    t = torch.as_tensor(np.random.default_rng(b).normal(size=(P, N, b)),
                        dtype=torch.float32, device=dev)
    for st in ((True, False) if k.plan_sweep(P, N, b).staged else (False,)):
        name = f"{tag}, K4 {'staged' if st else 'through L2'}"
        saved[name] = (k.sw_solve_k_cuda(t, factors, staged=st),)
        res[name] = dict(inputs=digest([t, *factors]),
                         k4_ms=cs.kernel_ms(
                             lambda: k.sw_solve_k_cuda(t, factors, st), 7))
fleet = cs.phase_battery_fleet(dev)
res["battery_fleet"] = {key: fleet[key] for key in (
    "s", "obj", "nodes", "relax_kernel_ms", "probe_kernel_ms")}
c, price, x0, _ = cs.fleet_controller(cs.FLEET_M, cs.FLEET_N, dev)


def solve():
    return c.feedback(x0, price_seq=price)


solve()
times = []
for _ in range(3):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solve()
    torch.cuda.synchronize()
    times.append(1e3 * (time.perf_counter() - t0))
prof = profile_request(solve)
prof["ms"] = sorted(times)[1]
prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["ms"]
res["battery_fleet"]["profile"] = prof
torch.save({key: tuple(None if v is None else v.cpu() for v in val)
            for key, val in saved.items()}, sys.argv[1])
print("WIDE " + json.dumps(res), flush=True)
"""


FLEX_WORKER = r"""
import hashlib, json, sys, time
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as k

for lib in _build.LIBRARIES:
    _build.load_library(lib)
dev = torch.device("cuda")
saved, res = {}, {}
horizon = "horizon" in k.ADMM_LAUNCH


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        if isinstance(t, torch.Tensor):
            h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


# a tree whose cuda_stagewise builds member lists has the grouped plan of
# portable clusters; the parent's placement is then forced (⌈S/16⌉
# scenarios a CTA, the grouped variant)
members = hasattr(k, "group_members")
for tag, key, be, fb, hb, lb, ub, _ in cs.flex_waves(
        dev, cs.phase_rng("kernel_ab_flex")):
    if key.startswith("tree"):
        with cs.k5_calls() as calls:
            be.solve(fb, hb, lb, ub, cs.K5_RELAX)
        args = calls[0]
        sw, S = args[0], args[11].shape[0]
        kw = dict(variant="grouped", spc=-(-S // 16)) if members else {}
        relax = k.sw_admm_cuda(*args, **kw)
        held = cs.with_warm(args, relax, 20)
        saved[tag + ", K5 relaxation at the parent's placement"] = relax
        saved[tag + ", K5 20 it warm at the parent's placement"] = \
            k.sw_admm_cuda(*held, **kw)
        P, pl = cs.k5_plan_of(args)
        r = res[tag] = dict(
            inputs=digest(list(args[1:10]) + list(sw.factors) + [args[11]]),
            plan=str(pl),
            k5_20_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*held, **kw), 7),
            k5_relax_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*args, **kw), 3))
        if members:
            r["k5_20_ms_plan"] = cs.kernel_ms(
                lambda: k.sw_admm_cuda(*held), 7)
            r["k5_relax_ms_plan"] = cs.kernel_ms(
                lambda: k.sw_admm_cuda(*args), 3)
            r["held"] = [v for c, v in sw.cache.items()
                         if c[0] == "k5_clusters"]
        print(tag, json.dumps(r), flush=True)
        continue
    with cs.k5_calls() as calls:
        be.solve(fb, hb, lb, ub, cs.K5_RELAX)
    args = calls[0]
    sw = args[0]
    P, pl = cs.k5_plan_of(args)
    glob = k.plan_admm(P, sw.N, sw.b, sw.m_k, variant="global")
    kw = dict(tps=glob.tps) if horizon else {}
    relax = k.sw_admm_cuda(*args, **kw)
    held = cs.with_warm(args, relax, 20)
    saved[tag + ", K5 relaxation"] = relax
    saved[tag + ", K5 20 it warm"] = k.sw_admm_cuda(*held, **kw)
    r = res[tag] = dict(
        inputs=digest(list(args[1:10]) + list(sw.factors)), plan=str(pl),
        k5_20_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*held, **kw), 7),
        k5_relax_ms=cs.kernel_ms(lambda: k.sw_admm_cuda(*args, **kw), 3))
    if horizon:
        for name, kw2 in (("plan", {}), ("parallel", dict(parallel=True))):
            r[f"k5_20_ms_{name}"] = cs.kernel_ms(
                lambda: k.sw_admm_cuda(*held, **kw2), 7)
            r[f"k5_relax_ms_{name}"] = cs.kernel_ms(
                lambda: k.sw_admm_cuda(*args, **kw2), 3)
    print(tag, json.dumps(r), flush=True)
from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
    assemble_stagewise_tree, assemble_stagewise_tree_ext,
    solve_tree_miqp_stagewise)
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec

x0 = torch.tensor(cs.X0_6, device=dev)
for S, steps in cs.WIDE_TREES:
    swt, swtp = cs.config6_preps(dev, cs.wide_tree(S, steps),
                                 cs.config6_extra(cs.CFG6_N))
    data = assemble_stagewise_tree(swt, x0)
    eu = assemble_stagewise_tree_ext(swt, x0)
    def solve():
        return solve_tree_miqp_stagewise(swt, *data, BnbSpec(**cs.WIDE_SPEC),
                                         swt_probe=swtp, ext_u=eu)

    secs = []
    for rep in range(3):             # a warm-up, then two timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = solve()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    # the third timed solve, its K5 launches, and a profiled one
    w = cs.long_warm_reading(f"wide_tree S={S}", solve)
    log = w["timed_launches"]
    res[f"wide_tree S={S}"] = dict(
        solve_s=secs[1:] + [w["ms"] / 1e3], obj=float(got.obj),
        found=bool(got.found), nodes=int(got.nodes_solved),
        waves=int(got.waves), k5_launches=len(log),
        k5_iters=sum(r["iters"] for r in log),
        k5_event_ms=sum(r["ms"] for r in log),
        profiled_wall_ms=w["wall_ms"], idle_share=w["idle_share"])
    print(f"wide_tree S={S}", json.dumps(res[f"wide_tree S={S}"]),
          flush=True)
torch.save({key: tuple(None if v is None else v.cpu() for v in val)
            for key, val in saved.items()}, sys.argv[1])
print("FLEX " + json.dumps(res), flush=True)
"""


K6_WORKER = r"""
import hashlib, json, sys
import numpy as np
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as k

_build.LIBRARIES = {"stagewise_any": _build.LIBRARIES["stagewise_any"]}
_build.load_library("stagewise_any")
dev = torch.device("cuda")
saved, res = {}, {}


def digest(ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


rng = cs.phase_rng("kernel_ab_k6")
for tag, b, N, key in cs.K6_SHAPES:
    sw = cs.k6_factors(dev, rng, key, b, N)
    C = k.any_windows(N)
    maps = k.any_maps(sw, C)
    for P in cs.K6_BATCHES + ((cs.K6_MAIN[2],) if (b, N) == cs.K6_MAIN[:2]
                              else ()):
        r = torch.as_tensor(np.random.default_rng(1000 * b + 10 * N + P)
                            .normal(size=(P, N, b)), dtype=torch.float32,
                            device=dev)
        for w in (1, C):
            def fn(w=w):
                return k.sw_solve_k_any_cuda(r, sw.factors, windows=w,
                                             maps=maps if w > 1 else None)

            name = f"{tag} b={b} N={N} P={P} C={w}"
            saved[name] = (fn(),)
            res[name] = dict(
                inputs=digest([r, *sw.factors] + ([maps] if w > 1 else [])),
                plan=str(k.plan_sweep_any(P, N, b, w)),
                k6_ms=cs.kernel_ms(fn, 7))
            print(name, json.dumps(res[name]), flush=True)
if E2E:
    got = cs.phase_fleet_b160(dev)
    for path, r in got.items():
        prof = r.get("profile", {})
        res[path] = dict(s=r["s"], obj=r["obj"], nodes=r["nodes"],
                         k6_launches=r["k6_launches"],
                         wall_ms=prof.get("wall_ms"),
                         idle_share=prof.get("idle_share"),
                         k6_device_ms=prof.get("k6_device_ms"),
                         device_busy_ms=prof.get("device_busy_ms"))
        print(path, json.dumps(res[path]), flush=True)
torch.save({key: tuple(v.cpu() for v in val) for key, val in saved.items()},
           sys.argv[1])
print("K6 " + json.dumps(res), flush=True)
"""


def run_worker(copy: Path, out: Path, worker: str, marker: str) -> dict:
    """A worker in ``copy`` (a tree's package and chip_smoke.py, its
    kernels built there at the first run): its times (the JSON after
    ``marker``) and, in ``out``, every output it computed."""
    got = subprocess.run([sys.executable, "-c", worker, str(out)],
                         cwd=copy, capture_output=True, text=True)
    for line in got.stdout.splitlines():
        if line.startswith(marker + " "):
            return json.loads(line[len(marker) + 1:])
    raise RuntimeError(f"{copy}: {marker} worker failed:\n"
                       f"{got.stdout[-3000:]}\n{got.stderr[-3000:]}")


def bitwise(a, b) -> str:
    """"bitwise" where every tensor of the two outputs has the same bits
    (None where both are None), else the fields that differ with their
    largest |Δ|."""
    import torch

    names = ("x", "z", "y", "dy", "z_e", "y_e", "dy_e")
    off = []
    for name, u, v in zip(names, a, b):
        if u is None or v is None:
            if (u is None) != (v is None):
                off.append(f"{name}: missing")
            continue
        if u.shape != v.shape or not torch.equal(u.view(torch.int32),
                                                 v.view(torch.int32)):
            d = ((u - v).abs().max().item() if u.shape == v.shape
                 else float("nan"))
            off.append(f"{name}: max |Δ| {d:.3e}")
    return "bitwise" if not off else "; ".join(off)


def main_wide(trees, gpu, worker=WIDE_WORKER, marker="WIDE",
              title="the wide sweep") -> int:
    import torch

    runs = []
    with tempfile.TemporaryDirectory(prefix="phc_ab_") as tmp:
        copies = {}
        for name, tree in trees.items():
            copies[name] = Path(tmp) / name
            shutil.copytree(tree / "pyhybridcontrol_tpu_torch",
                            copies[name] / "pyhybridcontrol_tpu_torch")
            shutil.copy(tree / "chip_smoke.py", copies[name])
        for i, name in enumerate(("parent", "change", "change", "parent")):
            out = Path(tmp) / f"{i}_{name}.pt"
            res = run_worker(copies[name], out, worker, marker)
            runs.append((name, res, torch.load(out)))
            print(json.dumps({"tree": name, marker.lower(): res}),
                  flush=True)
    print(f"\n{gpu}\n{title}, kernel alone (ms), parent / change / "
          f"change / parent")
    base, differ = runs[0], 0
    whole = ("battery_fleet", "wide_tree", "fleet_b160")
    for tag in base[1]:
        if tag.startswith(whole):
            continue
        r = [res[tag] for _, res, _ in runs]
        for key in ("k4_ms", "k5_20_ms", "k5_relax_ms", "k6_ms"):
            if key in r[0]:
                print(f"  {tag}: {key} " + " / ".join(
                    f"{x[key]:.4f}" for x in r))
        for key in sorted(set(r[1]) - set(r[0])):
            if "_ms" in key:
                print(f"  {tag}: {key} (change only) " + " / ".join(
                    f"{x[key]:.4f}" for x in r if key in x))
        same_in = all(x["inputs"] == r[0]["inputs"] for x in r)
        print(f"  {tag}: inputs {'the same' if same_in else 'DIFFER'}; plan "
              f"{r[1].get('plan', '')} (parent {r[0].get('plan', '')})")
        differ += not same_in
    for key, val in base[2].items():
        for name, _, outs in runs[1:]:
            verdict = bitwise(val, outs[key])
            differ += verdict != "bitwise"
            print(f"  {key}: {name} vs parent: {verdict}")
    for tag in base[1]:
        if tag.startswith(whole):
            print(f"  {tag}: " + " | ".join(
                f"{name} {json.dumps(res[tag])}" for name, res, _ in runs))
    print("every output bitwise the parent's" if not differ
          else f"{differ} outputs or inputs differ")
    return 1 if differ else 0


def run_stagewise(tree: Path) -> dict:
    """Phase 21 of ``tree``'s chip_smoke.py in a copy of it: its times."""
    with tempfile.TemporaryDirectory(prefix="phc_ab_") as tmp:
        shutil.copytree(tree / "pyhybridcontrol_tpu_torch",
                        Path(tmp) / "pyhybridcontrol_tpu_torch")
        shutil.copy(tree / "chip_smoke.py", tmp)
        got = subprocess.run([sys.executable, "-c", STAGEWISE_WORKER],
                             cwd=tmp, capture_output=True, text=True)
    for line in got.stdout.splitlines():
        if line.startswith("SW "):
            return json.loads(line[3:])
    raise RuntimeError(f"{tree}: stagewise worker failed:\n"
                       f"{got.stdout[-2000:]}\n{got.stderr[-3000:]}")


def run_tree(tree: Path, subs, e2e=False) -> dict:
    with tempfile.TemporaryDirectory(prefix="phc_ab_") as tmp:
        shutil.copytree(tree / "pyhybridcontrol_tpu_torch",
                        Path(tmp) / "pyhybridcontrol_tpu_torch")
        shutil.copy(tree / "chip_smoke.py", tmp)
        if e2e:                  # the loops replay committed goldens
            shutil.copytree(tree / "tests" / "golden",
                            Path(tmp) / "tests" / "golden")
        if subs:
            kernel, subs = subs
            src = Path(tmp) / CSRC / kernel
            text = src.read_text()
            hits = [(a, b) for a, b in subs if text.count(a) == 1]
            if not hits:
                raise RuntimeError(f"{tree}: none of the ablation's texts "
                                   f"found in the kernel source")
            for a, b in hits:          # each variant's copy of the loop
                text = text.replace(a, b)
            src.write_text(text)
        got = subprocess.run([sys.executable, "-c",
                              f"E2E = {e2e}\n" + WORKER], cwd=tmp,
                             capture_output=True, text=True)
    res = {}
    for line in got.stdout.splitlines():
        if line.startswith("E2E "):
            res["e2e"] = json.loads(line[4:])
        if line.startswith("AB "):
            res.update(json.loads(line[3:]))
            return res
    raise RuntimeError(f"{tree}: worker failed:\n{got.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--stagewise", action="store_true")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--flex", action="store_true")
    ap.add_argument("--k6", action="store_true")
    args = ap.parse_args()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(gpu, flush=True)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    if args.wide:
        return main_wide(trees, gpu)
    if args.flex:
        return main_wide(trees, gpu, FLEX_WORKER, "FLEX",
                         "K5 at the long horizons")
    if args.k6:
        return main_wide(trees, gpu, f"E2E = {args.e2e}\n" + K6_WORKER,
                         "K6", "K6, the sweep at any b")
    if args.stagewise:
        runs = []
        for name in ("parent", "change", "change", "parent"):
            res = run_stagewise(trees[name])
            runs.append((name, res))
            print(json.dumps({"tree": name, "stagewise": res}), flush=True)
        print(f"\n{gpu}\nstagewise paths, host clock")
        for key in runs[0][1]:
            print(f"  {key}: " + "; ".join(f"{name} {res[key]}"
                                           for name, res in runs))
        return 0
    runs = []
    for name in ("parent", "change", "change", "parent"):
        res = run_tree(trees[name], None, args.e2e)
        runs.append((name, "full", res))
        print(json.dumps({"tree": name, "variant": "full", "ms": res}),
              flush=True)
    if args.ablate:
        for name in ("parent", "change"):
            for variant, subs in ABLATIONS.items():
                res = run_tree(trees[name], subs)
                runs.append((name, variant, res))
                print(json.dumps({"tree": name, "variant": variant,
                                  "ms": res}), flush=True)
    print(f"\n{gpu}\nkernel alone, ms (per iteration µs | fixed ms, from the "
          f"run with twice the iterations)")
    if args.e2e:
        print("\nend to end (host clock)")
        for key in runs[0][2]["e2e"]:
            print(f"  {key}: " + "; ".join(
                f"{name} {res['e2e'][key]}" for name, _, res in runs[:4]))
    shapes = [k[:-3] for k in runs[0][2] if k.endswith(" x1")]
    for shape in shapes:
        print(shape)
        for name, variant, res in runs:
            (t1, n1, *tail), (t2, n2, *_) = (res[shape + " x1"],
                                             res[shape + " x2"])
            per = (t2 - t1) / (n2 - n1)
            print(f"  {name:7s} {variant:16s} {t1:9.4f}  ({1e3 * per:8.3f} "
                  f"| {t1 - per * n1:7.4f})"
                  + (f"  tail {tail[0]:.4f}" if tail else ""))
    return 0


if __name__ == "__main__":
    sys.exit(main())
