"""Kernel-alone times of K1, K2 and the split-precision kernel of two
checkouts on one card, in one run (a development tool, not part of the
package):

    python tools/kernel_ab.py --parent DIR [--ablate]

Run from the root of a checkout ("change"); DIR is a checkout of the commit
to compare with ("parent", for example ``git archive`` of it unpacked into
a directory that .gitignore lists). Each tree is copied into a fresh
temporary directory, builds its own kernels there and is timed by the same
worker, in the order parent, change, change, parent. Times are CUDA events
recorded just before and after each call into a kernel library (so the
wrapper's packing, checks and allocations are outside), median of 7 after a
warm-up, at the shapes of PERF.md's kernel table (N=27: the streamed
variant, a tile of 1); each shape is also run
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
# product, by the text each tree's source has it in (exactly one of the
# texts must occur, once)
ABLATIONS = {
    "no loop A": ("admm.cu", [
        ("for (int i = sl; i < mGp; i += S) acc = fmaf(s.AG[i * nr + j], "
         "s.wG[i], acc);", ""),
        ("s.AG, s.AS, s.w, mGp, nr, [&](int j, int p, const auto& v) {",
         "s.AG, s.AS, s.w, 0, nr, [&](int j, int p, const auto& v) {")]),
    "no loop B": ("admm.cu", [
        ("for (int c = 0; c < nr; ++c) u = fmaf(MT[c * R + r], s.t[c], u);",
         ""),
        ("s.MT, s.RS, s.t, nr, R, [&](int r, int p, const auto& u) {",
         "s.MT, s.RS, s.t, 0, R, [&](int r, int p, const auto& u) {")]),
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
print("AB " + json.dumps(out), flush=True)
"""


def run_tree(tree: Path, subs) -> dict:
    with tempfile.TemporaryDirectory(prefix="phc_ab_") as tmp:
        shutil.copytree(tree / "pyhybridcontrol_tpu_torch",
                        Path(tmp) / "pyhybridcontrol_tpu_torch")
        shutil.copy(tree / "chip_smoke.py", tmp)
        if subs:
            kernel, subs = subs
            src = Path(tmp) / CSRC / kernel
            text = src.read_text()
            hits = [(a, b) for a, b in subs if text.count(a) == 1]
            if len(hits) != 1:
                raise RuntimeError(f"{tree}: {len(hits)} of the ablation's "
                                   f"texts found in the kernel source")
            src.write_text(text.replace(*hits[0]))
        got = subprocess.run([sys.executable, "-c", WORKER], cwd=tmp,
                             capture_output=True, text=True)
    for line in got.stdout.splitlines():
        if line.startswith("AB "):
            return json.loads(line[3:])
    raise RuntimeError(f"{tree}: worker failed:\n{got.stderr[-3000:]}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--ablate", action="store_true")
    args = ap.parse_args()
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(gpu, flush=True)
    trees = {"parent": args.parent.resolve(), "change": ROOT}
    runs = []
    for name in ("parent", "change", "change", "parent"):
        res = run_tree(trees[name], None)
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
