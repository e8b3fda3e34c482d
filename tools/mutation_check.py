"""Mutation check of the limits that hold the kernels against their plain
versions, on the card (a development tool, not part of the package):

    python tools/mutation_check.py          # the split-precision kernel
    python tools/mutation_check.py admm     # K1 and K2
    python tools/mutation_check.py streamed # K1/K2 resident and streamed, split mode
    python tools/mutation_check.py stagewise   # K4 (the sweep) and K5

Run from the root of a checkout. For each mutation it copies the package
and ``chip_smoke.py`` into a fresh temporary directory, breaks one line of
the kernel source there (``csrc/admm_mixed.cu``, ``csrc/admm.cu`` or
``csrc/stagewise.cu``), builds the broken kernel and runs the phases of
``chip_smoke`` that hold that kernel (``phase_k1_mixed``; ``phase_k1``,
``phase_k2`` and ``phase_far``; ``phase_streamed`` and ``phase_split``;
or ``phase_k4`` for the sweep's lines and ``phase_k5`` for K5's, both for
the unbroken copy, without their timings; there the copies build
``stagewise.cu`` alone, all side by side before the holds). A mutation
is caught when a field goes off its limit; the line printed for it names
the first such field and the largest reading of every field. The unbroken copy ("none") must pass. The checkout itself is
never touched; a mutation whose line is no longer in the source exactly
once stops the run.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = "pyhybridcontrol_tpu_torch/csrc/"
# name -> (text to replace, replacement), or a list of them; a text occurs
# once, or twice where the resident variant of admm.cu has its own copy of
# the line (every copy is broken)
MUTATIONS_ADMM = {
    "none": None,
    "alpha − 0.1": (
        "const float zr = alpha * u[i] + (1.f - alpha) * z[i];",
        "const float zr = (alpha - 0.1f) * u[i] + (1.1f - alpha) * z[i];"),
    "one iteration short": (
        "for (int k = 0; k <= iters; ++k) {",
        "for (int k = 1; k <= iters; ++k) {"),
    "stiff probe dropped": ("if (a.p1 > 0) {", "if (false) {"),
    "r_dual written as r_prim": ("out[3] = r_dual;", "out[3] = r_prim;"),
}
MUTATIONS_STREAMED = {
    "none": None,
    "streamed stiff phase reads Mᵀ, not M2ᵀ": (
        "s2.MT = const_cast<float*>(a.MT2);", "s2.MT = s.MT;"),
    "split mode: lo·hi pass dropped": ("c = fmaf(al[r], vh, c);", ""),
    "split mode: hi·lo pass dropped": ("c = fmaf(ah[r], vl, c);", ""),
    "split mode: one split iteration short": [
        ("phase<PB, true>(s, nr, mGp, a.iters_lo, a.alpha, false);",
         "phase<PB, true>(s, nr, mGp, a.iters_lo - 1, a.alpha, false);"),
        ("cl_phase<PB, true>(s, pt, nr, mGp, a.iters_lo, a.alpha, false, "
         "xpar);", "cl_phase<PB, true>(s, pt, nr, mGp, a.iters_lo - 1, "
         "a.alpha, false, xpar);")],
    "resident stiff phase keeps Mᵀ": (
        "bulk_copy(s.MT, a.MT2 + offM, nMT, s.bar);",
        "bulk_copy(s.MT, a.MT + offM, nMT, s.bar);"),
    # the same bytes reach the other CTAs (a dropped send would hang the
    # wait for them), taken from the next row of t
    "resident: t sent from the wrong rows": (
        "st_async<V>(mapa(t + o, r), t + o, mapa(bar, r));",
        "st_async<V>(mapa(t + o, r), t + (o + PB) % (nr * PB), "
        "mapa(bar, r));"),
    "resident: the last CTA's stats record dropped": (
        "record_sum(slots + (size_t)tid * PHC_RED, nc, PB * PHC_RED,",
        "record_sum(slots + (size_t)tid * PHC_RED, nc - 1, PB * PHC_RED,"),
}
MUTATIONS_MIXED = {
    "none": None,
    "Alo·bhi pass dropped": (
        "      mma_bf16(acc[2 * np], al, b[0], b[1]);\n"
        "      mma_bf16(acc[2 * np + 1], al, b[2], b[3]);\n", ""),
    "Ahi·blo pass dropped": (
        "      ldsm_x4_t(b, b_lo + bo);\n"
        "      mma_bf16(acc[2 * np], ah, b[0], b[1]);\n"
        "      mma_bf16(acc[2 * np + 1], ah, b[2], b[3]);\n", ""),
    "iterate rounded to bf16 once, not split": (
        "__floats2bfloat162_rn(a - hf.x, b - hf.y);",
        "__floats2bfloat162_rn(0.f, 0.f);"),
    "alpha − 0.1": (
        "const float zr = alpha * acc[nt][c] + (1.f - alpha) * z[nt][c];",
        "const float zr = (alpha - 0.1f) * acc[nt][c]"
        " + (1.1f - alpha) * z[nt][c];"),
    "one iteration short": (
        "for (int k = 0; k < iters; ++k) {",
        "for (int k = 0; k < iters - 1; ++k) {"),
    "y not updated in the box block": (
        "y[nt][c] = y[nt][c] + rho * (zr - zn);",
        "y[nt][c] = p.box ? y[nt][c] : y[nt][c] + rho * (zr - zn);"),
}
MUTATIONS_STAGEWISE = {
    "none": None,
    "forward sweep: column 0 of L dropped": (
        "for (int j = 0; j < NB; ++j) Ln[j] = (row && j < b) ? Lk[j] : 0.0f;",
        "for (int j = 0; j < NB; ++j) Ln[j] = (row && j < b && j > 0) ? "
        "Lk[j] : 0.0f;"),
    "backward sweep: last column of C dropped": (
        "Cn[j] = (row && j < b) ? C[o + j] : 0.0f;",
        "Cn[j] = (row && j + 1 < b) ? C[o + j] : 0.0f;"),
    "y_k not kept for the backward sweep": (
        "ys[k * b + lane] = prev;", ""),
    "forward sweep reads the stage after the next's L": (
        "const float* Lk = L + (size_t)(k + 1) * bb + lo;",
        "const float* Lk = L + (size_t)((k + 2) % N) * bb + lo;"),
    "backward sweep stops before stage 0": (
        "for (int k = N - 1; k >= 0; --k) {",
        "for (int k = N - 1; k >= 1; --k) {"),
}
# K5's own lines (the sweep above is K5's too); phase 22 must catch each
MUTATIONS_K5 = {
    "none": None,
    "group mean dropped (each scenario keeps its own)": (
        "zn = fmaf(gM[t * N + k], cbt[k * nc + jc], zn);",
        "zn = t == s ? cbt[k * nc + jc] : zn;"),
    "Woodbury term dropped": ("corr[lane] = cv;", "corr[lane] = 0.0f;"),
    "M part of t dropped": (
        "if (k >= 1) mb[(k - 1) * b + c] = mm[c];",
        "if (k >= 1) mb[(k - 1) * b + c] = 0.0f;"),
    "soft rows boxed, not proxed": (
        "const float zn = (lin > 0.0f || quad > 0.0f) ? zsoft : zbox;",
        "const float zn = zbox;"),
    "extra rows' y_e not updated": ("        ye[j] = yn;\n", ""),
    "one iteration short": (
        "for (int it = 0; it < a.iters; ++it) {",
        "for (int it = 1; it < a.iters; ++it) {"),
    "the M part of t summed over one lane of a stage": (
        "group_sum<BMAX>(mm, tps);\n      if (on && jl == 0) {",
        "if (on && jl == 0) {"),
    "dy of the second-to-last iteration": (
        "if (last && !cons) a.dy[(p * N + k) * m + i] = yn - y;",
        "if (it == a.iters - 2 && !cons) a.dy[(p * N + k) * m + i] = "
        "yn - y;"),
}
# every field is read (chip_smoke's --readings mode); the first one off its
# limit is printed
RUN = r"""
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
from pyhybridcontrol_tpu_torch.ops import _build
if MODE == "stagewise":
    _build.LIBRARIES = {"stagewise": _build.LIBRARIES["stagewise"]}
    cs.TIMINGS = False
cs.READINGS_ONLY = True
dev = torch.device("cuda")
try:
    recs = {k: {} for k in cs.REPLACES}
    if MODE == "admm":
        cs.phase_k1(dev, cs.phase_rng("k1"), recs["admm_k1"])
        cs.phase_k2(dev, cs.phase_rng("k2"), recs["admm_k2"])
        cs.phase_far(dev, cs.phase_rng("far"), recs)
    elif MODE == "streamed":
        cs.phase_streamed(dev, cs.phase_rng("streamed"), recs)
        cs.phase_split(dev, cs.phase_rng("split"), recs["admm_k1_split"])
    elif MODE == "stagewise":
        if "k4" in PHASES:
            cs.phase_k4(dev, cs.phase_rng("k4"), recs["stagewise_k4"])
        if "k5" in PHASES:
            cs.phase_k5(dev, cs.phase_rng("k5"), recs["stagewise_k5"])
    else:
        cs.phase_k1_mixed(dev, cs.phase_rng("k1_mixed"), {})
    if cs.OVER:
        raise AssertionError(f"{len(cs.OVER)} readings over; first: "
                             + cs.OVER[0])
    print("RESULT passed", flush=True)
except AssertionError as e:
    print("RESULT caught:", e, flush=True)
print("READINGS", " ".join(
    f"{r}.{k}={v:.2e}" for r in REGIMES
    for k, v in cs.READINGS.get(r, {}).items()), flush=True)
"""
# mode -> (kernel source, mutations, regimes whose readings are printed)
MODES = {"mixed": ("admm_mixed.cu", MUTATIONS_MIXED,
                   ("mixed_iterates", "mixed")),
         "admm": ("admm.cu", MUTATIONS_ADMM, ("main", "far")),
         "streamed": ("admm.cu", MUTATIONS_STREAMED,
                      ("main", "large", "mixed_iterates", "mixed")),
         "stagewise": ("stagewise.cu",
                       {**MUTATIONS_STAGEWISE,
                        **{f"K5: {k}": v for k, v in MUTATIONS_K5.items()
                           if v is not None}},
                       ("sweep", "main", "k5", "k5_wide", "k5_soft",
                        "k5_infeasible"))}
# the stagewise copies build their one library side by side first
BUILD = r"""
import sys
sys.path.insert(0, ".")
from pyhybridcontrol_tpu_torch.ops import _build
_build.LIBRARIES = {"stagewise": _build.LIBRARIES["stagewise"]}
_build.build_libraries()
"""


def phases_of(mode, name):
    """The phases that hold a mutation of ``mode`` (stagewise: K5's lines
    phase 22, the sweep's phase 20, the unbroken copy both)."""
    if mode != "stagewise":
        return ()
    if name == "none":
        return ("k4", "k5")
    return ("k5",) if name.startswith("K5: ") else ("k4",)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "mixed"
    if mode not in MODES or len(argv) > 1:
        print("usage: mutation_check.py [mixed|admm|streamed|stagewise]",
              file=sys.stderr)
        return 2
    kernel, mutations, regimes = MODES[mode]
    failed = False
    with tempfile.TemporaryDirectory(prefix="phc_mutation_") as root:
        dirs = []
        for i, (name, sub) in enumerate(mutations.items()):
            tmp = Path(root) / str(i)
            shutil.copytree(ROOT / "pyhybridcontrol_tpu_torch",
                            tmp / "pyhybridcontrol_tpu_torch")
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            if sub is not None:
                src = tmp / CSRC / kernel
                text = src.read_text()
                for old, new in (sub if isinstance(sub, list) else [sub]):
                    if text.count(old) not in (1, 2):
                        raise RuntimeError(f"{name}: the kernel source has "
                                           f"{text.count(old)} of {old!r}")
                    text = text.replace(old, new)
                src.write_text(text)
            dirs.append(tmp)
        if mode == "stagewise":
            builds = []
            for tmp in dirs:
                while len([b for b in builds if b.poll() is None]) >= (
                        os.cpu_count() or 1):
                    time.sleep(1)
                builds.append(subprocess.Popen(
                    [sys.executable, "-c", BUILD], cwd=tmp,
                    stdout=subprocess.DEVNULL, stderr=subprocess.PIPE))
            for b in builds:
                b.wait()
        for tmp, (name, sub) in zip(dirs, mutations.items()):
            run = (f"MODE = {mode!r}\nREGIMES = {regimes!r}\n"
                   f"PHASES = {phases_of(mode, name)!r}\n" + RUN)
            out = subprocess.run([sys.executable, "-c", run], cwd=tmp,
                                 capture_output=True, text=True)
            lines = [ln for ln in out.stdout.splitlines()
                     if ln.startswith(("RESULT", "READINGS"))]
            print(f"{name}: " + (" | ".join(lines) or out.stderr[-2000:]),
                  flush=True)
            caught = any(ln.startswith("RESULT caught") for ln in lines)
            passed = any(ln.startswith("RESULT passed") for ln in lines)
            failed |= not (passed if sub is None else caught)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
