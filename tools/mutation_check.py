"""Mutation check of the limits that hold the kernels against their plain
versions, on the card (a development tool, not part of the package):

    python tools/mutation_check.py          # the split-precision kernel
    python tools/mutation_check.py admm     # K1 and K2
    python tools/mutation_check.py streamed # K1/K2 streamed, K1 split mode
    python tools/mutation_check.py stagewise   # K4, the stagewise sweep

Run from the root of a checkout. For each mutation it copies the package
and ``chip_smoke.py`` into a fresh temporary directory, breaks one line of
the kernel source there (``csrc/admm_mixed.cu``, ``csrc/admm.cu`` or
``csrc/stagewise.cu``), builds the broken kernel and runs the phases of
``chip_smoke`` that hold that kernel (``phase_k1_mixed``; ``phase_k1``,
``phase_k2`` and ``phase_far``; ``phase_streamed`` and ``phase_split``;
or ``phase_k4``). A mutation
is caught when a field goes off its limit; the line printed for it names
the first such field and the largest reading of every field. The unbroken copy ("none") must pass. The checkout itself is
never touched; a mutation whose line is no longer in the source exactly
once stops the run.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = "pyhybridcontrol_tpu_torch/csrc/"
# name -> (text to replace, replacement); each text occurs once
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
    "split mode: one split iteration short": (
        "phase<PB, true>(s, nr, mGp, a.iters_lo, a.alpha, false);",
        "phase<PB, true>(s, nr, mGp, a.iters_lo - 1, a.alpha, false);"),
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
        "if (i < b) acc[t] = fmaf(Lk[i * b + j], yj, acc[t]);",
        "if (i < b && j > 0) acc[t] = fmaf(Lk[i * b + j], yj, acc[t]);"),
    "backward sweep: last column of C dropped": (
        "if (i < b) c[t] = fmaf(Ck[i * b + j], xj, c[t]);",
        "if (i < b && j + 1 < b) c[t] = fmaf(Ck[i * b + j], xj, c[t]);"),
    "y_k not kept for the backward sweep": ("yk[i] = prev[t];", ""),
    "forward sweep reads the next stage's L": (
        "const float* Lk = L + (size_t)k * bb;",
        "const float* Lk = L + (size_t)((k + 1) % N) * bb;"),
    "backward sweep stops before stage 0": (
        "for (int k = N - 1; k >= 0; --k) {",
        "for (int k = N - 1; k >= 1; --k) {"),
}
# every field is read (chip_smoke's --readings mode); the first one off its
# limit is printed
RUN = r"""
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
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
        cs.phase_k4(dev, cs.phase_rng("k4"), recs["stagewise_k4"])
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
         "stagewise": ("stagewise.cu", MUTATIONS_STAGEWISE,
                       ("sweep", "main"))}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mode = argv[0] if argv else "mixed"
    if mode not in MODES or len(argv) > 1:
        print("usage: mutation_check.py [mixed|admm|streamed|stagewise]",
              file=sys.stderr)
        return 2
    kernel, mutations, regimes = MODES[mode]
    run = f"MODE = {mode!r}\nREGIMES = {regimes!r}\n" + RUN
    failed = False
    for name, sub in mutations.items():
        with tempfile.TemporaryDirectory(prefix="phc_mutation_") as tmp:
            shutil.copytree(ROOT / "pyhybridcontrol_tpu_torch",
                            Path(tmp) / "pyhybridcontrol_tpu_torch")
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            if sub is not None:
                src = Path(tmp) / CSRC / kernel
                text = src.read_text()
                if text.count(sub[0]) != 1:
                    raise RuntimeError(f"{name}: the kernel source no longer "
                                       f"has exactly one {sub[0]!r}")
                src.write_text(text.replace(sub[0], sub[1]))
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
