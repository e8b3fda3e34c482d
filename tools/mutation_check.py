"""Mutation check of the limits that hold the split-precision kernel
against its plain version, on the card (a development tool, not part of
the package):

    python tools/mutation_check.py

Run from the root of a checkout. For each mutation it copies the package
and ``chip_smoke.py`` into a fresh temporary directory, breaks one line of
``csrc/admm_mixed.cu`` there, builds the broken kernel and runs
``chip_smoke.phase_k1_mixed`` on it. A mutation is caught when that phase
raises; the line printed for it names the field that went off its limit
and the largest reading of every field. The unbroken copy ("none") must
pass. The checkout itself is never touched; a mutation whose line is no
longer in the source exactly once stops the run.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
KERNEL = "pyhybridcontrol_tpu_torch/csrc/admm_mixed.cu"
# name -> (text to replace, replacement); each text occurs once
MUTATIONS = {
    "none": None,
    "Alo·bhi pass dropped": (
        "    wmma::mma_sync(acc, al, bh, acc);\n", ""),
    "Ahi·blo pass dropped": (
        "    wmma::mma_sync(acc, ah, bl, acc);\n", ""),
    "iterate rounded to bf16 once, not split": (
        "*lo = __float2bfloat16_rn(v - __bfloat162float(h));",
        "*lo = __float2bfloat16_rn(0.f);"),
    "alpha − 0.1": (
        "const float zr = alpha * st[e] + (1.f - alpha) * z;",
        "const float zr = (alpha - 0.1f) * st[e] + (1.1f - alpha) * z;"),
    "one iteration short": (
        "for (int k = 0; k < iters; ++k) {",
        "for (int k = 0; k < iters - 1; ++k) {"),
    "y not updated in the box block": (
        "yv[at] = y + rho * (zr - zn);",
        "yv[at] = g ? y + rho * (zr - zn) : y;"),
}
RUN = r"""
import sys
import torch
sys.path.insert(0, ".")
import chip_smoke as cs
rec = {}
try:
    cs.phase_k1_mixed(torch.device("cuda"), cs.phase_rng("k1_mixed"), rec)
    print("RESULT passed", flush=True)
except AssertionError as e:
    print("RESULT caught:", e, flush=True)
print("READINGS", " ".join(f"{k}={v:.2e}" for k, v in
                           {**cs.READINGS.get("mixed_iterates", {}),
                            **cs.READINGS.get("mixed", {})}.items()),
      flush=True)
"""


def main() -> int:
    failed = False
    for name, sub in MUTATIONS.items():
        with tempfile.TemporaryDirectory(prefix="phc_mutation_") as tmp:
            shutil.copytree(ROOT / "pyhybridcontrol_tpu_torch",
                            Path(tmp) / "pyhybridcontrol_tpu_torch")
            shutil.copy(ROOT / "chip_smoke.py", tmp)
            if sub is not None:
                src = Path(tmp) / KERNEL
                text = src.read_text()
                if text.count(sub[0]) != 1:
                    raise RuntimeError(f"{name}: the kernel source no longer "
                                       f"has exactly one {sub[0]!r}")
                src.write_text(text.replace(sub[0], sub[1]))
            out = subprocess.run([sys.executable, "-c", RUN], cwd=tmp,
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
