"""K5's register-path machine code of two checkouts, compared function by
function (a development tool, not part of the package; needs the CUDA
toolkit, so it runs on the card's machine):

    python tools/k5_sass.py --parent DIR

Run from the root of a checkout ("change"); DIR is a checkout of the commit
to compare with (for example ``git archive`` of it unpacked into a
directory that .gitignore lists). Compiles each tree's
``pyhybridcontrol_tpu_torch/csrc/stagewise.cu`` alone (the library that
holds K4 and K5's register path) to a cubin with the flags of
``ops/_build.py``, disassembles it with ``cuobjdump -sass`` and compares the
instructions of every ``sw_admm_kernel`` instantiation of the parent with
the change's of the same template arguments (BMAX, B0, STAGED, FLEX; the
change's runtime-r flag false). Kernel-parameter offsets (``c[0x0][…]``)
and symbol names are masked, so a parameter struct that grew at its end
does not count. Prints, per instantiation, "same" or the two instruction
counts and the number of differing lines; exits 1 if any differs.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
SOURCE = Path("pyhybridcontrol_tpu_torch") / "csrc" / "stagewise.cu"


def sass(tree: Path, work: Path) -> dict:
    """{(BMAX, B0, STAGED, FLEX): [instruction, …]} of the tree's K5
    register-path instantiations."""
    from pyhybridcontrol_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("k5_sass: nvcc not found")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-fPIC")
             and f != "-Xcompiler"]
    work.mkdir(parents=True)
    src = work / "stagewise.cu"
    shutil.copy(tree / SOURCE, src)
    cubin = work / "k.cubin"
    subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin), str(src)],
                   check=True, capture_output=True)
    out = subprocess.run([str(Path(nvcc).parent / "cuobjdump"), "-sass",
                          str(cubin)], check=True, capture_output=True,
                         text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"sw_admm_kernelILi(\d+)ELi(\d+)ELb(\d)ELb(\d)"
                          r"(?:ELb(\d))?E", m.group(1))
            cur = None
            if k and (k.group(5) or "0") == "0":
                cur = funcs.setdefault(tuple(map(int, k.groups()[:4])), [])
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if cur is not None and m:
            ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][X]", m.group(1))
            cur.append(re.sub(r"_ZN\w*", "SYM", ins.strip()))
    return funcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    a = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(2) as pool:       # the two builds side by side
        fp = pool.submit(sass, Path(a.parent).resolve(), Path(tmp) / "parent")
        fc = pool.submit(sass, ROOT, Path(tmp) / "change")
        par, chg = fp.result(), fc.result()
    differ = 0
    for key in sorted(par):
        p, c = par[key], chg.get(key)
        if p == c:
            verdict = "same"
        else:
            differ += 1
            verdict = ("missing" if c is None else
                       f"{len(p)} vs {len(c)} instructions, "
                       f"{sum(x != y for x, y in zip(p, c))} lines differ")
        print("BMAX %d, B0 %d, STAGED %d, FLEX %d: " % key + verdict,
              flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
