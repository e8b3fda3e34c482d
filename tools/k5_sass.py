"""K5's and K4's machine code of two checkouts, compared function by
function (a development tool, not part of the package; needs the CUDA
toolkit, so it runs on the card's machine):

    python tools/k5_sass.py --parent DIR [--show N]

Run from the root of a checkout ("change"); DIR is a checkout of the commit
to compare with (for example ``git archive`` of it unpacked into a
directory that .gitignore lists). Compiles each tree's
``pyhybridcontrol_tpu_torch/csrc/stagewise.cu`` alone (the library that
holds K4 and K5's register path: the shared, grouped and global-state
instantiations at bmax 8 and 16), its ``stagewise_extra.cu`` (K5's
runtime-r path at bmax 8 and 16), its ``stagewise_wide.cu`` (K5 at bmax
32 to 128), its ``stagewise_horizon.cu`` (K5's horizon variant) and,
where the tree has them, the parallel sweep's ``stagewise_par.cu``,
``stagewise_extra_par.cu`` and ``stagewise_wide_par.cu`` to cubins with
the flags of ``ops/_build.py``, every build side by side, disassembles
them with ``cuobjdump -sass`` and compares the instructions of every ``sw_admm_kernel``, ``sw_admm_horizon_kernel`` and
``sw_solve_k_kernel`` instantiation of the parent with the change's of
the same source and template arguments (K5: BMAX, B0, STAGED, FLEX, RDYN
and PAR, the last read as 0 where a parent's kernel has no such
argument; the horizon variant and K4: BMAX, B0, STAGED). Kernels the
parent has not (the parallel sweep's inside the other variants, built
from sources of their own) are not compared.
Kernel-parameter offsets (``c[0x0][…]``) and symbol names are masked, so a
parameter struct that grew at its end does not count. Prints, per
instantiation, "same" or the two instruction counts and the number of
differing lines (``--show N``: and the first N of them, parent | change);
exits 1 if any differs.
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
CSRC = Path("pyhybridcontrol_tpu_torch") / "csrc"
SOURCES = ("stagewise.cu", "stagewise_extra.cu", "stagewise_wide.cu",
           "stagewise_horizon.cu", "stagewise_par.cu",
           "stagewise_extra_par.cu", "stagewise_wide_par.cu")
# kernel name -> its template arguments in the mangled name
KERNELS = (("sw_admm_kernel",
             r"ILi(\d+)ELi(\d+)ELb(\d)ELb(\d)(?:ELb(\d))?(?:ELb(\d))?E"),
           ("sw_admm_horizon_kernel", r"ILi(\d+)ELi(\d+)ELb(\d)E"),
           ("sw_solve_k_kernel", r"ILi(\d+)ELi(\d+)ELb(\d)E"))


def sass(tree: Path, work: Path, pool) -> dict:
    """{(source, kernel, template arguments…): [instruction, …]} of the
    tree's K4 and K5 instantiations, its sources compiled on ``pool``."""
    from pyhybridcontrol_tpu_torch.ops import _build

    nvcc = _build.find_nvcc()
    if nvcc is None:
        raise SystemExit("k5_sass: nvcc not found")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-fPIC")
             and f != "-Xcompiler"]
    work.mkdir(parents=True)
    names = [n for n in SOURCES if (tree / CSRC / n).exists()]
    for name in names:            # the other parts include stagewise.cu
        shutil.copy(tree / CSRC / name, work / name)
    funcs = {}

    def disassemble(name):
        cubin = work / (name + ".cubin")
        subprocess.run([nvcc, *flags, "-cubin", "-o", str(cubin),
                        str(work / name)], check=True, capture_output=True)
        return subprocess.run([str(Path(nvcc).parent / "cuobjdump"),
                               "-sass", str(cubin)], check=True,
                              capture_output=True, text=True).stdout

    for name, out in zip(names, pool.map(disassemble, names)):
        cur = None
        for line in out.splitlines():
            m = re.search(r"Function : (\S+)", line)
            if m:
                cur = None
                for kernel, args in KERNELS:
                    k = re.search(kernel + args, m.group(1))
                    if k:
                        key = (name, kernel) + tuple(
                            int(v or 0) for v in k.groups())
                        cur = funcs.setdefault(key, [])
                continue
            m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
            if cur is not None and m:
                ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][X]",
                             m.group(1))
                cur.append(re.sub(r"_ZN\w*", "SYM", ins.strip()))
    return funcs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--show", type=int, default=0)
    a = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp, \
            ThreadPoolExecutor(2) as trees, \
            ThreadPoolExecutor(2 * len(SOURCES)) as pool:   # every build
        fp = trees.submit(sass, Path(a.parent).resolve(),
                          Path(tmp) / "parent", pool)
        fc = trees.submit(sass, ROOT, Path(tmp) / "change", pool)
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
        print(f"{key[0]} {key[1]}<" + ", ".join(map(str, key[2:])) + ">: "
              + verdict, flush=True)
        if c is not None and p != c:
            for x, y in [(x, y) for x, y in zip(p, c) if x != y][:a.show]:
                print(f"    {x} | {y}", flush=True)
    print(f"{len(par)} instantiations compared, {differ} differ", flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
