"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
``csrc/admm.cu`` into a shared library with a plain C interface under
``build/kernels/`` of the checkout (named by a hash of the sources, so an
edited source rebuilds), under a file lock so that concurrent processes
build once. The library is then loaded with ``ctypes``. There is no
fallback: without ``nvcc`` the loader raises.

``nvcc`` is looked up in $CUDA_HOME/bin, $CUDA_PATH/bin, on PATH, then in
/usr/local/cuda/bin.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SOURCES = (PKG_DIR / "csrc" / "admm.cu",)
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
DEFAULT_CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
BUILD_INFO: dict = {}     # seconds, path and compiler log of the last build


def find_nvcc(environ=None):
    env = os.environ if environ is None else environ
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if env.get(var):
            cand = Path(env[var]) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc", path=env.get("PATH"))
    if found:
        return found
    for home in DEFAULT_CUDA_HOMES:
        cand = Path(home) / "bin" / "nvcc"
        if cand.is_file():
            return str(cand)
    return None


def _digest() -> str:
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_library() -> Path:
    """Compile the kernels (once per source hash) and return the path."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "pyhybridcontrol_tpu_torch: nvcc not found. The CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit: "
            "set CUDA_HOME or put nvcc on PATH.")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libphc_admm_{_digest()}.so"
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            out = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
                capture_output=True, text=True)
            if out.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({out.returncode}):\n{out.stderr[-4000:]}")
            os.replace(tmp, lib)
            BUILD_INFO.update(seconds=time.perf_counter() - t0,
                              log=out.stderr)
        BUILD_INFO["path"] = str(lib)
    return lib


def load_library():
    """The loaded kernel library (built at first call)."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(str(build_library()))
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.phc_admm_smem_bytes.argtypes = [I, I, I, I]
    lib.phc_admm_smem_bytes.restype = I
    lib.phc_error_string.argtypes = [I]
    lib.phc_error_string.restype = ctypes.c_char_p
    # q lG uG lB uB z0G y0G z0B y0B AG MT P vec | x zG yG zB yB st
    lib.phc_admm_k1.argtypes = [P] * 19 + [I, I, I, I, Fl, Fl, P]
    lib.phc_admm_k1.restype = I
    # … vec binm MT2 vec2 | 12 outputs
    lib.phc_admm_k2.argtypes = ([P] * 28 + [I, I, I, I, I, I, Fl, Fl, Fl, P])
    lib.phc_admm_k2.restype = I
    _LIB = lib
    return lib
