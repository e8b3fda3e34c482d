"""Build and load the CUDA kernels of ``csrc/``.

At first use, ``nvcc -gencode arch=compute_90a,code=sm_90a`` compiles
every source of ``LIBRARIES`` into its own shared library with a plain C
interface under ``build/kernels/`` of the checkout (named by a hash of the
source, so an edited source rebuilds). The compilers run side by side,
one process per source, under a file lock so that concurrent processes
build once. A library is then loaded with ``ctypes``. There is no
fallback: without ``nvcc`` the loader raises.

``nvcc`` is looked up in $CUDA_HOME/bin, $CUDA_PATH/bin, on PATH, then in
/usr/local/cuda/bin.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
# library name -> source; K1/K2 in admm.cu, K1's split-precision phase
# (tensor cores) in admm_mixed.cu, K4 (the stagewise sweep) and K5 (the
# stagewise ADMM loop) in stagewise.cu, K5's other instantiations in the
# three sources that build stagewise.cu's other parts (bmax 32 to 128; the
# runtime-r path at bmax 8 and 16; the horizon variant) and in the three
# that build parts 0 to 2 with the parallel sweep (the "_par" ones), and
# K6 (the sweep at any b and over windows) in stagewise_any.cu, each its
# own library so that the compilers run side by side
LIBRARIES = {"admm": PKG_DIR / "csrc" / "admm.cu",
             "admm_mixed": PKG_DIR / "csrc" / "admm_mixed.cu",
             "stagewise": PKG_DIR / "csrc" / "stagewise.cu",
             "stagewise_wide": PKG_DIR / "csrc" / "stagewise_wide.cu",
             "stagewise_extra": PKG_DIR / "csrc" / "stagewise_extra.cu",
             "stagewise_horizon": PKG_DIR / "csrc" / "stagewise_horizon.cu",
             "stagewise_par": PKG_DIR / "csrc" / "stagewise_par.cu",
             "stagewise_wide_par": PKG_DIR / "csrc" / "stagewise_wide_par.cu",
             "stagewise_extra_par": PKG_DIR / "csrc" / "stagewise_extra_par.cu",
             "stagewise_any": PKG_DIR / "csrc" / "stagewise_any.cu"}
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
DEFAULT_CUDA_HOMES = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict = {}          # name -> loaded ctypes library
BUILD_INFO: dict = {}     # seconds, paths and compiler log of the last build


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


def _digest(src: Path) -> str:
    """Hash of a source, of the sources it includes by a quoted name
    (beside it) and of the flags."""
    h = hashlib.sha256()
    text = src.read_bytes()
    h.update(text)
    for name in re.findall(rb'^#include "([^"]+)"', text, re.M):
        h.update((src.parent / name.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build_libraries() -> dict:
    """Compile every kernel source that has no library yet (once per
    source hash, all compilers started together) and return name -> path."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "pyhybridcontrol_tpu_torch: nvcc not found. The CUDA kernels "
            "are built from csrc/ at first use and need the CUDA toolkit: "
            "set CUDA_HOME or put nvcc on PATH.")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: BUILD_DIR / f"libphc_{name}_{_digest(src)}.so"
             for name, src in LIBRARIES.items()}
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        t0 = time.perf_counter()
        procs = {}
        for name, lib in paths.items():
            if not lib.exists():
                tmp = lib.with_suffix(f".{os.getpid()}.tmp")
                procs[name] = (tmp, subprocess.Popen(
                    [nvcc, *NVCC_FLAGS, "-o", str(tmp),
                     str(LIBRARIES[name])],
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                    text=True))
        logs, failed = [], []
        for name, (tmp, proc) in procs.items():
            _, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"{LIBRARIES[name].name} "
                              f"({proc.returncode}):\n{err[-4000:]}")
            else:
                os.replace(tmp, paths[name])
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        if procs:
            BUILD_INFO.update(seconds=time.perf_counter() - t0,
                              log="".join(logs))
        BUILD_INFO["paths"] = {k: str(v) for k, v in paths.items()}
    return paths


def _bind_admm(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    # nr, mGp, tile width, streamed, cluster
    lib.phc_admm_smem_bytes.argtypes = [I, I, I, I, I]
    lib.phc_admm_smem_bytes.restype = I
    # struct Args (ops/cuda_admm.py mirrors it), tile width, streamed,
    # cluster, threads, stream
    for fn in (lib.phc_admm_k1, lib.phc_admm_k1_1pass, lib.phc_admm_k2):
        fn.argtypes = [P, I, I, I, I, P]
        fn.restype = I
    # wave, split passes (0: none), nr, mGp, tile width, cluster, threads
    lib.phc_admm_max_clusters.argtypes = [I] * 7
    lib.phc_admm_max_clusters.restype = I
    # cluster, clusters, threads, iterations, relaxed, stream
    lib.phc_cluster_sync_bench.argtypes = [I, I, I, I, I, P]
    lib.phc_cluster_sync_bench.restype = I


def _bind_admm_mixed(lib):
    P, I, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.phc_admm_mixed_smem_bytes.argtypes = [I, I, I]   # nr, mG, tile
    lib.phc_admm_mixed_smem_bytes.restype = I
    # q uG lB uB z0G y0G z0B y0B Ahi Alo Mhi Mlo vec | zG yG zB yB, then
    # B nr mG iters alpha tile stream
    for fn in (lib.phc_admm_k1_mixed, lib.phc_admm_k1_mixed_1pass):
        fn.argtypes = [P] * 17 + [I, I, I, I, Fl, I, P]
        fn.restype = I


def _bind_stagewise(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    # N, b, warps, staged, bmax, ring
    lib.phc_sw_smem_bytes.argtypes = [I] * 6
    lib.phc_sw_smem_bytes.restype = I
    # r L Uinv C | x, then P N b warps staged bmax ring stream
    lib.phc_sw_solve_k.argtypes = [P] * 5 + [I] * 7 + [P]
    lib.phc_sw_solve_k.restype = I
    _bind_stagewise_k5(lib)


def _bind_stagewise_k5(lib):
    """K5's exports, which every part of stagewise.cu has."""
    P, I = ctypes.c_void_p, ctypes.c_int
    # N b m S n_blk n_ext n_cons mean warps staged bmax ext ring windows
    lib.phc_sw_admm_smem_bytes.argtypes = [I] * 14
    lib.phc_sw_admm_smem_bytes.restype = I
    # struct PhcSwAdmmArgs (ops/cuda_stagewise.py mirrors it), warps,
    # lanes a stage, staged, bmax, stream
    lib.phc_sw_admm.argtypes = [P, I, I, I, I, P]
    lib.phc_sw_admm.restype = I
    # N b m n_blk n_ext n_cons mean warps staged bmax spc place ext ring
    # lists (the member lists' words staged) S windows
    lib.phc_sw_admm_flex_smem_bytes.argtypes = [I] * 17
    lib.phc_sw_admm_flex_smem_bytes.restype = I
    # N b m n_cons mean place bmax
    lib.phc_sw_admm_flex_scratch_words.argtypes = [I] * 7
    lib.phc_sw_admm_flex_scratch_words.restype = ctypes.c_longlong
    # the struct, warps, lanes a stage, staged, bmax, scenarios a CTA,
    # cluster, place, scratch, the member lists and their words staged,
    # stream
    lib.phc_sw_admm_flex.argtypes = [P] + [I] * 7 + [P, P, I, P]
    lib.phc_sw_admm_flex.restype = I
    # the struct, warps, lanes a stage, staged, bmax, spc, cluster, place,
    # the member lists' words staged
    lib.phc_sw_admm_max_clusters.argtypes = [P] + [I] * 8
    lib.phc_sw_admm_max_clusters.restype = I


def _bind_stagewise_horizon(lib):
    """K5's exports and the horizon variant's (stagewise_horizon.cu)."""
    P, I = ctypes.c_void_p, ctypes.c_int
    _bind_stagewise_k5(lib)
    # N b m staged bmax C
    lib.phc_sw_admm_horizon_smem_bytes.argtypes = [I] * 6
    lib.phc_sw_admm_horizon_smem_bytes.restype = I
    # the struct, Pi, Psi, warps, lanes a stage, staged, bmax, C,
    # parallel, stream
    lib.phc_sw_admm_horizon.argtypes = [P, P, P] + [I] * 6 + [P]
    lib.phc_sw_admm_horizon.restype = I
    # the struct, warps, lanes a stage, staged, bmax, C
    lib.phc_sw_admm_horizon_max_clusters.argtypes = [P] + [I] * 5
    lib.phc_sw_admm_horizon_max_clusters.restype = I


def _bind_stagewise_any(lib):
    P, I = ctypes.c_void_p, ctypes.c_int
    # variant N b C lanes rows G ring
    lib.phc_k6_smem_bytes.argtypes = [I] * 8
    lib.phc_k6_smem_bytes.restype = I
    # r | x, the factors and maps (packed or in row slices), the
    # workspace, the stamps, then P N b windows variant cluster rows G
    # lanes ring threads, the epoch, force_multi, the launches made, stream
    lib.phc_sw_solve_k_any.argtypes = ([P] * 6 + [I] * 11 + [
        ctypes.c_uint, I, ctypes.POINTER(ctypes.c_int), P])
    lib.phc_sw_solve_k_any.restype = I


_BINDERS = {"admm": _bind_admm, "admm_mixed": _bind_admm_mixed,
            "stagewise": _bind_stagewise,
            "stagewise_wide": _bind_stagewise_k5,
            "stagewise_extra": _bind_stagewise_k5,
            "stagewise_horizon": _bind_stagewise_horizon,
            "stagewise_par": _bind_stagewise_k5,
            "stagewise_wide_par": _bind_stagewise_k5,
            "stagewise_extra_par": _bind_stagewise_k5,
            "stagewise_any": _bind_stagewise_any}


def load_library(name: str = "admm"):
    """The loaded kernel library ``name`` (all are built at first call)."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build_libraries()[name]))
    lib.phc_error_string.argtypes = [ctypes.c_int]
    lib.phc_error_string.restype = ctypes.c_char_p
    _BINDERS[name](lib)
    _LIBS[name] = lib
    return lib
