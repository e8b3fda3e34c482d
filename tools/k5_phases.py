"""Where an iteration of K5 spends its cycles, on the card (a development
tool, not part of the package):

    python tools/k5_phases.py
    python tools/k5_phases.py --wide

Run from the root of a checkout. It copies ``csrc/stagewise.cu`` with
clock64() stamps added around the phases of K5's iteration (the sweep and
the Woodbury coefficient, the block barrier after it, the row work, the
cluster or block barrier after that, the group mean and t's completion,
the barrier at the end), builds the copy into ``build/k5_phases/`` and
runs it, warm, on one relaxation (150 iterations) at each driven stagewise
shape of ``chip_smoke.py`` (``k5_waves``). It prints thread 0 of block 0's
cycles an iteration by phase, the stamped kernel's time alone, and the
card's SM clock. The stamps cost registers (ptxas lines printed): read
the split, not the total, against ``chip_smoke.py``'s times.

``--wide`` stamps the iteration of K5's wide instantiations instead
(``csrc/stagewise_wide.cu``, bmax 32 to 128: the forward sweep, the U⁻¹y
pass, the backward sweep, each with the barrier after it; the runtime-r
path's Woodbury sum, coefficient, x correction and extra rows; the row
work's rows and columns; the barrier after it; t's completion; the end
barrier) and runs the
relaxations of phase 37's battery fleets (b = 20, 32, 64, 128) and its ω
tree.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (text of csrc/stagewise.cu, the same with stamps); each occurs once
STAMPS = [
    ("namespace {\n\nconstexpr unsigned kFull",
     "__device__ long long g_ph[8];\nnamespace {\n\nconstexpr unsigned kFull"),
    ("""  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;""",
     """  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long tA = clock64();
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const long long t0 = clock64();"""),
    ("""    __syncthreads();

    // ---- the rows: zr, the z and y updates, and the new w into t ----""",
     """    const long long t1 = clock64();
    __syncthreads();
    const long long t2 = clock64();
    ph[0] += t1 - t0;
    ph[1] += t2 - t1;

    // ---- the rows: zr, the z and y updates, and the new w into t ----"""),
    ("""    if (a.mean) {
      cg::this_cluster().sync();   // every scenario's zr + y/ρ is out""",
     """    const long long t3 = clock64();
    ph[2] += t3 - t2;
    if (a.mean) {
      cg::this_cluster().sync();   // every scenario's zr + y/ρ is out"""),
    ("""      continue;                    // t is complete
    }
""", """      continue;                    // t is complete
    }
    const long long t4 = clock64();
    ph[3] += t4 - t3;
"""),
    ("""          if (c < b) tb[k * b + c] = acc[c];
      }
    }
    __syncthreads();
  }
""", """          if (c < b) tb[k * b + c] = acc[c];
      }
    }
    const long long t5 = clock64();
    __syncthreads();
    ph[4] += t5 - t4;
    ph[5] += clock64() - t5;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int q = 0; q < 6; ++q) g_ph[q] = ph[q];
    g_ph[6] = clock64() - tA;
  }
"""),
]
PHASES = ("sweep + Woodbury", "barrier", "rows", "cluster/block barrier",
          "group mean, t", "end barrier")

# the wide iteration's stamps: thread 0 of block 0 (its sweep warp) adds the
# cycles since the last stamp to phase i at STAMP(i)
WIDE_STAMPS = [
    ("namespace {\n\nconstexpr unsigned kFull",
     "__device__ long long g_ph[16];\n#define STAMP(i) { const long long tn_ "
     "= clock64(); ph[i] += tn_ - tp; tp = tn_; }\n"
     "namespace {\n\nconstexpr unsigned kFull"),
    ("""  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;""",
     """  long long ph[16] = {};
  const long long tA = clock64();
  long long tp = tA;
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;"""),
    ("""        wide_forward<BMAX, true, RING>(tb, mb, L, &fr, N, b, lane);
      __syncthreads();""",
     """        wide_forward<BMAX, true, RING>(tb, mb, L, &fr, N, b, lane);
      __syncthreads();
      STAMP(0)"""),
    ("""        wide_u_pass<BMAX, false>(tb, U, nullptr, N, b, warp, W, lane);
      __syncthreads();""",
     """        wide_u_pass<BMAX, false>(tb, U, nullptr, N, b, warp, W, lane);
      __syncthreads();
      STAMP(1)"""),
    ("""    __syncthreads();

    // ---- the runtime-r path: the Woodbury term and the extra rows ----""",
     """    __syncthreads();
    STAMP(2)

    // ---- the runtime-r path: the Woodbury term and the extra rows ----"""),
    ("""          if (lane == 0) wsum[q] = s;
        }
      __syncthreads();""",
     """          if (lane == 0) wsum[q] = s;
        }
      __syncthreads();
      STAMP(3)"""),
    ("""          corr[q] = cv;
        }
      __syncthreads();""",
     """          corr[q] = cv;
        }
      __syncthreads();
      STAMP(4)"""),
    ("""          xb[e] = xb[e] - cr;
        }
      __syncthreads();""",
     """          xb[e] = xb[e] - cr;
        }
      __syncthreads();
      STAMP(5)"""),
    ("""    // ---- the rows: zr, the z and y updates, and the new w into t ----""",
     """    STAMP(6)
    // ---- the rows: zr, the z and y updates, and the new w into t ----"""),
    ("""        if (k < N) wide_rows(wr, k, cb, last);
        __syncwarp();""",
     """        if (k < N) wide_rows(wr, k, cb, last);
        __syncwarp();
        STAMP(11)"""),
    ("""        if (k < N) wide_cols(wr, k, 1);
      }
    }""",
     """        if (k < N) wide_cols(wr, k, 1);
      }
    }
    STAMP(7)"""),
    ("""    } else if (r) {
      __syncthreads();""",
     """    } else if (r) {
      __syncthreads();
      STAMP(8)"""),
    ("""    __syncthreads();
  }

  // ---- out: x, z, y""",
     """    STAMP(9)
    __syncthreads();
    STAMP(10)
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int q = 0; q < 12; ++q) g_ph[q] = ph[q];
    g_ph[15] = clock64() - tA;
  }

  // ---- out: x, z, y"""),
]
WIDE_PHASES = ("forward sweep", "U pass", "backward sweep", "wsum", "corr",
               "x correction", "pe, z_e, y_e", "rows' columns (wide_cols)",
               "barrier after rows", "t completed", "end barrier",
               "rows (wide_rows)")


def wide_main() -> int:
    """--wide: the wide iteration's cycles by phase at phase 37's shapes."""
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst
    from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
        StagewiseTreeBackend, assemble_stagewise_tree,
        assemble_stagewise_tree_ext, pack_stagewise_tree_data)

    src = (ROOT / "pyhybridcontrol_tpu_torch/csrc/stagewise.cu").read_text()
    for old, new in WIDE_STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source has {src.count(old)} of "
                               f"{old!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int phc_k5_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_ph, "
            "sizeof(long long) * 16);\n}\n")
    out_dir = ROOT / "build" / "k5_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stagewise.cu").write_text(src)
    (out_dir / "stagewise_wide.cu").write_text(
        '#define PHC_SW_PART 1\n#include "stagewise.cu"\n')
    lib_path = out_dir / "libstamped_wide.so"
    got = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(out_dir / "stagewise_wide.cu")],
                         capture_output=True, text=True)
    if got.returncode:
        print(got.stderr[-3000:], file=sys.stderr)
        return 1
    for line in cs.ptxas_report(got.stderr):
        if "sw_admm" in line:
            print(f"  ptxas: {line}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.phc_error_string.argtypes = [ctypes.c_int]
    lib.phc_error_string.restype = ctypes.c_char_p
    _build._bind_stagewise_k5(lib)
    lib.phc_k5_phases.argtypes = [ctypes.c_void_p]
    _build._LIBS["stagewise_wide"] = lib
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    rng = cs.phase_rng("k5_phases_wide")
    waves = []
    for M, N in cs.ANY_FLEETS:
        _, be, fb, hb, lb, ub = cs.fleet_wave(dev, rng, M, N)
        waves.append((f"{M} batteries, N={N}", be, fb, hb, lb, ub))
    swt, x0 = cs.omega_fleet_tree(dev)
    xt = torch.as_tensor(x0, dtype=torch.float32, device=dev)
    be = StagewiseTreeBackend(swt, ext_u=assemble_stagewise_tree_ext(swt, xt))
    f, h = pack_stagewise_tree_data(*assemble_stagewise_tree(swt, xt))
    waves.append(("ω tree, S=16", be,
                  *cs.wave_boxes(be, f, h, 8, rng, cs.K4_HOLD_FIX)))
    for tag, be, fb, hb, lb, ub in waves:
        with cs.k5_calls() as calls:
            be.solve(fb, hb, lb, ub, cs.K5_RELAX)
        args = calls[0]
        P, pl = cs.k5_plan_of(args)
        ms = cs.cuda_ms(lambda: cst.sw_admm_cuda(*args))
        stamps = (ctypes.c_longlong * 16)()
        lib.phc_k5_phases(ctypes.addressof(stamps))
        it = args[10]
        print(f"{tag} (b={args[0].b}, {pl.variant}, ring {pl.ring}), {it} "
              f"iterations: {1e3 * ms / it:.2f} us an iteration (stamped "
              f"kernel alone); cycles an iteration: " + ", ".join(
                  f"{n} {stamps[i] / it:.0f}"
                  for i, n in enumerate(WIDE_PHASES))
              + f"; all {stamps[15] / it:.0f}", flush=True)
    return 0


def main() -> int:
    if "--wide" in sys.argv[1:]:
        return wide_main()
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst

    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 1
    src = (ROOT / "pyhybridcontrol_tpu_torch/csrc/stagewise.cu").read_text()
    for old, new in STAMPS:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source has {src.count(old)} of "
                               f"{old!r}")
        src = src.replace(old, new)
    src += ('\nextern "C" int phc_k5_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_ph, "
            "sizeof(long long) * 8);\n}\n")
    out_dir = ROOT / "build" / "k5_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stagewise_stamped.cu").write_text(src)
    lib_path = out_dir / "libstamped.so"
    got = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path),
                          str(out_dir / "stagewise_stamped.cu")],
                         capture_output=True, text=True)
    if got.returncode:
        print(got.stderr[-3000:], file=sys.stderr)
        return 1
    for line in cs.ptxas_report(got.stderr):
        if "sw_admm" in line:
            print(f"  ptxas: {line}", flush=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.phc_error_string.argtypes = [ctypes.c_int]
    lib.phc_error_string.restype = ctypes.c_char_p
    _build._bind_stagewise(lib)
    lib.phc_k5_phases.argtypes = [ctypes.c_void_p]
    _build._LIBS["stagewise"] = lib
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    for tag, key, be, bp, fb, hb, lb, ub in cs.k5_waves(
            dev, cs.phase_rng("k5")):
        with cs.k5_calls() as calls:
            r0 = be.solve(fb, hb, lb, ub, cs.K5_RELAX)
            be.solve(fb, hb, lb, ub, cs.K5_RELAX, warm=(r0.x, r0.z, r0.y))
        args = calls[1]
        ms = cs.cuda_ms(lambda: cst.sw_admm_cuda(*args))
        stamps = (ctypes.c_longlong * 8)()
        lib.phc_k5_phases(ctypes.addressof(stamps))
        it = args[10]
        clock = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True).stdout.strip()
        print(f"{tag}, {it} iterations: {1e3 * ms / it:.2f} us an iteration "
              f"(stamped kernel alone); cycles an iteration: " + ", ".join(
                  f"{n} {stamps[i] / it:.0f}" for i, n in enumerate(PHASES))
              + f"; all {stamps[6] / it:.0f} (SM clock now {clock})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
