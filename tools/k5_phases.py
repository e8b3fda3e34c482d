"""Where an iteration of K5 spends its cycles, on the card (a development
tool, not part of the package):

    python tools/k5_phases.py
    python tools/k5_phases.py --wide
    python tools/k5_phases.py --flex

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

``--flex`` stamps the narrow iteration as the default mode does, at each
shape of ``chip_smoke.flex_waves`` (the ``long_horizon`` waves on the
global variant, forced, the ``wide_tree`` waves on their plan and at the
grouped variant's earlier placement, ⌈S/16⌉ scenarios a CTA), and
also the sweep inside ``sweep_rows`` (its forward and backward halves,
cycles a stage); one relaxation (the wave's cold launch) at each. Then it
stamps the horizon variant (``csrc/stagewise_horizon.cu``) at the two
long_horizon waves in both sweeps, thread 0 of each CTA of the first
cluster (one window each): the handoffs' waits and stores, the window's
forward and backward sweeps, the carries and the corrections (the
parallel sweep), the cluster barriers, the rows.
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
    const bool last = it == a.iters - 1;
    float* cb""",
     """  long long ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  const long long tA = clock64();
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const long long t0 = clock64();
    float* cb"""),
    ("""    __syncthreads();

    // ---- the runtime-r path: the Woodbury term and the extra rows ----""",
     """    const long long t1 = clock64();
    __syncthreads();
    const long long t2 = clock64();
    ph[0] += t1 - t0;
    ph[1] += t2 - t1;

    // ---- the runtime-r path: the Woodbury term and the extra rows ----"""),
    ("""    if (a.mean) {
      // place 2: the consensus buffers""",
     """    const long long t3 = clock64();
    ph[2] += t3 - t2;
    if (a.mean) {
      // place 2: the consensus buffers"""),
    ("""      __syncthreads();
      continue;                    // t is complete
    }
""", """      __syncthreads();
      ph[3] += clock64() - t3;
      continue;                    // t is complete
    }
    const long long t4 = clock64();
    ph[3] += t4 - t3;
"""),
    ("""              if (c < b) tb[k * b + c] = acc[c];
          }
        }
      }
    }
    __syncthreads();
  }
""", """              if (c < b) tb[k * b + c] = acc[c];
          }
        }
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
    const bool last = it == a.iters - 1;
    float* cb""",
     """  long long ph[16] = {};
  const long long tA = clock64();
  long long tp = tA;
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    float* cb"""),
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


# the sweep's halves inside sweep_rows (the register path's sweep, which
# the narrow iteration runs): thread 0 of block 0 adds its forward and
# backward cycles and counts its sweeps
SWEEP_STAMPS = [
    ("  const int lo = row ? lane * b : 0;   // this lane's row of a factor "
     "block\n",
     "  const int lo = row ? lane * b : 0;   // this lane's row of a factor "
     "block\n  const long long sw0 = clock64();\n"),
    ("""  __syncwarp();

  // ---- backward sweep: x_k = U⁻¹_k y_k − C_k x_{k+1} ----""",
     """  __syncwarp();
  const long long sw1 = clock64();

  // ---- backward sweep: x_k = U⁻¹_k y_k − C_k x_{k+1} ----"""),
    ("""      yc[j] = yn[j];
    }
  }
}

// ---- the wide sweep""", """      yc[j] = yn[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    g_sw[0] += sw1 - sw0;
    g_sw[1] += clock64() - sw1;
    g_sw[2] += 1;
  }
}

// ---- the wide sweep"""),
]


def stamped(src, stamps, out_name, part=None):
    """``src`` with each (text, replacement) of ``stamps`` applied (each
    text must occur once), built into build/k5_phases/ (as the library of
    the part ``part`` where given): the loaded library and its ptxas
    lines of K5."""
    from pyhybridcontrol_tpu_torch.ops import _build

    import chip_smoke as cs

    for old, new in stamps:
        if src.count(old) != 1:
            raise RuntimeError(f"the kernel source has {src.count(old)} of "
                               f"{old!r}")
        src = src.replace(old, new)
    out_dir = ROOT / "build" / "k5_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "stagewise.cu").write_text(src)
    top = out_dir / "stagewise.cu"
    if part is not None:
        top = out_dir / f"{out_name}.cu"
        top.write_text(f'#define PHC_SW_PART {part}\n'
                       '#include "stagewise.cu"\n')
    lib_path = out_dir / f"lib{out_name}.so"
    got = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(top)],
                         capture_output=True, text=True)
    if got.returncode:
        raise RuntimeError(got.stderr[-3000:])
    lines = [ln for ln in cs.ptxas_report(got.stderr) if "sw_admm" in ln]
    lib = ctypes.CDLL(str(lib_path))
    lib.phc_error_string.argtypes = [ctypes.c_int]
    lib.phc_error_string.restype = ctypes.c_char_p
    return lib, lines


def sm_clock() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


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
    src += ('\nextern "C" int phc_k5_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_ph, "
            "sizeof(long long) * 16);\n}\n")
    lib, lines = stamped(src, WIDE_STAMPS, "stamped_wide", part=1)
    for line in lines:
        print(f"  ptxas: {line}", flush=True)
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


# the horizon variant's stamps: thread 0 of each CTA adds the cycles since
# the last stamp to phase i at STAMP(i); the first cluster's CTAs keep
# theirs
HORIZON_STAMPS = [
    ("namespace {\n\nconstexpr unsigned kFull",
     "__device__ long long g_hz[8 * 16];\n#define STAMP(i) { const long "
     "long tn_ = clock64(); ph[i] += tn_ - tp; tp = tn_; }\n"
     "namespace {\n\nconstexpr unsigned kFull"),
    ("""  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const unsigned par = (unsigned)it & 1u;     // the handoffs' phase""",
     """  long long ph[16] = {};
  const long long tA = clock64();
  long long tp = tA;
  for (int it = 0; it < a.iters; ++it) {
    const bool last = it == a.iters - 1;
    const unsigned par = (unsigned)it & 1u;     // the handoffs' phase"""),
    ("""        if (c > 0) hz_wait(bar, par);
""", """        if (c > 0) hz_wait(bar, par);
        STAMP(0)
"""),
    ("""        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, c > 0 ? yin : nullptr);
        __syncwarp();
        if (c < C - 1 && lane == 0) hz_hand(tb + (n - 1) * b, yin, bar, b, c + 1);
        if (c < C - 1) hz_wait(bar + 1, par);
""", """        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, c > 0 ? yin : nullptr);
        __syncwarp();
        STAMP(1)
        if (c < C - 1 && lane == 0) hz_hand(tb + (n - 1) * b, yin, bar, b, c + 1);
        STAMP(2)
        if (c < C - 1) hz_wait(bar + 1, par);
        STAMP(3)
"""),
    ("""                                  c < C - 1 ? xin : nullptr);
        __syncwarp();
        if (c > 0 && lane == 0) hz_hand(xb, xin, bar + 1, b, c - 1);
""", """                                  c < C - 1 ? xin : nullptr);
        __syncwarp();
        STAMP(4)
        if (c > 0 && lane == 0) hz_hand(xb, xin, bar + 1, b, c - 1);
        STAMP(5)
"""),
    ("""        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) py[lane] = tb[(n - 1) * b + lane];
      }
      cl.sync();                        // every window's y⁰ published
      if (warp == 0) hz_carry<BMAX>(yin, cm, vb, py, C, c, b, lane, true);
      __syncthreads();
      if (c > 0) hz_correct(tb, h.Pi, yin, s0, n, b, tid, T);
      __syncthreads();
      if (warp == 0) {
        window_backward<BMAX, B0>(tb, U, Cf, xb, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) px[lane] = xb[lane];
      }
      cl.sync();                        // every window's x⁰ published
      if (warp == 0) hz_carry<BMAX>(xin, cm, vb, px, C, c, b, lane, false);
      __syncthreads();
      if (c < C - 1) hz_correct(xb, h.Psi, xin, s0, n, b, tid, T);
      __syncthreads();
""", """        window_forward<BMAX, B0>(tb, mb, L, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) py[lane] = tb[(n - 1) * b + lane];
      }
      STAMP(1)
      cl.sync();                        // every window's y⁰ published
      STAMP(6)
      if (warp == 0) hz_carry<BMAX>(yin, cm, vb, py, C, c, b, lane, true);
      STAMP(7)
      __syncthreads();
      if (c > 0) hz_correct(tb, h.Pi, yin, s0, n, b, tid, T);
      __syncthreads();
      STAMP(8)
      if (warp == 0) {
        window_backward<BMAX, B0>(tb, U, Cf, xb, n, b, lane, nullptr);
        __syncwarp();
        if (lane < b) px[lane] = xb[lane];
      }
      STAMP(4)
      cl.sync();                        // every window's x⁰ published
      STAMP(6)
      if (warp == 0) hz_carry<BMAX>(xin, cm, vb, px, C, c, b, lane, false);
      STAMP(7)
      __syncthreads();
      if (c < C - 1) hz_correct(xb, h.Psi, xin, s0, n, b, tid, T);
      __syncthreads();
      STAMP(8)
"""),
    ("""    cl.sync();                          // x and the halos complete
""", """    cl.sync();                          // x and the halos complete
    STAMP(9)
"""),
    ("""    cl.sync();                          // t and the peers' M parts complete
  }
""", """    STAMP(10)
    cl.sync();                          // t and the peers' M parts complete
    STAMP(11)
  }
  if (threadIdx.x == 0 && blockIdx.x < C) {
    for (int q = 0; q < 12; ++q) g_hz[blockIdx.x * 16 + q] = ph[q];
    g_hz[blockIdx.x * 16 + 15] = clock64() - tA;
  }
"""),
]
HORIZON_PHASES = ("wait for y", "forward sweep", "hand y on", "wait for x",
                  "backward sweep", "hand x back", "cluster barriers (carries)",
                  "carry", "corrections", "halo, barrier", "rows",
                  "end barrier")


def horizon_stamps(dev) -> None:
    """The horizon variant's iteration by phase and CTA at the two
    long_horizon waves, in both sweeps (``HORIZON_STAMPS``)."""
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst

    src = (ROOT / "pyhybridcontrol_tpu_torch/csrc/stagewise.cu").read_text()
    src += ('\n#if PHC_SW_PART == 3\nextern "C" int phc_hz_phases(long long* '
            "out) {\n  return (int)cudaMemcpyFromSymbol(out, g_hz, "
            "sizeof(long long) * 8 * 16);\n}\n#endif\n")
    lib, lines = stamped(src, HORIZON_STAMPS, "stamped_horizon", part=3)
    for line in lines:
        print(f"  ptxas: {line}", flush=True)
    _build._bind_stagewise_horizon(lib)
    lib.phc_hz_phases.argtypes = [ctypes.c_void_p]
    lib.phc_hz_phases.restype = ctypes.c_int
    _build._LIBS["stagewise_horizon"] = lib
    for tag, key, be, fb, hb, lb, ub, _ in cs.flex_waves(
            dev, cs.phase_rng("k5_flex")):
        if key not in ("di", "hull"):
            continue
        with cs.k5_calls() as calls:
            be.solve(fb, hb, lb, ub, cs.K5_RELAX)
        args = calls[0]
        it = args[10]
        for par in (False, True):
            pl = cst.plan_admm(args[1].numel() // (args[0].N * args[0].b),
                               args[0].N, args[0].b, args[0].m_k,
                               parallel=par, device=args[1].device)
            ms = cs.kernel_ms(lambda: cst.sw_admm_cuda(*args, parallel=par))
            stamps = (ctypes.c_longlong * (8 * 16))()
            lib.phc_hz_phases(ctypes.addressof(stamps))
            print(f"{tag}, the horizon variant's "
                  f"{'parallel' if par else 'sequential'} sweep (C="
                  f"{pl.cluster}, tps {pl.tps}, {32 * pl.warps} threads), "
                  f"{it} iterations: {1e3 * ms / it:.2f} us an iteration "
                  f"(stamped kernel alone; SM clock now {sm_clock()})",
                  flush=True)
            for c in range(pl.cluster):
                row = stamps[16 * c:16 * c + 16]
                print(f"  CTA {c}: cycles an iteration: " + ", ".join(
                    f"{nm} {row[i] / it:.0f}"
                    for i, nm in enumerate(HORIZON_PHASES) if row[i])
                    + f"; all {row[15] / it:.0f}", flush=True)


def flex_main() -> int:
    """--flex: the narrow iteration's phases and the sweep's stages at
    flex_waves' shapes."""
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst

    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 1
    src = (ROOT / "pyhybridcontrol_tpu_torch/csrc/stagewise.cu").read_text()
    src += ('\nextern "C" int phc_k5_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_ph, "
            "sizeof(long long) * 8);\n}\n"
            'extern "C" int phc_k5_sweep(long long* out, int reset) {\n'
            "  if (reset) return (int)cudaMemcpyToSymbol(g_sw, out, "
            "sizeof(long long) * 3);\n"
            "  return (int)cudaMemcpyFromSymbol(out, g_sw, "
            "sizeof(long long) * 3);\n}\n")
    decl = (STAMPS[0][0], STAMPS[0][1].replace(
        "namespace {", "__device__ long long g_sw[3];\nnamespace {"))
    lib, lines = stamped(src, [decl] + STAMPS[1:] + SWEEP_STAMPS,
                         "stamped_flex")
    for line in lines:
        print(f"  ptxas: {line}", flush=True)
    _build._bind_stagewise(lib)
    for fn in (lib.phc_k5_phases, lib.phc_k5_sweep):
        fn.restype = ctypes.c_int
    lib.phc_k5_phases.argtypes = [ctypes.c_void_p]
    lib.phc_k5_sweep.argtypes = [ctypes.c_void_p, ctypes.c_int]
    _build._LIBS["stagewise"] = lib
    dev = torch.device("cuda")
    print(cs.gpu_line(), flush=True)
    for tag, key, be, fb, hb, lb, ub, kernel in cs.flex_waves(
            dev, cs.phase_rng("k5_flex")):
        with cs.k5_calls() as calls:
            be.solve(fb, hb, lb, ub, cs.K5_RELAX)
        args = calls[0]
        # the long horizons on the global variant; the trees on their plan
        # and at the grouped variant's earlier placement (⌈S/16⌉
        # scenarios a CTA)
        runs = [dict(variant="global")] if key in ("di", "hull") else [
            {}, dict(variant="grouped", spc=-(-args[11].shape[0] // 16))]
        for kw in runs:
            P, pl = cs.k5_plan_of(args, **kw)
            ms = cs.kernel_ms(lambda: cst.sw_admm_cuda(*args, **kw))
            zero = (ctypes.c_longlong * 3)()
            lib.phc_k5_sweep(ctypes.addressof(zero), 1)
            cst.sw_admm_cuda(*args, **kw)
            torch.cuda.synchronize()
            sweep = (ctypes.c_longlong * 3)()
            lib.phc_k5_sweep(ctypes.addressof(sweep), 0)
            stamps = (ctypes.c_longlong * 8)()
            lib.phc_k5_phases(ctypes.addressof(stamps))
            it, N = args[10], args[0].N
            n = max(sweep[2], 1)
            print(f"{tag} ({pl.variant}, bmax {pl.bmax}, tps {pl.tps}, "
                  f"{32 * pl.warps} threads, {pl.spc} scenario(s) a CTA, "
                  f"clusters of {pl.cluster}), {it} iterations: "
                  f"{1e3 * ms / it:.2f} us an iteration (stamped kernel "
                  f"alone); cycles an iteration: " + ", ".join(
                      f"{nm} {stamps[i] / it:.0f}"
                      for i, nm in enumerate(PHASES))
                  + f"; all {stamps[6] / it:.0f}; in sweep_rows: forward "
                  f"{sweep[0] / n:.0f} ({sweep[0] / n / N:.1f} a stage), "
                  f"backward {sweep[1] / n:.0f} ({sweep[1] / n / N:.1f} a "
                  f"stage) over {sweep[2]} sweeps (SM clock now "
                  f"{sm_clock()})", flush=True)
    horizon_stamps(dev)
    return 0


def main() -> int:
    if "--wide" in sys.argv[1:]:
        return wide_main()
    if "--flex" in sys.argv[1:]:
        return flex_main()
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build
    from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cst

    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 1
    src = (ROOT / "pyhybridcontrol_tpu_torch/csrc/stagewise.cu").read_text()
    src += ('\nextern "C" int phc_k5_phases(long long* out) {\n'
            "  return (int)cudaMemcpyFromSymbol(out, g_ph, "
            "sizeof(long long) * 8);\n}\n")
    lib, lines = stamped(src, STAMPS, "stamped")
    for line in lines:
        print(f"  ptxas: {line}", flush=True)
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
        clock = sm_clock()
        print(f"{tag}, {it} iterations: {1e3 * ms / it:.2f} us an iteration "
              f"(stamped kernel alone); cycles an iteration: " + ", ".join(
                  f"{n} {stamps[i] / it:.0f}" for i, n in enumerate(PHASES))
              + f"; all {stamps[6] / it:.0f} (SM clock now {clock})",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
