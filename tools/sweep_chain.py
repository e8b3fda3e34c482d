"""What one stage of the stagewise sweep's dependent chain costs on the
card, by how a stage's vector reaches the lanes (a development tool, not
part of the package):

    python tools/sweep_chain.py

Builds a small kernel (its source is below) into ``build/sweep_chain/``
and runs one warp through 24,000 dependent stages of each kind, timed with
clock64(): a stage of the sweep at b=5 (5 shuffles of the previous
stage's vector and a chain of 5 FMAs), the same FMAs alone, the shuffles
with the FMAs in two chains or a tree, and the vector passed through
shared memory (store, __syncwarp, 5 broadcast loads) instead of shuffles.
It prints cycles a stage: the floor of K4's and K5's sweep (2·N stages a
sweep) on this card, to read their measured time against.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

SOURCE = r"""
#include <cuda_runtime.h>
constexpr unsigned kFull = 0xffffffffu;

// one kind of stage a compiled loop (MODE: 0 shuffles + one FMA chain, the
// sweep's; 1 the FMA chain alone; 2 shuffles + two FMA chains; 3 a
// shared-memory broadcast + one FMA chain; 4 shuffles + an FMA tree)
template <int MODE>
__global__ void chain(float* out, long long* cyc, int n) {
  __shared__ float s[32];
  const int lane = threadIdx.x;
  float c[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) c[j] = lane < 5 ? 0.01f * (lane + j) : 0.0f;
  float prev = lane < 5 ? 0.5f : 0.0f;
  const long long t0 = clock64();
  for (int k = 0; k < n; ++k) {
    float y[5];
    if constexpr (MODE == 3) {
      if (lane < 5) s[lane] = prev;
      __syncwarp();
#pragma unroll
      for (int j = 0; j < 5; ++j) y[j] = s[j];
      __syncwarp();
    } else {
#pragma unroll
      for (int j = 0; j < 5; ++j)
        y[j] = MODE == 1 ? prev : __shfl_sync(kFull, prev, j);
    }
    float acc;
    if constexpr (MODE == 2) {
      acc = fmaf(c[2], y[2], fmaf(c[1], y[1], c[0] * y[0])) +
            fmaf(c[4], y[4], c[3] * y[3]);
    } else if constexpr (MODE == 4) {
      acc = (fmaf(c[1], y[1], c[0] * y[0]) + fmaf(c[3], y[3], c[2] * y[2])) +
            c[4] * y[4];
    } else {
      acc = 0.0f;
#pragma unroll
      for (int j = 0; j < 5; ++j) acc = fmaf(c[j], y[j], acc);
    }
    prev = 1.0f - acc;
  }
  const long long t1 = clock64();
  out[lane] = prev;
  if (lane == 0) cyc[0] = t1 - t0;
}

extern "C" int phc_chain(float* out, long long* cyc, int n, int mode) {
  switch (mode) {
    case 0: chain<0><<<1, 32>>>(out, cyc, n); break;
    case 1: chain<1><<<1, 32>>>(out, cyc, n); break;
    case 2: chain<2><<<1, 32>>>(out, cyc, n); break;
    case 3: chain<3><<<1, 32>>>(out, cyc, n); break;
    default: chain<4><<<1, 32>>>(out, cyc, n); break;
  }
  return (int)cudaDeviceSynchronize();
}
"""
KINDS = ("5 shuffles + a chain of 5 FMAs (the sweep's stage)",
         "a chain of 5 FMAs alone",
         "5 shuffles + FMAs in two chains",
         "shared-memory broadcast + a chain of 5 FMAs",
         "5 shuffles + an FMA tree")
STAGES = 24000


def main() -> int:
    import torch

    import chip_smoke as cs
    from pyhybridcontrol_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("sweep_chain: no CUDA device", file=sys.stderr)
        return 1
    out_dir = ROOT / "build" / "sweep_chain"
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "chain.cu").write_text(SOURCE)
    lib_path = out_dir / "libchain.so"
    got = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                          str(lib_path), str(out_dir / "chain.cu")],
                         capture_output=True, text=True)
    if got.returncode:
        print(got.stderr[-3000:], file=sys.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    lib.phc_chain.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_int, ctypes.c_int]
    out = torch.zeros(32, device="cuda")
    cyc = torch.zeros(1, dtype=torch.int64, device="cuda")
    print(cs.gpu_line(), flush=True)
    for mode, kind in enumerate(KINDS):
        lib.phc_chain(out.data_ptr(), cyc.data_ptr(), STAGES // 10, mode)
        lib.phc_chain(out.data_ptr(), cyc.data_ptr(), STAGES, mode)
        print(f"{kind}: {cyc.item() / STAGES:.1f} cycles a stage",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
