"""K4: the block-tridiagonal sweep K⁻¹r of the stagewise frame (CUDA C++,
``csrc/stagewise.cu``), its plan and its wrapper.

No TPU kernel stands behind K4: the reference runs the sweep as two
``lax.scan`` loops that XLA compiles into one device loop
(``pyhybridcontrol_tpu/ops/stagewise.py::_solve_K``). Its plain version is
``ops/stagewise.py::_solve_K``, a Python loop over the stages.

``ops/stagewise._solve_K_bordered`` dispatches on the tensor's device and
on nothing else: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel (``sw_solve_k_cuda``) or raises. r is (…, N, b) fp32,
the factors (L, U⁻¹, C) are (N, b, b) fp32 on the same device, shared by
every problem of the batch.
Each launch counts once in ``cuda_admm.LAUNCHES["stagewise_k4"]`` (and its
problem count P in ``LAUNCH_BATCHES``).

``plan_sweep`` picks the instantiation from the shapes alone: the compiled
bound on the block size (8, 16, 32, 64 or 128, the smallest at or above b),
whether a block stages the three factor arrays in shared memory beside its
warps' r/y buffers, and the warps (problems) a block: 4, 2 or 1, the most
that fit. b above 128, or a horizon whose r/y buffer does not fit one
block, has no instantiation and raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
    SMEM_MAX,
    _count_launch,
    _ptr,
    _raise_on,
)

SWEEP_WARPS = (4, 2, 1)          # problems (warps) a block, most first
SWEEP_BMAX = (8, 16, 32, 64, 128)   # compiled bounds on the block size


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Instantiation of K4 for one call: the compiled bound on b, staged
    factors, warps a block and dynamic shared memory (bytes)."""

    bmax: int
    staged: bool
    warps: int
    smem: int


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def sweep_smem_bytes(N: int, b: int, warps: int, staged: bool) -> int:
    """Shared memory of one K4 block (``phc_sw_smem_bytes`` gives the
    same): N·b words of r/y a warp, plus 3·N·b² words of factors if staged,
    each array padded to a multiple of 4 words."""
    return 4 * ((3 * _pad4(N * b * b) if staged else 0)
                + warps * _pad4(N * b))


def plan_sweep(P: int, N: int, b: int,
               staged: Optional[bool] = None) -> SweepPlan:
    """The instantiation K4 runs P problems of horizon N and block b with:
    staged factors where they fit a block beside at least one warp's y
    buffer (with the most warps that fit), else factors read through L2.
    ``staged`` asks for one variant. Raises ValueError where nothing fits:
    there is no other path."""
    what = "K4 (stagewise sweep)"
    if P < 1 or N < 1 or b < 1:
        raise ValueError(f"{what}: empty shape P={P}, N={N}, b={b}")
    bmax = next((m for m in SWEEP_BMAX if b <= m), None)
    if bmax is None:
        raise ValueError(f"{what}: block size b={b} above the "
                         f"{SWEEP_BMAX[-1]} the kernel is built for")
    for st in ((True, False) if staged is None else (bool(staged),)):
        for w in SWEEP_WARPS:
            smem = sweep_smem_bytes(N, b, w, st)
            if smem <= SMEM_MAX:
                return SweepPlan(bmax=bmax, staged=st, warps=w, smem=smem)
    raise ValueError(
        f"{what}: N={N}, b={b} needs {sweep_smem_bytes(N, b, 1, False)} "
        f"bytes of shared memory for one warp's r/y buffer"
        + (" and the staged factors" if staged else "")
        + f", above the {SMEM_MAX} an sm_90 block has")


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def sw_solve_k_cuda(r, factors, staged: Optional[bool] = None):
    """K4 on the card: x = K⁻¹ r for r (…, N, b) from the factors
    (L, U⁻¹, C), each (N, b, b). ``staged`` asks for one variant instead of
    the plan's. Checks, allocates x and launches once."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    if r.device.type != "cuda":
        raise ValueError(f"K4: expected a CUDA tensor, got {r.device}")
    if r.ndim < 2:
        raise ValueError(f"K4: r must be (..., N, b), got {tuple(r.shape)}")
    N, b = r.shape[-2:]
    rr = r.reshape(-1, N, b)
    _check("r", rr, rr.shape, r.device)
    for name, f in zip(("L", "Uinv", "C"), factors):
        _check(name, f, (N, b, b), r.device)
    P = rr.shape[0]
    pl = plan_sweep(P, N, b, staged)
    x = torch.empty_like(rr)
    lib = load_library("stagewise")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.phc_sw_solve_k(*map(_ptr, (rr, *factors, x)), P, N, b,
                                pl.warps, int(pl.staged), pl.bmax,
                                ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K4 (stagewise sweep)")
    _count_launch("stagewise_k4", P)
    return x.reshape(r.shape)

