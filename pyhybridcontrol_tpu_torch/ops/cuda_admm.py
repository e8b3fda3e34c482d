"""The two batched ADMM kernels (CUDA C++, ``csrc/admm.cu``), their plain
torch versions, and the device-dispatching entry points.

Counterpart of ``pyhybridcontrol_tpu/ops/pallas_admm.py``:

- K1 replaces ``_admm_kernel`` (reached through ``_pallas_run``):
  ``iters`` σ=0 OSQP iterations per problem plus one half step for δy,
  then the stats block (obj, r_prim, per-row relative r_prim, r_dual,
  OSQP infeasibility certificate).
- K2 replaces ``_admm_wave_kernel`` (reached through
  ``_pallas_wave_run``): the K1 relaxation, the dive-probe bounds made in
  the kernel (each binary fixed to round(clip(clip(x̃, node box), 0, 1))),
  then p1 = probe_iters//2 stiff-ρ and p2 base-ρ probe iterations,
  warm-chained, and a second stats block. One launch per B&B wave.

σ=0 elimination (as in the reference): with the box rows in Â,
K₀ = P̂ + Âᵀρ Â is positive definite, so each iteration is

    t  = Â_Gᵀ w_G + d_box ∘ w_box − q̂,   w = ρz − y
    ẑ  = M t,   M = [Â_G; diag(d_box)] K₀⁻¹   (host fp64, once)

and x̃ is the box block of ẑ divided by d_box. The σ=0 path agrees with
the σ-form ``ops/admm.admm_solve`` at convergence, not mid-flight.

Dispatch follows the tensor's device and nothing else: a CPU tensor runs
the plain torch version, a CUDA tensor launches the kernel or raises.
There is no batch-size gate and no fallback. Each kernel wrapper counts
its launches in ``LAUNCHES`` (and their batch sizes in ``LAUNCH_BATCHES``),
once under each variant a launch runs: "admm_k1"/"admm_k2" for the
staged full-precision kernels, "admm_k1_streamed"/"admm_k2_streamed" for
the streamed ones, "admm_k1_split" for K1 in split mode (a streamed K1
launch in split mode counts under both of its variants).

On the card K1 and K2 give each thread block a tile of 8, 4 or 1 problems:
``plan`` picks the instantiation (tile, threads, shared memory, staged or
streamed constants) from the batch size and the padded shape alone, and
every batch size goes through the kernel (the ragged last tile is masked
there). Where a block cannot hold Â_G and Mᵀ (the double integrator from
N=27, the reference bench's configs 2, 3, 4b and 4c) the streamed variant
reads them from device memory, which the H100's L2 serves, and keeps only
the tile's iterates in shared memory. The kernels pack and unpack
themselves: they read q, h, lb, ub in original units (any row stride, so
an expanded row is read in place) and warm iterates in the public (B,
m+n) layout, and write x, z, y in that layout; the wrapper checks,
allocates once and launches.

K1's split-precision option (``low_frac``, the reference's ``iters_lo``
phase): the first ``int(iters * low_frac)`` iterations take each product
as the manual 3-pass bf16 product  A·b ≈ Ahi·bhi + Ahi·blo + Alo·bhi
(hi = bf16(a), lo = bf16(a − hi), fp32 accumulation). On the card
``split_route`` picks, from the shape alone, where that phase runs: its
own kernel on the tensor cores (``csrc/admm_mixed.cu``, a tile of 16 or
32 problems per block, ``plan_mixed``), which hands its iterates to K1
for the full-precision tail, the final half step and the stats; or,
where that kernel's constants do not fit a block (N ≥ 22 of the double
integrator), K1 itself in split mode, the same arithmetic on the CUDA
cores, followed in the same launch by the tail. The tensor-core tiles
want nr and mGp in multiples of 16, so this path (plain version and
kernels alike) runs on a copy of the prep zero-padded from the 8 grain
to 16 (``pad_kernel_qp``); zero rows and columns are inert.
``low_frac`` stays off the B&B path, as in the reference.

The plain versions keep the reference's public layout — q (B,n), h (B,m),
lb/ub (B,n) in, ``AdmmResult`` out — and iterate on padded batch-first
arrays made by ``_pack`` with the same single multiplications the kernels
apply, so the two compare like with like. Stats reductions accumulate in
float64 in both.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pyhybridcontrol_tpu_torch.ops.admm import (
    BIG,
    AdmmResult,
    BoxQP,
    infeasibility_certificate,
)

# launches per kernel wrapper (incremented only where the kernel launches;
# "stagewise_k4" by ops/cuda_stagewise.py)
LAUNCHES = {"admm_k1": 0, "admm_k2": 0, "admm_k1_mixed": 0,
            "admm_k1_streamed": 0, "admm_k2_streamed": 0, "admm_k1_split": 0,
            "stagewise_k4": 0}
# batch size -> launches, per kernel wrapper (same events as LAUNCHES)
LAUNCH_BATCHES = {k: {} for k in LAUNCHES}

# row/column grain of the tensor-core tiles of the split-precision phase
MIXED_GRAIN = 16

# shared memory one thread block may use on sm_90 (227 KB)
SMEM_MAX = 232448


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAUNCH_BATCHES[k].clear()


def _count_launch(name: str, B: int):
    LAUNCHES[name] += 1
    LAUNCH_BATCHES[name][B] = LAUNCH_BATCHES[name].get(B, 0) + 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class KernelQP:
    """Padded σ=0 problem data for K1/K2, derived from a prepared
    :class:`BoxQP` (host fp64, once). nr = round8(n), mGp = round8(m);
    padded rows are zero in every matrix and inert in the iteration."""

    base: BoxQP
    AGT: torch.Tensor        # (nr, mGp)  Â_Gᵀ zero-padded
    M: torch.Tensor          # (mGp+nr, nr)  [Â_G; diag(d_box)] K₀⁻¹
    P: torch.Tensor          # (nr, nr)  P̂ padded
    dbox: torch.Tensor       # (nr,)  box diagonal E_box·D (0 in padding)
    dbox_inv: torch.Tensor   # (nr,)  1/d_box (1 in padding)
    rhoG: torch.Tensor       # (mGp,) per-row ρ (1 in padding)
    rhoG_inv: torch.Tensor   # (mGp,)
    rhoB: torch.Tensor       # (nr,)
    rhoB_inv: torch.Tensor   # (nr,)
    EG_inv: torch.Tensor     # (mGp,) 1/E over G rows (1 in padding)
    EB_inv: torch.Tensor     # (nr,)  1/E over box rows
    Dc_inv: torch.Tensor     # (nr,)  1/(D·c) (dual residual unscale)
    cinv: torch.Tensor       # ()  1/c in fp32
    n_pad: int
    m_pad: int
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)


def prepare_kernel_qp(spec: BoxQP) -> KernelQP:
    """Pad + σ=0 refactor of a prepared BoxQP (host fp64, once) — the
    counterpart of the reference's ``prepare_pallas``, on the same
    fp32-rounded spec data, so both give bit-identical fp32 arrays."""
    n, m = spec.n, spec.m_ineq
    nr = _round_up(n, 8)
    mGp = _round_up(m, 8)

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    Ah, Ph, rho = host(spec.A), host(spec.P), host(spec.rho_vec)
    E, D = host(spec.E), host(spec.D)
    c = float(host(spec.cost_scale))

    AG = Ah[:m]                                   # (m, n) scaled G block
    box = Ah[m:]
    # the box rows must be n rows forming a diagonal (A = [G; I] scaled)
    if box.shape[0] != n or np.count_nonzero(box - np.diag(np.diag(box))):
        raise ValueError("prepare_kernel_qp: the box rows of Â must form "
                         "an n×n diagonal")
    dbox = np.diag(box)
    # σ=0 KKT matrix (fp64): P̂ + Âᵀ ρ Â  (positive definite — box rows)
    K0 = Ph + (Ah.T * rho[None, :]) @ Ah
    K0inv = np.linalg.inv(K0)
    Mfull = np.vstack([AG, np.diag(dbox)]) @ K0inv       # (m+n, n)

    AGT = np.zeros((nr, mGp), np.float32)
    AGT[:n, :m] = AG.T
    Mp = np.zeros((mGp + nr, nr), np.float32)
    Mp[:m, :n] = Mfull[:m]
    Mp[mGp:mGp + n, :n] = Mfull[m:]
    Pp = np.zeros((nr, nr), np.float32)
    Pp[:n, :n] = Ph

    def col(v, rows, fill):
        out = np.full((rows,), fill, np.float32)
        out[:len(v)] = v
        return out

    db = col(dbox, nr, 0.0)
    dev = spec.device

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    return KernelQP(
        base=spec, AGT=t(AGT), M=t(Mp), P=t(Pp), dbox=t(db),
        dbox_inv=t(np.where(db == 0.0, 1.0,
                            1.0 / np.where(db == 0.0, 1.0, db))),
        rhoG=t(col(rho[:m], mGp, 1.0)),
        rhoG_inv=t(col(1.0 / rho[:m], mGp, 1.0)),
        rhoB=t(col(rho[m:], nr, 1.0)),
        rhoB_inv=t(col(1.0 / rho[m:], nr, 1.0)),
        EG_inv=t(col(1.0 / E[:m], mGp, 1.0)),
        EB_inv=t(col(1.0 / E[m:], nr, 1.0)),
        Dc_inv=t(col(1.0 / (D * c), nr, 1.0)),
        cinv=(1.0 / spec.cost_scale).float(),
        n_pad=nr, m_pad=mGp,
    )


def kernel_qp_for(spec: BoxQP) -> KernelQP:
    """Memoized ``prepare_kernel_qp``, stored on the spec."""
    kq = spec.cache.get("kernel_qp")
    if kq is None:
        kq = spec.cache["kernel_qp"] = prepare_kernel_qp(spec)
    return kq


def pad_kernel_qp(kq: KernelQP, grain: int = MIXED_GRAIN) -> KernelQP:
    """``kq`` with nr and mGp zero-padded up to multiples of ``grain``
    (memoized on ``kq``). New rows and columns are zero in every matrix,
    carry l = u = 0 bounds from the packing and ρ = 1, so they stay at
    zero through the iteration and change no output."""
    nr, mGp = _round_up(kq.n_pad, grain), _round_up(kq.m_pad, grain)
    if (nr, mGp) == (kq.n_pad, kq.m_pad):
        return kq
    got = kq.cache.get(("pad", grain))
    if got is not None:
        return got
    dn, dm = nr - kq.n_pad, mGp - kq.m_pad

    def vec(v, d, fill):
        return F.pad(v, (0, d), value=fill)

    M = torch.cat([F.pad(kq.M[:kq.m_pad], (0, dn, 0, dm)),
                   F.pad(kq.M[kq.m_pad:], (0, dn, 0, dn))])
    got = kq.cache[("pad", grain)] = KernelQP(
        base=kq.base, AGT=F.pad(kq.AGT, (0, dm, 0, dn)), M=M,
        P=F.pad(kq.P, (0, dn, 0, dn)), dbox=vec(kq.dbox, dn, 0.0),
        dbox_inv=vec(kq.dbox_inv, dn, 1.0), rhoG=vec(kq.rhoG, dm, 1.0),
        rhoG_inv=vec(kq.rhoG_inv, dm, 1.0), rhoB=vec(kq.rhoB, dn, 1.0),
        rhoB_inv=vec(kq.rhoB_inv, dn, 1.0), EG_inv=vec(kq.EG_inv, dm, 1.0),
        EB_inv=vec(kq.EB_inv, dn, 1.0), Dc_inv=vec(kq.Dc_inv, dn, 1.0),
        cinv=kq.cinv, n_pad=nr, m_pad=mGp)
    return got


# ---- packing: original-unit (B, ·) inputs → padded scaled batch-first ----


def _pack(kq: KernelQP, q, h, lb, ub, warm):
    spec = kq.base
    n, m, mt = spec.n, spec.m_ineq, spec.m_total
    nr, mGp = kq.n_pad, kq.m_pad
    B = q.shape[0]
    qs = F.pad(spec.cost_scale * spec.D * q, (0, nr - n))
    lG = F.pad(q.new_full((B, m), -BIG), (0, mGp - m))
    uG = F.pad(h * spec.E[:m], (0, mGp - m))
    lB = F.pad(torch.clamp(lb * spec.E[m:], -BIG, BIG), (0, nr - n))
    uB = F.pad(torch.clamp(ub * spec.E[m:], -BIG, BIG), (0, nr - n))
    warm4 = None
    if warm is not None:
        _, z0, y0 = warm
        warm4 = (F.pad(z0[:, :m], (0, mGp - m)),
                 F.pad(y0[:, :m], (0, mGp - m)),
                 F.pad(z0[:, m:mt], (0, nr - n)),
                 F.pad(y0[:, m:mt], (0, nr - n)))
        warm4 = tuple(w.contiguous() for w in warm4)
    return qs, lG, uG, lB, uB, warm4


def _result(kq: KernelQP, x, zG, yG, zB, yB, obj, r_prim, r_rel, r_dual,
            cert) -> AdmmResult:
    spec = kq.base
    n, m = spec.n, spec.m_ineq
    return AdmmResult(
        x=spec.D * x[:, :n], obj=obj, r_prim=r_prim, r_prim_rel=r_rel,
        r_dual=r_dual, infeas_cert=cert,
        y=torch.cat([yG[:, :m], yB[:, :n]], dim=-1),
        z=torch.cat([zG[:, :m], zB[:, :n]], dim=-1))


# ---- plain torch versions of K1 and K2 -----------------------------------


def _init_iterates(lG, uG, lB, uB, warm4):
    if warm4 is None:
        return (torch.clamp(torch.zeros_like(lG), lG, uG),
                torch.zeros_like(lG),
                torch.clamp(torch.zeros_like(lB), lB, uB),
                torch.zeros_like(lB))
    z0G, y0G, z0B, y0B = warm4
    return (torch.clamp(z0G, lG, uG), y0G, torch.clamp(z0B, lB, uB), y0B)


def _bf16_split(a):
    """fp32 → (hi, lo), both bf16 values held in fp32: hi = bf16(a),
    lo = bf16(a − hi); hi + lo ≈ a to ~16 mantissa bits."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def _mm3(A):
    """b ↦ b·A as the manual 3-pass bf16 product
    bhi·Ahi + blo·Ahi + bhi·Alo (the lo·lo term is below fp32 rounding).
    bf16 × bf16 is exact in fp32, so three fp32 ``@`` of the rounded
    operands accumulate what the tensor cores accumulate. The constant is
    split once, the iterate operand at each call."""
    Ahi, Alo = _bf16_split(A)

    def mm(b):
        bhi, blo = _bf16_split(b)
        return bhi @ Ahi + blo @ Ahi + bhi @ Alo
    return mm


def _phase(q, lG, uG, lB, uB, AGT, M, dbox, rhoG, rhoGi, rhoB, rhoBi,
           zG, yG, zB, yB, iters: int, alpha: float, final: bool = True,
           mixed: bool = False):
    """``iters`` σ=0 iterations from the (already clipped) iterates, then
    — if ``final`` — one more half step, whose ẑ and δy feed the stats.
    ``mixed``: both products as 3-pass bf16 products (``_mm3``).
    Returns (ẑ_G, ẑ_B, z_G, y_G, z_B, y_B, δy_G, δy_B)."""
    mGp = AGT.shape[1]
    AG, MT = AGT.T, M.T
    if mixed:
        mmA, mmM = _mm3(AG), _mm3(MT)
    else:
        def mmA(w):
            return w @ AG

        def mmM(t):
            return t @ MT

    def half_step(zG, yG, zB, yB):
        t = mmA(rhoG * zG - yG) + dbox * (rhoB * zB - yB) - q
        u = mmM(t)                                    # Â x̃, both blocks
        return u[:, :mGp], u[:, mGp:]

    for _ in range(iters):
        ztG, ztB = half_step(zG, yG, zB, yB)
        zrG = alpha * ztG + (1.0 - alpha) * zG
        zG_new = torch.clamp(zrG + yG * rhoGi, lG, uG)
        dyG = rhoG * (zrG - zG_new)
        zrB = alpha * ztB + (1.0 - alpha) * zB
        zB_new = torch.clamp(zrB + yB * rhoBi, lB, uB)
        dyB = rhoB * (zrB - zB_new)
        zG, yG, zB, yB = zG_new, yG + dyG, zB_new, yB + dyB
    if not final:
        return None, None, zG, yG, zB, yB, None, None
    ztG, ztB = half_step(zG, yG, zB, yB)
    zrG = alpha * ztG + (1.0 - alpha) * zG
    dyG = rhoG * (zrG - torch.clamp(zrG + yG * rhoGi, lG, uG))
    zrB = alpha * ztB + (1.0 - alpha) * zB
    dyB = rhoB * (zrB - torch.clamp(zrB + yB * rhoBi, lB, uB))
    return ztG, ztB, zG, yG, zB, yB, dyG, dyB


def _stats(kq: KernelQP, q, lG, uG, lB, uB, ztG, ztB, x, yG, yB, dyG, dyB):
    """(obj, r_prim, r_rel, r_dual, cert), all in original units."""
    AG = kq.AGT.T
    egi, ebi = kq.EG_inv, kq.EB_inv
    violG = torch.abs(ztG - torch.clamp(ztG, lG, uG)) * egi
    violB = torch.abs(ztB - torch.clamp(ztB, lB, uB)) * ebi
    r_prim = torch.maximum(violG.amax(-1), violB.amax(-1))
    relG = violG / torch.clamp_min(torch.abs(ztG * egi), 1.0)
    relB = violB / torch.clamp_min(torch.abs(ztB * ebi), 1.0)
    r_rel = torch.maximum(relG.amax(-1), relB.amax(-1))
    Px = x @ kq.P.T
    Aty = yG @ AG + kq.dbox * yB
    r_dual = ((Px + q + Aty) * kq.Dc_inv).abs().amax(-1)
    obj = ((0.5 * (x.double() * Px.double()).sum(-1)
            + (q.double() * x.double()).sum(-1))
           * kq.cinv.double()).float()
    Atdy = (dyG @ AG + kq.dbox * dyB).abs().amax(-1)
    cert = infeasibility_certificate(
        torch.cat([dyG, dyB], -1), Atdy,
        torch.cat([lG, lB], -1), torch.cat([uG, uB], -1))
    return obj, r_prim, r_rel, r_dual, cert


def _relax(kq: KernelQP, qs, lG, uG, lB, uB, iters, iterates):
    ztG, ztB, zG, yG, zB, yB, dyG, dyB = _phase(
        qs, lG, uG, lB, uB, kq.AGT, kq.M, kq.dbox, kq.rhoG, kq.rhoG_inv,
        kq.rhoB, kq.rhoB_inv, *iterates, iters, kq.base.alpha)
    x = ztB * kq.dbox_inv                         # x̃ = d⁻¹ (d ∘ x̃)
    st = _stats(kq, qs, lG, uG, lB, uB, ztG, ztB, x, yG, yB, dyG, dyB)
    return ztB, (zG, yG, zB, yB), _result(kq, x, zG, yG, zB, yB, *st)


def _mixed_plain(kq: KernelQP, qs, lG, uG, lB, uB, iterates, iters_lo):
    """Plain version of the split-precision phase: ``iters_lo`` iterations
    with 3-pass bf16 products; returns the iterates (z_G, y_G, z_B, y_B)."""
    return _phase(qs, lG, uG, lB, uB, kq.AGT, kq.M, kq.dbox, kq.rhoG,
                  kq.rhoG_inv, kq.rhoB, kq.rhoB_inv, *iterates, iters_lo,
                  kq.base.alpha, final=False, mixed=True)[2:6]


def _solve_plain(kq: KernelQP, q, h, lb, ub, iters, iters_lo, warm):
    """K1's function on the padded arrays of ``kq`` as it stands (no
    re-padding): ``iters_lo`` split-precision iterations, then the
    full-precision tail, half step and stats."""
    qs, lG, uG, lB, uB, warm4 = _pack(kq, q, h, lb, ub, warm)
    it = _init_iterates(lG, uG, lB, uB, warm4)
    if iters_lo > 0:
        it = _mixed_plain(kq, qs, lG, uG, lB, uB, it, iters_lo)
    return _relax(kq, qs, lG, uG, lB, uB, max(iters - iters_lo, 0), it)[2]


def _split_iters(kq: KernelQP, iters: int, low_frac: float):
    """(prep to run on, iters_lo): the split-precision phase runs on the
    16-padded prep."""
    if not 0.0 <= low_frac <= 1.0:
        raise ValueError(f"low_frac must be in [0, 1], got {low_frac}")
    iters_lo = int(iters * low_frac)
    return (pad_kernel_qp(kq) if iters_lo > 0 else kq), iters_lo


def admm_solve_plain(kq: KernelQP, q, h, lb, ub, iters: int = 100,
                     warm=None, low_frac: float = 0.0) -> AdmmResult:
    """Plain torch version of K1. q (B,n), h (B,m), lb/ub (B,n) in
    ORIGINAL units; ``warm`` = (x, z, y) of a previous result (x unused:
    the σ=0 iteration has no x-carry). ``low_frac``: share of the
    iterations, from the first on, run with 3-pass bf16 products."""
    kq, iters_lo = _split_iters(kq, iters, low_frac)
    return _solve_plain(kq, q, h, lb, ub, iters, iters_lo, warm)


def _binaries(kq: KernelQP, binary_idx):
    """(index tensor, (nr,) float mask) of the binaries, kept on the
    prep's device so a wave copies nothing from the host."""
    key = ("binaries", tuple(int(i) for i in binary_idx))
    got = kq.cache.get(key)
    if got is None:
        idx = torch.as_tensor(key[1], dtype=torch.long, device=kq.AGT.device)
        mask = torch.zeros(kq.n_pad, dtype=torch.float32,
                           device=kq.AGT.device)
        mask[idx] = 1.0
        got = kq.cache[key] = (idx, mask)
    return got


def _split_probe(kq2: Optional[KernelQP], probe_iters: int):
    p1 = probe_iters // 2 if kq2 is not None else 0
    return p1, probe_iters - p1


def admm_wave_plain(kq: KernelQP, kq2: Optional[KernelQP], binary_idx,
                    q, h, lb, ub, iters: int = 100, probe_iters: int = 100,
                    warm=None):
    """Plain torch version of K2: relaxation, in-kernel probe bounds,
    two-phase probe. ``kq2`` is the optional stiff-ρ prep (same Ruiz
    frame). Returns ``(relax, probe)`` AdmmResults."""
    qs, lG, uG, lB, uB, warm4 = _pack(kq, q, h, lb, ub, warm)
    ztB, (zG, yG, zB, yB), relax = _relax(
        kq, qs, lG, uG, lB, uB, iters, _init_iterates(lG, uG, lB, uB, warm4))

    # probe bounds: ztB is E_box·x; clip to the node box first (so fixed
    # binaries reproduce their value exactly), round half to even
    binm = _binaries(kq, binary_idx)[1] > 0
    x_orig = torch.clamp(ztB, lB, uB) * kq.EB_inv
    pv = torch.round(torch.clamp(x_orig, 0.0, 1.0)) / kq.EB_inv
    lBp = torch.where(binm, pv, lB)
    uBp = torch.where(binm, pv, uB)

    p1, p2 = _split_probe(kq2, probe_iters)
    it = (zG, yG, torch.clamp(zB, lBp, uBp), yB)
    if p1 > 0:
        _, _, *it, _, _ = _phase(
            qs, lG, uG, lBp, uBp, kq.AGT, kq2.M, kq.dbox, kq2.rhoG,
            kq2.rhoG_inv, kq2.rhoB, kq2.rhoB_inv, *it, p1, kq2.base.alpha,
            final=False)
    _, _, probe = _relax(kq, qs, lG, uG, lBp, uBp, p2, it)
    return relax, probe


# ---- CUDA launches -------------------------------------------------------

# What the kernels' launch plan reckons with (csrc/admm.cu has the same
# figures): an H100 has 132 SMs; a block is a tile of PB problems and 8 to
# MAX_WARPS[PB] warps; a warp task of product A (t = Â_Gᵀw) and B (ẑ = M t)
# covers ROWS_PER_TASK output rows.
SM_COUNT = 132
TILES = (8, 4, 1)
ROWS_PER_TASK = (4, 16)
# lane groups over which ẑ = M t deals its depth, per tile (B_KS of the
# source's Cfg tables): the rows of Mᵀ lie permuted to match (depth_rows)
B_KS = {8: 4, 4: 4, 1: 8}
MAX_WARPS = {8: 18, 4: 12, 1: 12}
_RED = 16            # floats of reduction workspace per warp and problem


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Instantiation of K1/K2 for one batch: problems per block, threads
    per block, dynamic shared memory (bytes) per block, and whether Â_G
    and Mᵀ are read from device memory (streamed) instead of staged."""

    pb: int
    threads: int
    smem: int
    streamed: bool = False

    @property
    def warps(self) -> int:
        return self.threads // 32


def _strides(nr: int, mGp: int):
    """Row strides (floats) of Â_G and Mᵀ in shared memory: padded so that
    the lane groups of a warp, which read rows one apart, hit different
    banks (Â_G: ≡ 4 mod 8; Mᵀ: ≡ 16 mod 32)."""
    R = mGp + nr
    return nr + 4, R + (48 - R % 32) % 32


def smem_bytes(nr: int, mGp: int, pb: int, streamed: bool = False) -> int:
    """Shared memory one block of K1 or K2 needs with a tile of ``pb``
    problems (``phc_admm_smem_bytes`` of the library gives the same):
    Â_G and Mᵀ with padded row strides (not in the streamed variant), 3
    per-row vectors, and per problem 6 arrays of R rows, 6 of nr and the
    reduction workspace. K2 takes no more than K1: M2ᵀ is staged over Mᵀ
    for the stiff phase, or read where it lies."""
    R = mGp + nr
    stride_a, stride_m = _strides(nr, mGp)
    consts = 0 if streamed else mGp * stride_a + nr * stride_m
    return 4 * (consts + 3 * R + 2 * nr
                + pb * (6 * R + 6 * nr + _RED * MAX_WARPS[pb]))


def _warps(nr: int, mGp: int, pb: int) -> int:
    """Warps per block: the count from 8 to ``MAX_WARPS[pb]`` that leaves
    the fewest warps idle in the worse of the two products (fewest warps
    on a tie)."""
    rows_a, rows_b = ROWS_PER_TASK

    def busy(nw):
        share = []
        for rows, per in ((nr, rows_a), (mGp + nr, rows_b)):
            tasks = -(-rows // per)
            rounds = -(-tasks // nw)
            share.append(rows / per / (rounds * nw))
        return min(share)
    return max(range(8, MAX_WARPS[pb] + 1), key=lambda nw: (busy(nw), -nw))


def plan(B: int, nr: int, mGp: int, pb: Optional[int] = None,
         streamed: Optional[bool] = None) -> LaunchPlan:
    """The instantiation K1 and K2 run a batch of ``B`` problems with, from
    the shapes alone: the largest tile in ``TILES`` that fits a block's
    shared memory and still leaves about two blocks for every SM (a tile
    of 1 where no larger one does), with Â_G and Mᵀ staged in shared
    memory wherever that fits, else streamed from device memory. ``pb``
    asks for one tile width, ``streamed`` for one variant. Raises
    ValueError where nothing fits: there is no other path."""
    if B < 1:
        raise ValueError("ADMM kernel: empty batch")
    if pb is not None and pb not in TILES:
        raise ValueError(f"ADMM kernel: no instantiation with a tile of "
                         f"{pb} problems (have {TILES})")
    for st in ((False, True) if streamed is None else (bool(streamed),)):
        for t in (TILES if pb is None else (pb,)):
            smem = smem_bytes(nr, mGp, t, st)
            if smem > SMEM_MAX:
                continue
            if pb is None and t > 1 and -(-B // t) < 1.9 * SM_COUNT:
                continue
            return LaunchPlan(pb=t, threads=32 * _warps(nr, mGp, t),
                              smem=smem, streamed=st)
    need = smem_bytes(nr, mGp, pb or 1, bool(streamed))
    raise ValueError(
        f"ADMM kernel: nr={nr}, mGp={mGp} needs {need} bytes of shared "
        f"memory per block, above the {SMEM_MAX} an sm_90 block has")


class _Args(ctypes.Structure):
    """``struct PhcAdmmArgs`` of csrc/admm.cu, field by field."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "q", "h", "lb", "ub", "z0G", "y0G", "z0B", "y0B", "AG", "MT",
            "PT", "vec", "io", "binm", "MT2", "vec2", "x", "z", "y", "st",
            "xp", "zp", "yp", "stp")]
        + [(k, ctypes.c_int) for k in (
            "sq", "sh", "slb", "sub", "sz0G", "sy0G", "sz0B", "sy0B", "B",
            "n", "m", "nr", "mGp", "iters", "iters_lo", "p1", "p2")]
        + [(k, ctypes.c_float) for k in ("alpha", "alpha2", "cinv")])


def depth_rows(nr: int, ks: int) -> np.ndarray:
    """Variable held by each of the nr rows of t and Mᵀ when ẑ = M t deals
    its depth to ``ks`` lane groups, one row in ``ks`` each: row p holds
    variable (p mod ks)·(nr/ks) + p div ks, so every group sums a
    contiguous run of variables (the kernel's ``t_row`` is the inverse)."""
    p = np.arange(nr)
    return (p % ks) * (nr // ks) + p // ks


def _layout(kq: KernelQP):
    """Device constants in the kernels' layout: Â_G as (mGp, nr) and Mᵀ as
    (nr, mGp+nr), each with its shared-memory row stride (``_strides``,
    zero in the pad columns: the staged kernels copy them as they lie, the
    streamed ones read them in place) — Mᵀ once per lane-group count of
    ``B_KS``, its rows in ``depth_rows`` order — and P̂ᵀ, so neighbouring
    threads read neighbouring words;
    the per-row vectors packed as ``vec`` = [d_box, 1/d_box, ρ_B, 1/ρ_B,
    1/E_B, 1/(D·c) | ρ_G, 1/ρ_G, 1/E_G]; and what packing needs, ``io`` =
    [c·D, E_B, D | E_G], zero in the padding (the same single products as
    ``_pack`` and ``_result``)."""
    lay = kq.cache.get("layout")
    if lay is None:
        spec = kq.base
        n, m = spec.n, spec.m_ineq
        vec = torch.cat([kq.dbox, kq.dbox_inv, kq.rhoB, kq.rhoB_inv,
                         kq.EB_inv, kq.Dc_inv, kq.rhoG, kq.rhoG_inv,
                         kq.EG_inv]).contiguous()
        io = torch.cat([F.pad(spec.cost_scale * spec.D, (0, kq.n_pad - n)),
                        F.pad(spec.E[m:], (0, kq.n_pad - n)),
                        F.pad(spec.D, (0, kq.n_pad - n)),
                        F.pad(spec.E[:m], (0, kq.m_pad - m))]
                       ).float().contiguous()
        sa, sm = _strides(kq.n_pad, kq.m_pad)
        MT = F.pad(kq.M.T, (0, sm - kq.m_pad - kq.n_pad))
        lay = kq.cache["layout"] = dict(
            AG=F.pad(kq.AGT.T, (0, sa - kq.n_pad)).contiguous(),
            MT={ks: MT[torch.as_tensor(depth_rows(kq.n_pad, ks),
                                       device=MT.device)].contiguous()
                for ks in set(B_KS.values())},
            PT=kq.P.T.contiguous(), vec=vec, io=io, cinv=float(kq.cinv))
    return lay


def _check(name, t, shape):
    """A float32 CUDA tensor of ``shape`` whose rows are contiguous (any
    row stride: an expanded row is read in place). Returns the row stride."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.stride(-1) != 1 and t.shape[-1] > 1:
        raise ValueError(f"{name}: expected contiguous rows")
    return t.stride(0) if t.ndim == 2 and t.shape[0] > 1 else 0


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.phc_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _warm_views(kq: KernelQP, warm):
    """The four warm arrays (z_G, y_G, z_B, y_B) as the kernels read them.
    ``warm`` is (x, z, y) of a previous result in the public (B, m+n)
    layout, or the four padded arrays of the split-precision phase."""
    if warm is None:
        return None
    if len(warm) == 4:
        return warm
    m, mt = kq.base.m_ineq, kq.base.m_total
    _, z0, y0 = warm
    return z0[:, :m], y0[:, :m], z0[:, m:mt], y0[:, m:mt]


def _launch(name: str, kq: KernelQP, kq2: Optional[KernelQP], binmask,
            q, h, lb, ub, warm, iters: int, p1: int, p2: int,
            pb: Optional[int], streamed: Optional[bool] = None,
            iters_lo: int = 0):
    """Check the inputs, allocate the outputs, launch K1 (``name`` =
    "admm_k1"; ``iters_lo`` split-mode iterations before ``iters`` full
    ones) or K2 once. Returns one AdmmResult per stats block."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    spec = kq.base
    n, m, mt = spec.n, spec.m_ineq, spec.m_total
    B = q.shape[0]
    pl = plan(B, kq.n_pad, kq.m_pad, pb, streamed)
    a = _Args()
    for k, t, cols in (("q", q, n), ("h", h, m), ("lb", lb, n),
                       ("ub", ub, n)):
        setattr(a, "s" + k, _check(k, t, (B, cols)))
        setattr(a, k, t.data_ptr())
    w4 = _warm_views(kq, warm)
    if w4 is not None:
        for k, t in zip(("z0G", "y0G", "z0B", "y0B"), w4):
            rows = t.shape[1]
            if rows < (m if k.endswith("G") else n):
                raise ValueError(f"{k}: {rows} columns, need at least "
                                 f"{m if k.endswith('G') else n}")
            setattr(a, "s" + k, _check(k, t, (B, rows)))
            setattr(a, k, t.data_ptr())
    lay = _layout(kq)
    for k in ("AG", "PT", "vec", "io"):
        setattr(a, k, lay[k].data_ptr())
    ks = B_KS[pl.pb]
    a.MT = lay["MT"][ks].data_ptr()
    wave = name == "admm_k2"
    if wave:
        _check("binmask", binmask, (kq.n_pad,))
        lay2 = _layout(kq2) if kq2 is not None else lay
        a.binm, a.MT2, a.vec2 = (binmask.data_ptr(),
                                 lay2["MT"][ks].data_ptr(),
                                 lay2["vec"].data_ptr())
        a.alpha2 = (kq2 if kq2 is not None else kq).base.alpha
    # one allocation, cut into x (B,n), z, y (B,m+n) and stats (B,8) per
    # stats block
    sizes = (B * n, B * mt, B * mt, B * 8) * (2 if wave else 1)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=q.device)
    outs = [c.view(B, -1) for c in flat.split(sizes)]
    for k, t in zip(("x", "z", "y", "st", "xp", "zp", "yp", "stp"), outs):
        setattr(a, k, t.data_ptr())
    a.B, a.n, a.m, a.nr, a.mGp = B, n, m, kq.n_pad, kq.m_pad
    a.iters, a.iters_lo = int(iters), int(iters_lo)
    a.p1, a.p2 = int(p1), int(p2)
    a.alpha, a.cinv = spec.alpha, lay["cinv"]
    lib = load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = getattr(lib, "phc_" + name)(ctypes.addressof(a), pl.pb,
                                         int(pl.streamed), pl.threads,
                                         ctypes.c_void_p(stream))
    _raise_on(lib, rc, name)
    variants = ([name + "_streamed"] if pl.streamed else []) + (
        ["admm_k1_split"] if iters_lo > 0 else [])
    for k in variants or [name]:
        _count_launch(k, B)
    return [AdmmResult(x=x, obj=st[:, 0], r_prim=st[:, 1],
                       r_prim_rel=st[:, 2], r_dual=st[:, 3],
                       infeas_cert=st[:, 4] > 0.5, y=y, z=z)
            for x, z, y, st in zip(*[iter(outs)] * 4)]


def _layout_mixed(kq: KernelQP):
    """bf16 hi/lo pairs of Â_Gᵀ (nr, mGp) and M (mGp+nr, nr), row-major
    as the tensor-core tiles read them."""
    lay = kq.cache.get("layout_mixed")
    if lay is None:
        def pair(a):
            hi = a.bfloat16()
            return hi.contiguous(), (a - hi.float()).bfloat16().contiguous()

        lay = kq.cache["layout_mixed"] = dict(A=pair(kq.AGT), M=pair(kq.M))
    return lay


# The split-precision kernel's instantiations (csrc/admm_mixed.cu has the
# same figures): a block owns a tile of T problems and has one warp per 16
# rows of u = M t; each tile width is compiled for at most this many threads.
MIXED_TILES = (32, 16)
MIXED_MAX_THREADS = {32: 544, 16: 640}


@dataclasses.dataclass(frozen=True)
class MixedPlan:
    """Instantiation of the split-precision kernel for one batch: problems
    per block, threads per block and dynamic shared memory (bytes)."""

    tile: int
    threads: int
    smem: int


def mixed_strides(nr: int, mGp: int):
    """Row strides (bf16 elements) of Â_Gᵀ and M in shared memory: 8 over a
    multiple of 16, so the 8 rows (16 bytes each) of an ``ldmatrix`` phase
    fall in 8 different 16-byte bank groups. (The operand tiles are not
    padded: their 16-byte chunks are XOR-swizzled.)"""
    return mGp + 8, nr + 8


def _mixed_jobs(nr: int, mGp: int) -> int:
    """(row tile, K slice) jobs of the t = Â_Gᵀw product: as many K slices
    per row tile as the warps allow, at most one per K tile."""
    warps, n_t, k_t = (nr + mGp) // 16, nr // 16, mGp // 16
    return n_t * min(k_t, max(1, warps // n_t))


def mixed_smem_bytes(nr: int, mGp: int, tile: int) -> int:
    """Shared memory one block of the split-precision kernel needs with a
    tile of ``tile`` problems (``phc_admm_mixed_smem_bytes`` gives the
    same): the bf16 hi/lo pairs of Â_Gᵀ and M and of both operand tiles with
    padded strides, both operand tiles, in fp32 the K-slice partials of t,
    d∘w_B, q and l_B, and (ρ, 1/ρ, d_box, 0) per row of u."""
    sa, sm = mixed_strides(nr, mGp)
    R = mGp + nr
    return (4 * (nr * sa + R * sm) + 4 * R * tile
            + 4 * tile * (16 * _mixed_jobs(nr, mGp) + 3 * nr) + 16 * R)


def split_route(nr: int, mGp: int) -> str:
    """Where the split-precision phase of K1 runs on the card, from the
    16-padded shape alone: "tensor_cores" (the ``mma.sync`` kernel of
    ``csrc/admm_mixed.cu``) where its tile of 16 problems fits a block,
    else "k1_split" (K1 in split mode, constants staged or streamed as
    ``plan`` decides)."""
    fits = (mixed_smem_bytes(nr, mGp, 16) <= SMEM_MAX
            and 2 * (nr + mGp) <= MIXED_MAX_THREADS[16])
    return "tensor_cores" if fits else "k1_split"


def plan_mixed(B: int, nr: int, mGp: int, sm_count: int = SM_COUNT,
               tile: Optional[int] = None) -> MixedPlan:
    """The instantiation the split-precision kernel runs a batch of ``B``
    problems with, from the batch size, the 16-padded shape and the card's
    SM count alone: a tile of 32 problems where a tile of 16 would take more
    than one round of blocks (⌈B/16⌉ > ``sm_count``) and 32 fits, else 16.
    ``tile`` asks for one width. Every batch goes through the kernel (the
    ragged last tile is masked there). Raises ValueError where nothing
    fits: there is no other path."""
    what = "split-precision ADMM kernel"
    if B < 1:
        raise ValueError(f"{what}: empty batch")
    if nr % MIXED_GRAIN or mGp % MIXED_GRAIN or min(nr, mGp) < MIXED_GRAIN:
        raise ValueError(f"{what}: nr={nr}, mGp={mGp} must be multiples of "
                         f"{MIXED_GRAIN} (pad_kernel_qp)")
    if tile is not None and tile not in MIXED_TILES:
        raise ValueError(f"{what}: no instantiation with a tile of {tile} "
                         f"problems (have {MIXED_TILES})")
    threads = 2 * (nr + mGp)

    def fits(t):
        return (mixed_smem_bytes(nr, mGp, t) <= SMEM_MAX
                and threads <= MIXED_MAX_THREADS[t])

    if tile is None:
        tile = 32 if -(-B // 16) > sm_count and fits(32) else 16
    smem = mixed_smem_bytes(nr, mGp, tile)
    if smem > SMEM_MAX:
        raise ValueError(
            f"{what}: nr={nr}, mGp={mGp} needs {smem} bytes of shared memory "
            f"per block with a tile of {tile}, above the {SMEM_MAX} an sm_90 "
            f"block has")
    if threads > MIXED_MAX_THREADS[tile]:
        raise ValueError(
            f"{what}: nr={nr}, mGp={mGp} needs {threads} threads per block, "
            f"above the {MIXED_MAX_THREADS[tile]} the tile of {tile} is "
            f"built for")
    return MixedPlan(tile=tile, threads=threads, smem=smem)


def _launch_k1_mixed(kq: KernelQP, qs, lG, uG, lB, uB, warm4, iters_lo: int,
                     tile: Optional[int] = None):
    """The split-precision phase on the tensor cores; returns the iterates
    (z_G, y_G, z_B, y_B) that warm-start K1's full-precision tail. ``tile``
    asks for one tile width instead of the plan's. The arrays are
    ``_pack``'s: the kernel takes l_G as the constant −BIG of the G rows
    (G x ≤ h, as K1 does) and does not read ``lG``; on the zero-padded rows,
    where ``_pack`` puts 0, M's rows are zero and z stays 0 either way."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    nr, mGp = kq.n_pad, kq.m_pad
    B = qs.shape[0]
    names = ("q", "lG", "uG", "lB", "uB", "z0G", "y0G", "z0B", "y0B")
    rows = (nr, mGp, mGp, nr, nr, mGp, mGp, nr, nr)
    for name, t, r in zip(names, (qs, lG, uG, lB, uB) + tuple(warm4 or ()),
                          rows):
        _check(name, t, (B, r))
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous tensor")
    pl = plan_mixed(B, nr, mGp, torch.cuda.get_device_properties(
        qs.device).multi_processor_count, tile)
    lib = load_library("admm_mixed")
    lay, vec = _layout_mixed(kq), _layout(kq)["vec"]
    outs = [torch.empty((B, r), dtype=torch.float32, device=qs.device)
            for r in (mGp, mGp, nr, nr)]
    w = warm4 if warm4 is not None else (None,) * 4
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        rc = lib.phc_admm_k1_mixed(
            *map(_ptr, (qs, uG, lB, uB, *w, *lay["A"], *lay["M"], vec,
                        *outs)),
            B, nr, mGp, int(iters_lo), kq.base.alpha, pl.tile,
            ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K1 split-precision phase (admm_k1_mixed)")
    _count_launch("admm_k1_mixed", B)
    return tuple(outs)


def admm_solve_cuda(kq: KernelQP, q, h, lb, ub, iters: int = 100,
                    warm=None, low_frac: float = 0.0,
                    pb: Optional[int] = None,
                    streamed: Optional[bool] = None) -> AdmmResult:
    """K1 on the card; same contract as ``admm_solve_plain``. The kernel
    packs and unpacks itself: the wrapper checks, allocates and launches.
    With ``low_frac`` > 0 the leading iterations run where ``split_route``
    says: in the tensor-core kernel (on packed arrays), whose iterates
    warm-start K1 for the rest, or in K1's own split mode, in the same
    launch as the rest. ``pb`` and ``streamed`` ask for one tile width or
    one variant instead of the plan's."""
    kq, iters_lo = _split_iters(kq, iters, low_frac)
    if iters_lo > 0 and split_route(kq.n_pad, kq.m_pad) == "tensor_cores":
        qs, lG, uG, lB, uB, warm4 = _pack(kq, q, h, lb, ub, warm)
        warm = _launch_k1_mixed(kq, qs, lG, uG, lB, uB, warm4, iters_lo)
        iters, iters_lo = iters - iters_lo, 0
    return _launch("admm_k1", kq, None, None, q, h, lb, ub, warm,
                   max(iters - iters_lo, 0), 0, 0, pb, streamed,
                   iters_lo)[0]


def admm_wave_cuda(kq: KernelQP, kq2: Optional[KernelQP], binary_idx,
                   q, h, lb, ub, iters: int = 100, probe_iters: int = 100,
                   warm=None, pb: Optional[int] = None,
                   streamed: Optional[bool] = None):
    """K2 on the card; same contract as ``admm_wave_plain``."""
    p1, p2 = _split_probe(kq2, probe_iters)
    return tuple(_launch("admm_k2", kq, kq2, _binaries(kq, binary_idx)[1],
                         q, h, lb, ub, warm, iters, p1, p2, pb, streamed))


# ---- entry points --------------------------------------------------------


def _route(t, plain, kernel):
    if t.device.type == "cpu":
        return plain
    if t.device.type == "cuda":
        return kernel
    raise ValueError(f"no ADMM kernel for device {t.device}")


def _batch(q, h, lb, ub, warm, m):
    B, n = q.shape
    return (h.expand(B, m), lb.expand(B, n), ub.expand(B, n),
            None if warm is None else tuple(w.expand(B, -1) for w in warm))


def admm_solve_auto(spec: BoxQP, q, h, lb, ub, iters: int = 100,
                    warm=None) -> AdmmResult:
    """Batched σ=0 ADMM (same contract as ``ops.admm.admm_solve``): K1 on
    a CUDA tensor, its plain version on a CPU tensor. A 1-D ``q`` is a
    batch of one."""
    single = q.ndim == 1
    if single:
        q = q[None]
    if q.ndim != 2:
        raise ValueError(f"admm_solve_auto: q must be (B, n), got "
                         f"{tuple(q.shape)}")
    hb, lbb, ubb, warm = _batch(q, h, lb, ub, warm, spec.m_ineq)
    fn = _route(q, admm_solve_plain, admm_solve_cuda)
    res = fn(kernel_qp_for(spec), q, hb, lbb, ubb, iters=iters, warm=warm)
    if single:
        res = AdmmResult(**{k: None if v is None else v[0]
                            for k, v in vars(res).items()})
    return res


def admm_wave_auto(spec: BoxQP, spec_probe: Optional[BoxQP], binary_idx,
                   q, h, lb, ub, iters: int = 100, probe_iters: int = 100,
                   warm=None):
    """One B&B wave: relaxation + dive probe through K2 (CUDA tensor) or
    its plain version (CPU tensor), for any batch size. Returns
    ``(relax, probe, lb_probe, ub_probe)``; the probe bounds (original
    units) feed the caller's certified probe clamp."""
    hb, lbb, ubb, warm = _batch(q, h, lb, ub, warm, spec.m_ineq)
    fn = _route(q, admm_wave_plain, admm_wave_cuda)
    kq = kernel_qp_for(spec)
    kq2 = kernel_qp_for(spec_probe) if spec_probe is not None else None
    relax, probe = fn(kq, kq2, binary_idx, q, hb, lbb, ubb, iters=iters,
                      probe_iters=probe_iters, warm=warm)
    bidx = _binaries(kq, binary_idx)[0]
    pv = torch.round(torch.clamp(
        torch.clamp(relax.x[:, bidx], lbb[:, bidx], ubb[:, bidx]), 0.0, 1.0))
    lb_p = lbb.clone()
    ub_p = ubb.clone()
    lb_p[:, bidx] = pv
    ub_p[:, bidx] = pv
    return relax, probe, lb_p, ub_p
