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
its launches in ``LAUNCHES`` (and their batch sizes in ``LAUNCH_BATCHES``).

K1's split-precision option (``low_frac``, the reference's ``iters_lo``
phase): the first ``int(iters * low_frac)`` iterations take each product
as the manual 3-pass bf16 product  A·b ≈ Ahi·bhi + Ahi·blo + Alo·bhi
(hi = bf16(a), lo = bf16(a − hi), fp32 accumulation). On the card that
phase is its own kernel on the tensor cores (``csrc/admm_mixed.cu``,
a tile of 16 problems per block); it hands its iterates to K1, which
runs the full-precision tail, the final half step and the stats. The
tensor-core tiles want nr and mGp in multiples of 16, so this path (plain
version and kernel alike) runs on a copy of the prep zero-padded from the
8 grain to 16 (``pad_kernel_qp``); zero rows and columns are inert.
``low_frac`` stays off the B&B path, as in the reference.

The plain versions keep the reference's public layout — q (B,n), h (B,m),
lb/ub (B,n) in, ``AdmmResult`` out — and iterate on the same padded
batch-first arrays the kernels read, so the two compare like with like. Stats reductions accumulate in float64
in both.
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

# launches per kernel wrapper (incremented only where the kernel launches)
LAUNCHES = {"admm_k1": 0, "admm_k2": 0, "admm_k1_mixed": 0}
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


def _result_from_stats(kq, x, zG, yG, zB, yB, st) -> AdmmResult:
    return _result(kq, x, zG, yG, zB, yB, st[:, 0], st[:, 1], st[:, 2],
                   st[:, 3], st[:, 4] > 0.5)


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


def _layout(kq: KernelQP):
    """Device constants in the kernels' layout: Â_G as (mGp, nr) and Mᵀ
    as (nr, mGp+nr), so neighbouring threads read neighbouring words, and
    the per-row vectors packed as [d_box, 1/d_box, ρ_B, 1/ρ_B, 1/E_B,
    1/(D·c) | ρ_G, 1/ρ_G, 1/E_G]."""
    lay = kq.cache.get("layout")
    if lay is None:
        vec = torch.cat([kq.dbox, kq.dbox_inv, kq.rhoB, kq.rhoB_inv,
                         kq.EB_inv, kq.Dc_inv, kq.rhoG, kq.rhoG_inv,
                         kq.EG_inv]).contiguous()
        lay = kq.cache["layout"] = dict(
            AG=kq.AGT.T.contiguous(), MT=kq.M.T.contiguous(),
            P=kq.P.contiguous(), vec=vec, cinv=float(kq.cinv))
    return lay


def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _check_launch(what: str, smem: int, kq, B, warm4, args):
    """Raise on what a kernel does not take: an empty batch, a shape whose
    constants do not fit in a block's shared memory (``smem`` bytes), or
    inputs that are not contiguous float32 CUDA tensors of the padded
    shapes."""
    nr, mGp = kq.n_pad, kq.m_pad
    if B < 1:
        raise ValueError(f"{what}: empty batch")
    if smem > SMEM_MAX:
        raise ValueError(
            f"{what}: nr={nr}, mGp={mGp} needs {smem} bytes of shared "
            f"memory per block, above the {SMEM_MAX} an sm_90 block has")
    names = ("q", "lG", "uG", "lB", "uB")
    for name, t, rows in zip(names, args, (nr, mGp, mGp, nr, nr)):
        _check(name, t, (B, rows))
    if warm4 is not None:
        for name, t, rows in zip(("z0G", "y0G", "z0B", "y0B"), warm4,
                                 (mGp, mGp, nr, nr)):
            _check(name, t, (B, rows))


def _outputs(kq, B, like):
    nr, mGp = kq.n_pad, kq.m_pad
    return [torch.empty((B, r), dtype=torch.float32, device=like.device)
            for r in (nr, mGp, mGp, nr, nr, 8)]


def _raise_on(lib, rc, what):
    if rc != 0:
        msg = lib.phc_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _launch_k1(kq: KernelQP, qs, lG, uG, lB, uB, warm4, iters: int):
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    lib = load_library()
    B = qs.shape[0]
    smem = lib.phc_admm_smem_bytes(kq.n_pad, kq.m_pad, 0, 0)
    _check_launch("ADMM kernel", smem, kq, B, warm4, (qs, lG, uG, lB, uB))
    lay = _layout(kq)
    outs = _outputs(kq, B, qs)
    w = warm4 if warm4 is not None else (None,) * 4
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        rc = lib.phc_admm_k1(
            *map(_ptr, (qs, lG, uG, lB, uB, *w, lay["AG"], lay["MT"],
                        lay["P"], lay["vec"], *outs)),
            B, kq.n_pad, kq.m_pad, int(iters), kq.base.alpha, lay["cinv"],
            ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K1 (admm_k1)")
    _count_launch("admm_k1", B)
    return outs


def _launch_k2(kq: KernelQP, kq2: Optional[KernelQP], binmask, qs, lG, uG,
               lB, uB, warm4, iters: int, probe_iters: int):
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    lib = load_library()
    B = qs.shape[0]
    p1, p2 = _split_probe(kq2, probe_iters)
    smem = lib.phc_admm_smem_bytes(kq.n_pad, kq.m_pad, 1, int(p1 > 0))
    _check_launch("ADMM kernel", smem, kq, B, warm4, (qs, lG, uG, lB, uB))
    _check("binmask", binmask, (kq.n_pad,))
    lay = _layout(kq)
    lay2 = _layout(kq2) if kq2 is not None else lay
    alpha2 = kq2.base.alpha if kq2 is not None else kq.base.alpha
    outs = _outputs(kq, B, qs) + _outputs(kq, B, qs)
    w = warm4 if warm4 is not None else (None,) * 4
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        rc = lib.phc_admm_k2(
            *map(_ptr, (qs, lG, uG, lB, uB, *w, lay["AG"], lay["MT"],
                        lay["P"], lay["vec"], binmask, lay2["MT"],
                        lay2["vec"], *outs)),
            B, kq.n_pad, kq.m_pad, int(iters), int(p1), int(p2),
            kq.base.alpha, alpha2, lay["cinv"], ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K2 (admm_k2)")
    _count_launch("admm_k2", B)
    return outs


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


def _launch_k1_mixed(kq: KernelQP, qs, lG, uG, lB, uB, warm4, iters_lo: int):
    """The split-precision phase on the tensor cores; returns the iterates
    (z_G, y_G, z_B, y_B) that warm-start K1's full-precision tail."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    lib = load_library("admm_mixed")
    nr, mGp = kq.n_pad, kq.m_pad
    B = qs.shape[0]
    if nr % MIXED_GRAIN or mGp % MIXED_GRAIN or min(nr, mGp) < MIXED_GRAIN:
        raise ValueError(
            f"split-precision ADMM kernel: nr={nr}, mGp={mGp} must be "
            f"multiples of {MIXED_GRAIN} (pad_kernel_qp)")
    _check_launch("split-precision ADMM kernel",
                  lib.phc_admm_mixed_smem_bytes(nr, mGp), kq, B, warm4,
                  (qs, lG, uG, lB, uB))
    lay, vec = _layout_mixed(kq), _layout(kq)["vec"]
    outs = [torch.empty((B, r), dtype=torch.float32, device=qs.device)
            for r in (mGp, mGp, nr, nr)]
    w = warm4 if warm4 is not None else (None,) * 4
    with torch.cuda.device(qs.device):
        stream = torch.cuda.current_stream(qs.device).cuda_stream
        rc = lib.phc_admm_k1_mixed(
            *map(_ptr, (qs, lG, uG, lB, uB, *w, *lay["A"], *lay["M"], vec,
                        *outs)),
            B, nr, mGp, int(iters_lo), kq.base.alpha,
            ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K1 split-precision phase (admm_k1_mixed)")
    _count_launch("admm_k1_mixed", B)
    return tuple(outs)


def admm_solve_cuda(kq: KernelQP, q, h, lb, ub, iters: int = 100,
                    warm=None, low_frac: float = 0.0) -> AdmmResult:
    """K1 on the card; same contract as ``admm_solve_plain``. With
    ``low_frac`` > 0 the leading iterations run in the split-precision
    tensor-core kernel, whose iterates warm-start K1 for the rest."""
    kq, iters_lo = _split_iters(kq, iters, low_frac)
    qs, lG, uG, lB, uB, warm4 = _pack(kq, q, h, lb, ub, warm)
    if iters_lo > 0:
        warm4 = _launch_k1_mixed(kq, qs, lG, uG, lB, uB, warm4, iters_lo)
    outs = _launch_k1(kq, qs, lG, uG, lB, uB, warm4,
                      max(iters - iters_lo, 0))
    return _result_from_stats(kq, *outs)


def admm_wave_cuda(kq: KernelQP, kq2: Optional[KernelQP], binary_idx,
                   q, h, lb, ub, iters: int = 100, probe_iters: int = 100,
                   warm=None):
    """K2 on the card; same contract as ``admm_wave_plain``."""
    qs, lG, uG, lB, uB, warm4 = _pack(kq, q, h, lb, ub, warm)
    outs = _launch_k2(kq, kq2, _binaries(kq, binary_idx)[1], qs, lG, uG,
                      lB, uB, warm4, iters, probe_iters)
    return (_result_from_stats(kq, *outs[:6]),
            _result_from_stats(kq, *outs[6:]))


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
        res = AdmmResult(**{k: v[0] for k, v in vars(res).items()})
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
