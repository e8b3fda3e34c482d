"""Batched ADMM QP solver (OSQP-style splitting), plain torch.

Counterpart of ``pyhybridcontrol_tpu/ops/admm.py``. Problem form:

    min ½ xᵀP x + qᵀx   s.t.   l ≤ A x ≤ u,   A = [G; I]

B&B nodes tighten only the box rows, so K = P + σI + ρ AᵀA is shared by
every node and inverted once on the host in float64 (``prepare_admm``).
``admm_solve`` is the σ-form iteration with an x-carry (used by rollout
repair and enumeration); the σ=0 batch form that the CUDA kernels run is
in ops/cuda_admm.py.

Port decisions:
- This module owns the solver, so it pins the float32 matmul precision
  at import: no TF32 anywhere (the Hopper twin of the reference's
  precision="highest" rule).
- The card has native fp64, so the certificate reductions (the OSQP
  infeasibility certificate's support/gap sums and the Falk bound's
  tangent sums) accumulate in float64; ``utils/dd.py`` and
  ``BoxQP.dd_cert`` are not ported.
- There is no ``pallas_mode``: kernel dispatch follows the tensor's
  device alone (ops/cuda_admm.py).
- ``BoxQP.precision`` is the reference's matmul precision of the
  iterations: "highest" exact fp32 products, "high" the 3-pass bf16
  product, "default" one bf16 pass. The reference's XLA takes them from
  the TPU's MXU; here the passes are made explicit (``bf16_product``): K1
  runs them in its split-precision phase on the card, and the σ-form
  ``admm_solve`` below emulates them in torch. The stats and certificates
  keep exact products.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.ops.scaling import ruiz_equilibrate
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

BIG = 1e30
RHO_EQ_SCALE = 10.0   # default ρ boost of binary box rows (equalities at leaves)
BOOST_SCALE = 30.0    # default ρ boost of big-M product rows
# bf16 passes a product takes at each matmul precision (0: exact fp32)
PRECISION_PASSES = {"highest": 0, "high": 3, "default": 1}


def bf16_split(a):
    """fp32 → (hi, lo), both bf16 values held in fp32: hi = bf16(a),
    lo = bf16(a − hi); hi + lo ≈ a to ~16 mantissa bits."""
    hi = a.bfloat16().float()
    return hi, (a - hi).bfloat16().float()


def bf16_product(A, passes: int):
    """b ↦ b·A as ``passes`` bf16 passes with fp32 accumulation: 3 is
    bhi·Ahi + blo·Ahi + bhi·Alo (the lo·lo term is below fp32 rounding),
    1 is bhi·Ahi alone. bf16 × bf16 is exact in fp32, so fp32 ``@`` of the
    rounded operands accumulates what the tensor cores accumulate. The
    constant is split once, the iterate operand at each call."""
    if passes not in (1, 3):
        raise ValueError(f"bf16_product: 1 or 3 passes, got {passes}")
    Ahi, Alo = bf16_split(A)
    if passes == 1:
        return lambda b: b.bfloat16().float() @ Ahi

    def mm(b):
        bhi, blo = bf16_split(b)
        return bhi @ Ahi + blo @ Ahi + bhi @ Alo
    return mm


@dataclasses.dataclass
class BoxQP:
    """Prepared ADMM problem data: Ruiz-scaled P̂, Â, K⁻¹ and the D/E/c
    scalings as fp32 tensors on one device. Per-solve data (q, h, lb, ub)
    is passed in ORIGINAL units and scaled on the fly."""

    P: torch.Tensor          # (n, n) scaled quadratic  P̂ = c·DPD
    A: torch.Tensor          # (m̄, n) scaled stacked constraints  Â = E[A]D
    Kinv: torch.Tensor       # (n, n) inverse of P̂ + σI + ρ ÂᵀÂ
    D: torch.Tensor          # (n,) column scaling, x = D x̂
    E: torch.Tensor          # (m̄,) row scaling over [G; I]
    cost_scale: torch.Tensor  # () scalar c
    rho_vec: torch.Tensor    # (m̄,) per-row ρ
    rho: float
    sigma: float
    alpha: float
    m_ineq: int              # rows of G
    # matmul precision of the iterations (PRECISION_PASSES): "highest"
    # exact fp32, "high" 3-pass bf16, "default" 1-pass bf16
    precision: str = "highest"
    # accepted for the reference's signature; the certificate sums are
    # float64 whatever its value (the card has fp64)
    dd_cert: bool = False
    # derived per-spec data (the kernel prep of ops/cuda_admm.py)
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def n(self) -> int:
        return self.P.shape[-1]

    @property
    def m_total(self) -> int:
        return self.A.shape[-2]

    @property
    def device(self) -> torch.device:
        return self.P.device


@dataclasses.dataclass
class AdmmResult:
    x: torch.Tensor          # (..., n) primal solution (original units)
    obj: torch.Tensor        # (...,) ½xᵀPx + qᵀx
    r_prim: torch.Tensor     # (...,) ∞-norm primal residual (original units)
    r_prim_rel: torch.Tensor  # (...,) per-row relative primal residual
    r_dual: torch.Tensor     # (...,) ∞-norm dual residual
    infeas_cert: torch.Tensor  # (...,) bool — OSQP primal-infeasibility
    #   certificate from the last dual step δy
    y: torch.Tensor          # (..., m̄) dual (scaled) — for warm starts
    z: torch.Tensor          # (..., m̄)
    # the stagewise frame's horizon-coupled extra rows (ops/stagewise.py)
    z_ext: Optional[torch.Tensor] = None   # (..., r)
    y_ext: Optional[torch.Tensor] = None   # (..., r)


def prepare_admm(G: np.ndarray, H: np.ndarray, *, rho: float = 1.0,
                 sigma: float = 1e-6, alpha: float = 1.6,
                 q_typical: Optional[np.ndarray] = None,
                 binary_idx=None, rho_eq_scale: float = RHO_EQ_SCALE,
                 boost_rows=None, boost_scale: float = BOOST_SCALE,
                 eq_rows=None, precision: str = "highest",
                 dd_cert: bool = False, device=DEFAULT_DEVICE) -> BoxQP:
    """Host-side (float64) preparation: Ruiz equilibration + K⁻¹.

    ``binary_idx``: box rows of those variables get ρ·rho_eq_scale (they
    turn into equalities at fixed-binary B&B nodes). ``eq_rows``:
    constraint rows that are true equalities (the consensus tree's
    selector rows), the same boost. ``boost_rows``: near-equality big-M
    product rows, ×boost_scale. ``precision``: the matmul precision of the
    iterations (``BoxQP.precision``). ``dd_cert`` is accepted and changes
    nothing: both values give the same float64 certificate sums.
    """
    if precision not in PRECISION_PASSES:
        raise ValueError(f"unknown precision {precision!r} (have "
                         f"{tuple(PRECISION_PASSES)})")
    device = resolve_device(device)
    G = np.asarray(G, dtype=np.float64)
    H = np.asarray(H, dtype=np.float64)
    m, n = G.shape
    A = np.vstack([G, np.eye(n)])
    q0 = (np.zeros(n) if q_typical is None
          else np.asarray(q_typical, np.float64))
    D, E, c = ruiz_equilibrate(H, A, q0)
    Ph = c * (D[:, None] * H * D[None, :])
    Ah = E[:, None] * A * D[None, :]
    rho_vec = np.full(m + n, float(rho))
    if binary_idx is not None and len(binary_idx):
        rho_vec[m + np.asarray(binary_idx, int)] = rho * rho_eq_scale
    if eq_rows is not None and len(eq_rows):
        rho_vec[np.asarray(eq_rows, int)] = rho * rho_eq_scale
    if boost_rows is not None and len(boost_rows):
        rho_vec[np.asarray(boost_rows, int)] *= boost_scale
    K = Ph + sigma * np.eye(n) + (Ah.T * rho_vec[None, :]) @ Ah
    Kinv = np.linalg.inv(K)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    return BoxQP(P=t(Ph), A=t(Ah), Kinv=t(Kinv), D=t(D), E=t(E),
                 cost_scale=t(c), rho_vec=t(rho_vec),
                 rho=float(rho), sigma=float(sigma), alpha=float(alpha),
                 m_ineq=m, precision=precision, dd_cert=bool(dd_cert))


def prepare_admm_mpc(cmpc, **kw) -> BoxQP:
    """Prepare the ADMM data for a condensed MPC problem. The typical
    linear term (f at x0=0) informs the Ruiz cost normalization."""
    kw.setdefault("q_typical", cmpc.f0)
    kw.setdefault("binary_idx", cmpc.binary_idx)
    kw.setdefault("boost_rows", getattr(cmpc, "z_rows", None))
    return prepare_admm(cmpc.G, cmpc.H, **kw)


def _bounds(spec: BoxQP, h, lb, ub):
    """Stacked, Ruiz-row-scaled [l̂, û]: constraint block + box block."""
    m = spec.m_ineq
    batch = torch.broadcast_shapes(h.shape[:-1], lb.shape[:-1],
                                   ub.shape[:-1])
    h = h.expand(batch + h.shape[-1:])
    lb = lb.expand(batch + lb.shape[-1:])
    ub = ub.expand(batch + ub.shape[-1:])
    l = torch.cat([torch.full(batch + (m,), -BIG, dtype=h.dtype,
                              device=h.device),
                   torch.clamp(lb * spec.E[m:], -BIG, BIG)], dim=-1)
    u = torch.cat([h * spec.E[:m],
                   torch.clamp(ub * spec.E[m:], -BIG, BIG)], dim=-1)
    return l, u


def infeasibility_certificate(dy, Atdy, l, u):
    """OSQP §3.4 primal-infeasibility certificate from the last dual step
    δy (scaled frame): Aᵀδy ≈ 0 ∧ supp(δy) respects the infinite bounds
    ∧ uᵀ[δy]₊ + lᵀ[δy]₋ < 0. ``Atdy`` is ‖Aᵀδy‖∞; the support and gap sums
    accumulate in float64."""
    dy_norm = dy.abs().amax(dim=-1).double()
    fin_u = u < 0.9 * BIG
    fin_l = l > -0.9 * BIG
    dyp = torch.clamp_min(dy, 0.0).double()
    dyn_ = torch.clamp_max(dy, 0.0).double()
    support = (torch.where(~fin_u, dyp, 0.0).sum(-1)
               + torch.where(~fin_l, -dyn_, 0.0).sum(-1))
    gap_term = (torch.where(fin_u, u.double() * dyp, 0.0).sum(-1)
                + torch.where(fin_l, l.double() * dyn_, 0.0).sum(-1))
    eps_c = 1e-4
    return ((dy_norm > 1e-12)
            & (Atdy.double() <= eps_c * dy_norm)
            & (support <= eps_c * dy_norm)
            & (gap_term <= -eps_c * dy_norm))


def admm_solve(spec: BoxQP, q, h, lb, ub, iters: int = 100,
               warm: Optional[Tuple[torch.Tensor, ...]] = None
               ) -> AdmmResult:
    """Solve one (or a leading batch of) box-QPs with ``iters`` fixed
    σ-form ADMM iterations. Inputs in ORIGINAL units; q/h/lb/ub may carry
    identical leading batch dims. ``x``/``obj``/residuals are returned in
    original units, ``y``/``z`` in the scaled frame (reuse only as
    ``warm``, which is ``(res.x, res.z, res.y)`` of a previous result).
    The iterations take their products at ``spec.precision``."""
    rho, alpha, sigma = spec.rho_vec, spec.alpha, spec.sigma
    c = spec.cost_scale
    qh = c * spec.D * q
    l, u = _bounds(spec, h, lb, ub)
    batch = torch.broadcast_shapes(qh.shape[:-1], l.shape[:-1])
    n, mt = spec.n, spec.m_total
    if warm is None:
        x = qh.new_zeros(batch + (n,))
        z = torch.clamp(qh.new_zeros(batch + (mt,)), l, u)
        y = qh.new_zeros(batch + (mt,))
    else:
        x0w, z0w, y0w = warm
        x = x0w / spec.D
        z = torch.clamp(z0w, l, u)
        y = y0w

    A, AT, KinvT = spec.A, spec.A.T, spec.Kinv.T
    passes = PRECISION_PASSES[spec.precision]
    if passes:
        mmA, mmK, mmAT = (bf16_product(M, passes) for M in (A, KinvT, AT))
    else:
        def mmA(w):
            return w @ A

        def mmK(v):
            return v @ KinvT

        def mmAT(v):
            return v @ AT
    dy = torch.zeros_like(y)
    for _ in range(iters):
        w = rho * z - y
        xt = mmK(sigma * x - qh + mmA(w))
        zt = mmAT(xt)
        zr = alpha * zt + (1.0 - alpha) * z
        z_new = torch.clamp(zr + y / rho, l, u)
        y_new = y + rho * (zr - z_new)
        dy = y_new - y
        x, z, y = xt, z_new, y_new

    # residuals/objective unscaled back to original units
    Ax = x @ AT
    Ax_orig = Ax / spec.E
    viol = torch.abs(Ax - torch.clamp(Ax, l, u)) / spec.E
    r_prim = viol.amax(dim=-1)
    # per-ROW relative violation
    r_rel = (viol / torch.clamp_min(Ax_orig.abs(), 1.0)).amax(dim=-1)
    Px = x @ spec.P.T
    dual = (Px + qh + y @ A) / (spec.D * c)
    r_dual = dual.abs().amax(dim=-1)
    obj = ((0.5 * (x.double() * Px.double()).sum(-1)
            + (qh.double() * x.double()).sum(-1)) / c.double()).float()
    cert = infeasibility_certificate(dy, (dy @ A).abs().amax(dim=-1), l, u)
    return AdmmResult(x=spec.D * x, obj=obj, r_prim=r_prim,
                      r_prim_rel=r_rel, r_dual=r_dual,
                      infeas_cert=cert, y=y, z=z)


def admm_dual_bound(spec: BoxQP, q, h, lb, ub, res: AdmmResult):
    """CERTIFIED lower bound on the box-QP optimum from the final ADMM
    iterate — valid for ANY iterate (Falk-style partial dualization of the
    G rows with ŷ_G ≥ 0, inner box-QP underestimated by its tangent at
    x̄):

        p* ≥ −ŷ_Gᵀû_G + f₀(x̄) + Σᵢ min ∇ᵢ·(x′ᵢ − x̄ᵢ)  over x′∈[lb,ub]

    Returns the bound in ORIGINAL units, same leading batch as res.obj;
    −BIG-scale for variables unbounded on the descending side (the B&B
    falls back to the parent bound on non-finite certs)."""
    return _falk_cert(spec, q, h, lb, ub, res)[0]


def _falk_cert(spec: BoxQP, q, h, lb, ub, res: AdmmResult,
               binary_idx=None):
    """Shared Falk-cert computation (see ``admm_dual_bound``). Returns
    ``(bound, extras)``; extras is the per-binary node-presolve tuple of
    ``admm_node_cert`` when ``binary_idx`` is given, else None. The
    tangent reductions accumulate in float64."""
    c = spec.cost_scale
    qh = c * spec.D * q
    m = spec.m_ineq
    xh = res.x / spec.D

    # G-row duals: l=−BIG one-sided rows, so clamping at 0 is valid
    yG = torch.clamp_min(res.y[..., :m], 0.0)
    uG = h * spec.E[:m]
    dirv = yG @ spec.A[:m]
    Px = xh @ spec.P.T
    lbh = torch.clamp(lb / spec.D, -BIG, BIG)
    ubh = torch.clamp(ub / spec.D, -BIG, BIG)
    lbh, ubh = _implied_box(spec.A[:m], uG, lbh, ubh, passes=2)

    def rdot(u_, v_):
        return (u_.double() * v_.double()).sum(-1)

    # dual line search over α·y_G (valid for every α ≥ 0)
    f0q = 0.5 * rdot(xh, Px)
    S1 = rdot(yG, uG)
    bound = grad = used = None
    for a in (0.0, 0.5, 1.0):
        w_a = qh + a * dirv if a else qh
        grad_a = Px + w_a
        used_a = torch.minimum(grad_a * (lbh - xh), grad_a * (ubh - xh))
        bound_a = ((f0q + rdot(w_a, xh) + used_a.double().sum(-1)
                    - a * S1) / c.double()).float()
        if bound is None:
            bound, grad, used = bound_a, grad_a, used_a
        else:
            take = bound_a > bound
            bound = torch.where(take, bound_a, bound)
            grad = torch.where(take[..., None], grad_a, grad)
            used = torch.where(take[..., None], used_a, used)
    if binary_idx is None:
        return bound, None
    bidx = torch.as_tensor(binary_idx, dtype=torch.long, device=xh.device)
    Db = spec.D[bidx]
    gb = grad[..., bidx]
    xb = xh[..., bidx]
    ub_used = used[..., bidx]
    # tangent-retained integral side, and the certified objective DELTA
    # of forcing the binary to the other side (reduced-cost fixing)
    retain = (gb < 0.0).to(res.x.dtype)
    flipval = (1.0 - retain) / Db
    flip_delta = (gb * (flipval - xb) - ub_used) / c
    # implied binary box back in 0/1 units (implied-integrality fixing)
    imp_lo = lbh[..., bidx] * Db
    imp_hi = ubh[..., bidx] * Db
    return bound, (flip_delta, retain, imp_lo, imp_hi)


def admm_node_cert(spec: BoxQP, q, h, lb, ub, res: AdmmResult,
                   binary_idx):
    """Falk cert plus per-binary node-presolve data:
    ``(bound, flip_delta, retain_side, imp_lo, imp_hi)`` with res.obj's
    leading batch plus a trailing (nb,) axis (see the reference's
    ``admm_node_cert`` for the fixing rules these feed)."""
    bound, extras = _falk_cert(spec, q, h, lb, ub, res,
                               binary_idx=binary_idx)
    return (bound,) + extras


def _implied_box(A, u, lbh, ubh, passes: int = 2):
    """Implied variable bounds from one-sided rows  A x ≤ u  plus the
    current box — MIP-presolve interval tightening (u/lbh/ubh may carry
    leading batch dims). Unbounded contributors (|·| ≥ 1e8) are tracked
    apart from the finite sum so that u_i is never absorbed; a column
    tightens only when every other contributor of its row is finite."""
    Ap = torch.clamp_min(A, 0.0)
    An = torch.clamp_max(A, 0.0)
    eps = 1e-6
    pos = A > eps
    neg = A < -eps
    A_pos = torch.where(pos, A, 1.0)
    A_neg = torch.where(neg, A, -1.0)
    for _ in range(passes):
        contrib = torch.clamp(Ap * lbh[..., None, :] + An * ubh[..., None, :],
                              -BIG, BIG)
        big = contrib.abs() >= 1e8
        fin = torch.where(big, 0.0, contrib)
        fin_sum = fin.sum(-1)                                # (..., m)
        abs_sum = fin.abs().sum(-1)
        nbig = big.sum(-1)                                   # (..., m)
        others_fin = (nbig[..., :, None] - big.long()) == 0
        # conservative slack ≫ fp32 summation error: rounding may only
        # loosen the implied bound
        safety = 1e-5 * abs_sum + 1e-6 * u.abs()
        avail = torch.where(
            others_fin,
            u[..., :, None] - (fin_sum[..., :, None] - fin)
            + safety[..., :, None],
            BIG)
        ub_cand = torch.where(pos & others_fin, avail / A_pos, BIG)
        lb_cand = torch.where(neg & others_fin, avail / A_neg, -BIG)
        ubh = torch.minimum(ubh, torch.clamp(ub_cand.amin(dim=-2), -BIG, BIG))
        lbh = torch.maximum(lbh, torch.clamp(lb_cand.amax(dim=-2), -BIG, BIG))
    return lbh, ubh


def admm_solve_batch(spec: BoxQP, q, h, lb, ub, iters: int = 100
                     ) -> AdmmResult:
    """Explicit-batch convenience: q (B,n) or (n,), h (B,m) or (m,),
    lb/ub (B,n); a 1-D q or h is broadcast to lb's batch. Batched σ=0
    ADMM through ``ops.cuda_admm.admm_solve_auto``: K1 on a CUDA tensor,
    its plain version on a CPU tensor."""
    from pyhybridcontrol_tpu_torch.ops.cuda_admm import admm_solve_auto

    B = lb.shape[0]
    qb = q.expand(B, q.shape[-1]) if q.ndim == 1 else q
    hb = h.expand(B, h.shape[-1]) if h.ndim == 1 else h
    return admm_solve_auto(spec, qb, hb, lb, ub, iters=iters)


def admm_solve_mixed(spec: BoxQP, q, h, lb, ub, iters: int = 100,
                     low_frac: float = 0.8, low_precision: str = "high",
                     warm=None) -> AdmmResult:
    """Two-phase precision schedule: the first ``k = int(iters·low_frac)``
    iterations at ``low_precision`` ("high": 3-pass bf16 products,
    "default": one pass), the tail at the spec's own precision,
    warm-chained; ``k ≤ 0`` or ``k ≥ iters`` is one solve at the spec's
    precision, as in the reference. Batched σ=0 ADMM as
    ``ops.cuda_admm.admm_solve_auto``: where the spec is at "highest" the
    schedule is ONE K1 call with ``iters_lo = k`` (the split phase on the
    tensor cores up to N=21, K1's split mode above), which equals the
    reference's two chained solves because the σ=0 iteration carries no
    x; where the spec itself is split, two calls, chained on (z, y)."""
    from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
        _solve_auto, admm_solve_auto)

    if low_precision not in PRECISION_PASSES:
        raise ValueError(f"unknown low_precision {low_precision!r} (have "
                         f"{tuple(PRECISION_PASSES)})")
    k = int(iters * low_frac)
    lo = PRECISION_PASSES[low_precision]
    hi = PRECISION_PASSES[spec.precision]
    if k <= 0 or k >= iters or lo == hi:
        return admm_solve_auto(spec, q, h, lb, ub, iters=iters, warm=warm)
    if hi == 0:
        return _solve_auto(spec, q, h, lb, ub, iters, warm, low_frac, lo)
    r1 = _solve_auto(spec, q, h, lb, ub, k, warm, 1.0 if lo else 0.0,
                     lo or 3)
    return admm_solve_auto(spec, q, h, lb, ub, iters=iters - k,
                           warm=(r1.x, r1.z, r1.y))
