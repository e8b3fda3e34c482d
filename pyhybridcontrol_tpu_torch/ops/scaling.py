"""Constraint equilibration for the fixed-ρ ADMM kernel — host, float64.

Counterpart of ``pyhybridcontrol_tpu/ops/scaling.py`` (numpy, unchanged).

Scales  min ½xᵀPx + qᵀx  s.t. l ≤ Ax ≤ u  into

    x = D x̂,   P̂ = c·D P D,   q̂ = c·D q,   Â = E A D,
    l̂ = E l,   û = E u,        y = c⁻¹ E ŷ.

Default: **iterated row-only equilibration** (D = I, c = 1) — every row
of Â gets ~unit ∞-norm via a fixed-point sqrt iteration. Empirically
(double-integrator with tight state boxes AND soft-slack DEWH problems)
this is the robust choice for a *single fixed ρ* across all B&B nodes:

  * full OSQP Ruiz (columns + cost) equilibrates the KKT matrix but the
    column scaling distorts the box geometry B&B tightens (binary boxes
    become ellipsoids in x̂-space) and measurably stalls convergence on
    state-box-active MPC instances (400× worse residual at 300 iters);
  * plain 1-pass row scaling breaks on soft-slack/linear-binary blocks.

Column + cost scaling remain available behind flags for experimentation.
Rows whose norm is structurally zero (stage-0 state-box rows — constant
in V) keep scale 1: blowing them up poisons ÂᵀÂ and the shared KKT
inverse.
"""

from __future__ import annotations

import numpy as np


def ruiz_equilibrate(P: np.ndarray, A: np.ndarray, q: np.ndarray,
                     iters: int = 15, min_scale: float = 1e-4,
                     max_scale: float = 1e4,
                     scale_cols: bool = False,
                     scale_cost: bool = False):
    """Returns (D, E, c): column scales (n,), row scales (m,), cost scale."""
    n = P.shape[0]
    m = A.shape[0]
    D = np.ones(n)
    E = np.ones(m)
    c = 1.0
    for _ in range(iters):
        As = E[:, None] * A * D[None, :]
        row_norm = np.abs(As).max(axis=1, initial=0.0)
        e = np.where(row_norm > 1e-10,
                     1.0 / np.sqrt(np.clip(row_norm, 1e-12, None)), 1.0)
        E = np.clip(E * e, min_scale, max_scale)
        if scale_cols:
            Ps = c * (D[:, None] * P * D[None, :])
            As = E[:, None] * A * D[None, :]
            col_norm = np.maximum(np.abs(Ps).max(axis=0, initial=0.0),
                                  np.abs(As).max(axis=0, initial=0.0))
            d = np.where(col_norm > 1e-10,
                         1.0 / np.sqrt(np.clip(col_norm, 1e-12, None)), 1.0)
            D = np.clip(D * d, min_scale, max_scale)
        if scale_cost:
            Ps = c * (D[:, None] * P * D[None, :])
            qs = c * D * q
            denom = max(np.mean(np.abs(Ps).max(axis=0, initial=0.0)),
                        np.abs(qs).max(initial=0.0))
            c = float(np.clip(c / max(denom, 1e-12), 1e-6, 1e6))
    return D, E, c
