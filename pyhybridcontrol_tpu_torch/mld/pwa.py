"""Generic PWA → MLD conversion (big-M or convex hull), after Bemporad &
Morari 1999 §3.

Counterpart of ``pyhybridcontrol_tpu/mld/pwa.py``: the same float64
numpy code, row for row, so both packages convert a PWA system to
the same MLD matrices.

A PWA system is a list of regions i = 1..M:

    x⁺ = A_i x + B_i u + c_i   whenever   S_i x + R_i u ≤ T_i,

with the operating set bounded by a box  x_lb ≤ x ≤ x_ub, u_lb ≤ u ≤ u_ub
(big-M validity requires bounded operation). Encoding:

  * one binary δ_i per region with  Σ_i δ_i = 1  (two ≤ rows),
  * region guard:  S_i x + R_i u − T_i ≤ M_i (1 − δ_i)   with M_i the row
    max of the guard over the box (interval arithmetic),
  * per-region auxiliary  z_i = δ_i · (A_i x + B_i u + c_i) ∈ ℝ^{nx}
    via the four standard big-M product rows, so  x⁺ = Σ_i z_i,
  * the box itself is appended as constraint rows (it is load-bearing —
    it makes every big-M finite).

Conversion is exact on the box: for any (x,u) in exactly one region the
unique feasible (δ, z) reproduces the PWA successor state.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel


@dataclasses.dataclass
class PwaRegion:
    A: np.ndarray
    B: np.ndarray
    c: np.ndarray          # (nx,)
    S: np.ndarray          # guard: S x + R u ≤ T
    R: np.ndarray
    T: np.ndarray          # (ng,)


@dataclasses.dataclass
class PwaSystem:
    regions: List[PwaRegion]
    x_lb: np.ndarray
    x_ub: np.ndarray
    u_lb: np.ndarray
    u_ub: np.ndarray
    u_types: Optional[Sequence[str]] = None

    @property
    def nx(self):
        return self.regions[0].A.shape[0]

    @property
    def nu(self):
        return self.regions[0].B.shape[1]

    def simulate_step(self, x, u):
        """Host-side exact PWA step (region lookup) — test oracle."""
        for reg in self.regions:
            if np.all(reg.S @ x + reg.R @ u <= reg.T + 1e-9):
                return reg.A @ x + reg.B @ u + reg.c
        raise ValueError("state/input not in any PWA region")


def _interval_bounds(W, lb, ub):
    """Componentwise [min, max] of W @ v over lb ≤ v ≤ ub."""
    Wp = np.maximum(W, 0.0)
    Wn = np.minimum(W, 0.0)
    lo = Wp @ lb + Wn @ ub
    hi = Wp @ ub + Wn @ lb
    return lo, hi


def pwa_to_mld(sys: PwaSystem, big_m_margin: float = 1e-6,
               formulation: str = "bigm") -> MldModel:
    """Convert a PWA system to an equivalent MldModel (exact on the box).

    ``formulation``:

    - ``"bigm"`` — the module-docstring encoding (Bemporad–Morari §3):
      M·nx auxiliaries, few rows, but the QP relaxation is structurally
      LOOSE (pwa_spring root bound 0.0 against an optimum of ~73–83):
      fractional δ lets the big-M product rows vanish, so no dual bound
      can prune and B&B trees are near-exhaustive.
    - ``"hull"`` — the disaggregated/multiple-choice encoding (Balas
      disjunctive hull; locally IDEAL: each step's relaxation is the
      convex hull of the region disjunction). Per-region copies
      v_i = (v_i^x, v_i^u) with  x = Σ v_i^x,  u = Σ v_i^u,
      S_i v_i^x + R_i v_i^u ≤ T_i δ_i,  box·δ_i bounds per copy, and
      x⁺ = Σ_i (A_i v_i^x + B_i v_i^u + c_i δ_i).  M·(nx+nu)
      auxiliaries — more columns, radically tighter relaxations.
    """
    if formulation == "hull":
        return _pwa_to_mld_hull(sys)
    if formulation != "bigm":
        raise ValueError(f"unknown formulation {formulation!r}")
    M = len(sys.regions)
    nx, nu = sys.nx, sys.nu
    ndelta = M
    nz = M * nx

    rows_E, rows_F1, rows_F2, rows_F3, rows_f5 = [], [], [], [], []

    def add_row(E=None, F1=None, F2=None, F3=None, f5=0.0):
        rows_E.append(np.zeros(nx) if E is None else np.asarray(E, float))
        rows_F1.append(np.zeros(nu) if F1 is None else np.asarray(F1, float))
        rows_F2.append(np.zeros(ndelta) if F2 is None else np.asarray(F2, float))
        rows_F3.append(np.zeros(nz) if F3 is None else np.asarray(F3, float))
        rows_f5.append(float(f5))

    # Σ δ_i = 1  →  Σδ ≤ 1 and −Σδ ≤ −1
    add_row(F2=np.ones(ndelta), f5=1.0)
    add_row(F2=-np.ones(ndelta), f5=-1.0)

    # operating box on x and u
    for j in range(nx):
        e = np.zeros(nx); e[j] = 1.0
        add_row(E=e, f5=sys.x_ub[j])
        add_row(E=-e, f5=-sys.x_lb[j])
    for j in range(nu):
        e = np.zeros(nu); e[j] = 1.0
        add_row(F1=e, f5=sys.u_ub[j])
        add_row(F1=-e, f5=-sys.u_lb[j])

    for i, reg in enumerate(sys.regions):
        zsl = slice(i * nx, (i + 1) * nx)
        ei = np.zeros(ndelta); ei[i] = 1.0

        # guard rows: S x + R u − T ≤ Mg (1 − δ_i)
        G = np.hstack([reg.S, reg.R])
        _, g_hi = _interval_bounds(
            G, np.concatenate([sys.x_lb, sys.u_lb]),
            np.concatenate([sys.x_ub, sys.u_ub]))
        Mg = g_hi - reg.T + big_m_margin
        Mg = np.maximum(Mg, 0.0)
        for r in range(reg.S.shape[0]):
            add_row(E=reg.S[r], F1=reg.R[r], F2=Mg[r] * ei,
                    f5=reg.T[r] + Mg[r])

        # w_i(x,u) = A_i x + B_i u + c_i, bounds over the box
        Wab = np.hstack([reg.A, reg.B])
        lo, hi = _interval_bounds(
            Wab, np.concatenate([sys.x_lb, sys.u_lb]),
            np.concatenate([sys.x_ub, sys.u_ub]))
        L = lo + reg.c - big_m_margin
        U = hi + reg.c + big_m_margin

        for j in range(nx):
            zj = np.zeros(nz); zj[zsl][j] = 1.0
            a, b, c = reg.A[j], reg.B[j], reg.c[j]
            # z ≤ U δ
            add_row(F2=-U[j] * ei, F3=zj, f5=0.0)
            # z ≥ L δ   →  −z + L δ ≤ 0
            add_row(F2=L[j] * ei, F3=-zj, f5=0.0)
            # z ≤ w − L(1−δ)  →  z − w − L δ ≤ −L
            add_row(E=-a, F1=-b, F2=-L[j] * ei, F3=zj, f5=c - L[j])
            # z ≥ w − U(1−δ)  →  w − z − U δ ≤ U... : −z + w + U δ ≤ U... sign:
            # w − U(1−δ) ≤ z  →  w − z − Uδ ≤ −... compute: A x + B u + c − U + Uδ ≤ z
            add_row(E=a, F1=b, F2=U[j] * ei, F3=-zj, f5=U[j] - c)

    # dynamics: x⁺ = Σ_i z_i  →  B3 = [I I … I]
    B3 = np.hstack([np.eye(nx)] * M)

    info = MldInfo(nx=nx, nu=nu, ndelta=ndelta, nz=nz, nomega=0, ny=nx,
                   ncons=len(rows_f5),
                   u_types=tuple(sys.u_types) if sys.u_types else ("c",) * nu)
    return MldModel.from_matrices(
        info,
        A=np.zeros((nx, nx)), B3=B3, C=np.eye(nx),
        E=np.stack(rows_E), F1=np.stack(rows_F1), F2=np.stack(rows_F2),
        F3=np.stack(rows_F3), f5=np.asarray(rows_f5),
    )


def _pwa_to_mld_hull(sys: PwaSystem) -> MldModel:
    """Disaggregated (convex-hull) PWA→MLD — see ``pwa_to_mld``.

    Exactness at integral δ: δ_i = 1 forces v_j = 0 for j ≠ i (copy
    boxes scale with δ_j), so the aggregation rows give v_i = (x, u),
    the guard reduces to S_i x + R_i u ≤ T_i, and the dynamics row
    reduces to x⁺ = A_i x + B_i u + c_i. No big-M appears anywhere —
    every row is homogeneous in (v_i, δ_i) — which is exactly why the
    relaxation is the per-step convex hull (Balas): fractional δ can
    only mix points that are feasible for some region."""
    M = len(sys.regions)
    nx, nu = sys.nx, sys.nu
    b = nx + nu                      # copy block size
    ndelta = M
    nz = M * b

    rows_E, rows_F1, rows_F2, rows_F3, rows_f5 = [], [], [], [], []

    def add_row(E=None, F1=None, F2=None, F3=None, f5=0.0):
        rows_E.append(np.zeros(nx) if E is None else np.asarray(E, float))
        rows_F1.append(np.zeros(nu) if F1 is None
                       else np.asarray(F1, float))
        rows_F2.append(np.zeros(ndelta) if F2 is None
                       else np.asarray(F2, float))
        rows_F3.append(np.zeros(nz) if F3 is None
                       else np.asarray(F3, float))
        rows_f5.append(float(f5))

    # Σ δ_i = 1
    add_row(F2=np.ones(ndelta), f5=1.0)
    add_row(F2=-np.ones(ndelta), f5=-1.0)

    # operating box on x and u (kept explicit: the condensed QP's
    # device-side implied-box pass starts from these rows)
    for j in range(nx):
        e = np.zeros(nx); e[j] = 1.0
        add_row(E=e, f5=sys.x_ub[j])
        add_row(E=-e, f5=-sys.x_lb[j])
    for j in range(nu):
        e = np.zeros(nu); e[j] = 1.0
        add_row(F1=e, f5=sys.u_ub[j])
        add_row(F1=-e, f5=-sys.u_lb[j])

    def sel(i, j):
        v = np.zeros(nz); v[i * b + j] = 1.0
        return v

    # aggregation: x_j = Σ_i v_i^x[j], u_j = Σ_i v_i^u[j]
    for j in range(nx):
        e = np.zeros(nx); e[j] = 1.0
        agg = np.zeros(nz)
        for i in range(M):
            agg[i * b + j] = 1.0
        add_row(E=e, F3=-agg, f5=0.0)
        add_row(E=-e, F3=agg, f5=0.0)
    for j in range(nu):
        e = np.zeros(nu); e[j] = 1.0
        agg = np.zeros(nz)
        for i in range(M):
            agg[i * b + nx + j] = 1.0
        add_row(F1=e, F3=-agg, f5=0.0)
        add_row(F1=-e, F3=agg, f5=0.0)

    for i, reg in enumerate(sys.regions):
        ei = np.zeros(ndelta); ei[i] = 1.0
        # guard on the copy:  S_i v^x + R_i v^u − T_i δ_i ≤ 0
        for r in range(reg.S.shape[0]):
            F3r = np.zeros(nz)
            F3r[i * b : i * b + nx] = reg.S[r]
            F3r[i * b + nx : (i + 1) * b] = reg.R[r]
            add_row(F2=-reg.T[r] * ei, F3=F3r, f5=0.0)
        # copy boxes:  lb·δ_i ≤ v_i ≤ ub·δ_i
        lo = np.concatenate([sys.x_lb, sys.u_lb])
        hi = np.concatenate([sys.x_ub, sys.u_ub])
        for j in range(b):
            add_row(F2=-hi[j] * ei, F3=sel(i, j), f5=0.0)
            add_row(F2=lo[j] * ei, F3=-sel(i, j), f5=0.0)

    # dynamics: x⁺ = Σ_i (A_i v_i^x + B_i v_i^u + c_i δ_i)
    B3 = np.hstack([np.hstack([reg.A, reg.B]) for reg in sys.regions])
    B2 = np.stack([reg.c for reg in sys.regions], axis=1)

    info = MldInfo(nx=nx, nu=nu, ndelta=ndelta, nz=nz, nomega=0, ny=nx,
                   ncons=len(rows_f5),
                   u_types=(tuple(sys.u_types) if sys.u_types
                            else ("c",) * nu))
    return MldModel.from_matrices(
        info,
        A=np.zeros((nx, nx)), B2=B2, B3=B3, C=np.eye(nx),
        E=np.stack(rows_E), F1=np.stack(rows_F1), F2=np.stack(rows_F2),
        F3=np.stack(rows_F3), f5=np.asarray(rows_f5),
    )
