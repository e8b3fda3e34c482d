"""Exact host oracles (numpy float64) — ground truth for parity tests.

Counterpart of ``pyhybridcontrol_tpu/solver/oracle.py``: the same
numpy code, on the port's own ``ops/scaling.py`` and scipy's HiGHS
``linprog``:

  * ``solve_qp_oracle``: strictly convex QP via an infeasible-start
    primal-dual interior-point method (Mehrotra predictor-corrector),
    float64, KKT solves by dense LU. Small problems only (oracle path).
  * ``solve_miqp_enumeration_oracle``: exact MIQP by enumerating all 2^nb
    binary assignments, reducing each to a continuous QP.

The reference's optional ``cvxpy_cross_check`` is left out: it needs
cvxpy, which neither this package nor its tests depend on.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import numpy as np

from pyhybridcontrol_tpu_torch.ops.scaling import ruiz_equilibrate

INF = np.inf


@dataclasses.dataclass
class OracleResult:
    x: Optional[np.ndarray]
    obj: float
    status: str                  # "optimal" | "infeasible" | "failed"
    binaries: Optional[np.ndarray] = None


def _stack_constraints(G, h, lb, ub):
    """[G; I; −I] x ≤ [h; ub; −lb] with infinite bounds dropped."""
    n = len(lb)
    rows = [G]
    rhs = [h]
    fin_ub = np.isfinite(ub) & (ub < 1e29)
    fin_lb = np.isfinite(lb) & (lb > -1e29)
    if fin_ub.any():
        rows.append(np.eye(n)[fin_ub])
        rhs.append(ub[fin_ub])
    if fin_lb.any():
        rows.append(-np.eye(n)[fin_lb])
        rhs.append(-lb[fin_lb])
    return np.vstack(rows), np.concatenate(rhs)


def solve_qp_oracle(H, f, G=None, h=None, lb=None, ub=None,
                    tol: float = 1e-8, max_iter: int = 20000) -> OracleResult:
    """min ½xᵀHx + fᵀx  s.t. Gx ≤ h, lb ≤ x ≤ ub  (H ≻ 0), float64.

    Method: OSQP-style ADMM in float64 with adaptive ρ, then an
    *active-set polish* — an exact KKT solve on the tight constraints —
    verified against feasibility + stationarity. Fixed binaries from the
    MIQP enumeration create implied equalities (e.g. z ≤ 0 ∧ −z ≤ 0),
    which have empty interior and defeat interior-point methods (no
    Slater point); ADMM + polish handles them exactly. Infeasible
    problems are classified with a HiGHS LP feasibility check.
    """
    H = np.asarray(H, np.float64)
    f = np.asarray(f, np.float64)
    n = len(f)
    if G is None:
        G = np.zeros((0, n))
        h = np.zeros(0)
    lb = np.full(n, -INF) if lb is None else np.asarray(lb, np.float64)
    ub = np.full(n, INF) if ub is None else np.asarray(ub, np.float64)
    G = np.asarray(G, np.float64)
    h = np.asarray(h, np.float64)

    if n == 0:
        # fully-fixed problem (e.g. enumeration of an all-binary model):
        # just a feasibility check of the constant rows
        ok = np.all(h >= -1e-9) if len(h) else True
        return (OracleResult(np.zeros(0), 0.0, "optimal") if ok
                else OracleResult(None, INF, "infeasible"))

    # stacked + Ruiz-equilibrated form: l̂ ≤ Â x̂ ≤ û  (ops/scaling.py)
    A0 = np.vstack([G, np.eye(n)])
    Dsc, Esc, csc = ruiz_equilibrate(H, A0, f)
    Hs = csc * (Dsc[:, None] * H * Dsc[None, :])
    fs = csc * Dsc * f
    A = Esc[:, None] * A0 * Dsc[None, :]
    l = Esc * np.concatenate([np.full(len(h), -INF), lb])
    u = Esc * np.concatenate([h, ub])
    m = A.shape[0]

    sigma = 1e-6
    rho = 0.1
    x = np.zeros(n)
    z = np.clip(np.zeros(m), l, u)
    y = np.zeros(m)
    AtA = A.T @ A
    K = np.linalg.inv(Hs + sigma * np.eye(n) + rho * AtA)
    alpha = 1.6

    def residuals(x, z, y):
        Ax = A @ x
        rp = np.linalg.norm((Ax - z) / Esc, np.inf)
        rd = np.linalg.norm((Hs @ x + fs + A.T @ y) / (Dsc * csc), np.inf)
        return rp, rd

    status = "maxiter"
    for it in range(max_iter):
        xt = K @ (sigma * x - fs + A.T @ (rho * z - y))
        zt = A @ xt
        zr = alpha * zt + (1 - alpha) * z
        z_new = np.clip(zr + y / rho, l, u)
        y = y + rho * (zr - z_new)
        x, z = xt, z_new
        if it % 50 == 49:
            rp, rd = residuals(x, z, y)
            if rp < tol and rd < tol:
                status = "converged"
                break
            # adaptive rho (OSQP §5.2 heuristic)
            scale = np.sqrt(rp / max(rd, 1e-16))
            if np.isfinite(scale) and (scale > 5 or scale < 0.2):
                rho = np.clip(rho * scale, 1e-6, 1e6)
                K = np.linalg.inv(Hs + sigma * np.eye(n) + rho * AtA)

    # polish: exact KKT solve on the active set (scaled frame)
    Ax = A @ x
    act_l = Ax - l < 1e-6
    act_u = u - Ax < 1e-6
    act = act_l | act_u
    if act.any():
        # polish in the ORIGINAL frame on the detected active rows
        l0 = np.concatenate([np.full(len(h), -INF), lb])
        u0 = np.concatenate([h, ub])
        Aa = A0[act]
        ba = np.where(act_u[act], u0[act], l0[act])
        ka = Aa.shape[0]
        KKT = np.block([[H, Aa.T], [Aa, -1e-12 * np.eye(ka)]])
        rhs = np.concatenate([-f, ba])
        try:
            sol = np.linalg.solve(KKT, rhs)
        except np.linalg.LinAlgError:
            sol = np.linalg.lstsq(KKT, rhs, rcond=None)[0]
        xp = sol[:n]
        nu = sol[n:]
        # verify: feasible on all rows, dual signs consistent
        scale_rows = np.maximum(1.0, np.abs(ba).max() if ka else 1.0)
        Axp = A0 @ xp
        feas_ok = (np.all(Axp <= u0 + 1e-7 * scale_rows)
                   and np.all(Axp >= l0 - 1e-7 * scale_rows))
        # Implied-equality pairs (z ≤ 0 ∧ −z ≤ 0 from fixed binaries —
        # the exact case this polish exists for) are a single equality
        # split over two rows: the rank-deficient KKT solve can put a
        # negative multiplier on one row of the pair while their SUM
        # (the equality's free-sign multiplier) is fine. Detect opposite
        # active rows (A_i ≈ −A_j, b_i ≈ −b_j) and exempt them from the
        # one-sided sign test.
        free_sign = np.zeros(ka, dtype=bool)
        if ka:
            rnorm = np.maximum(np.abs(Aa).max(axis=1), 1e-12)
            for i in range(ka):
                opp = (np.abs(Aa + Aa[i]).max(axis=1)
                       + np.abs(ba + ba[i])) < 1e-8 * rnorm[i]
                opp[i] = False
                if opp.any():
                    free_sign[i] = True
        sign_ok = np.all(np.where(free_sign, True,
                         np.where(act_u[act], nu >= -1e-6,
                                  np.where(act_l[act], nu <= 1e-6, True))))
        stat = np.linalg.norm(H @ xp + f + Aa.T @ nu, np.inf)
        stat_ok = stat < 1e-6 * max(1.0, np.abs(f).max())
        if feas_ok and sign_ok and stat_ok and np.all(np.isfinite(xp)):
            return OracleResult(xp, 0.5 * xp @ H @ xp + f @ xp, "optimal")

    if status == "converged":
        rp, rd = residuals(x, z, y)
        if rp < 1e-6 and rd < 1e-6:
            xo = Dsc * x
            return OracleResult(xo, 0.5 * xo @ H @ xo + f @ xo, "optimal")

    # not converged: classify via HiGHS LP feasibility (original frame)
    from scipy.optimize import linprog

    l0 = np.concatenate([np.full(len(h), -INF), lb])
    u0 = np.concatenate([h, ub])
    fin_u = u0 < 1e29
    fin_l = l0 > -1e29
    A_ub = np.vstack([A0[fin_u], -A0[fin_l]])
    b_ub = np.concatenate([u0[fin_u], -l0[fin_l]])
    res = linprog(np.zeros(n), A_ub=A_ub, b_ub=b_ub,
                  bounds=[(None, None)] * n, method="highs")
    if res.status == 2:
        return OracleResult(None, INF, "infeasible")
    return OracleResult(None, INF, "failed")


def solve_miqp_enumeration_oracle(H, f, G, h, lb, ub, binary_idx,
                                  tol: float = 1e-9) -> OracleResult:
    """Exact MIQP: enumerate all binary assignments, reduce + solve QPs.

    For assignment b over binary_idx: free vars xF solve the reduced QP
        min ½xFᵀH_FF xF + (f_F + H_FB b)ᵀ xF
        s.t. C_F xF ≤ d − C_B b  (and free-var box rows)
    total objective adds ½bᵀH_BB b + f_Bᵀ b.
    """
    H = np.asarray(H, np.float64)
    f = np.asarray(f, np.float64)
    G = np.asarray(G, np.float64)
    h = np.asarray(h, np.float64)
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    n = len(f)
    bidx = np.asarray(binary_idx, dtype=int)
    fidx = np.setdiff1d(np.arange(n), bidx)
    nb = len(bidx)
    if nb > 22:
        raise ValueError(f"enumeration oracle: {nb} binaries is too many")

    best = OracleResult(None, INF, "infeasible")
    H_FF = H[np.ix_(fidx, fidx)]
    H_FB = H[np.ix_(fidx, bidx)]
    H_BB = H[np.ix_(bidx, bidx)]
    G_F, G_B = G[:, fidx], G[:, bidx]

    for bits in itertools.product((0.0, 1.0), repeat=nb):
        b = np.asarray(bits)
        # respect pre-fixed binaries in lb/ub
        if np.any(b < lb[bidx] - 1e-12) or np.any(b > ub[bidx] + 1e-12):
            continue
        r = solve_qp_oracle(
            H_FF, f[fidx] + H_FB @ b, G_F, h - G_B @ b,
            lb[fidx], ub[fidx], tol=tol)
        if r.status != "optimal":
            continue
        total = r.obj + 0.5 * b @ H_BB @ b + f[bidx] @ b
        if total < best.obj - 1e-12:
            x = np.zeros(n)
            x[fidx] = r.x
            x[bidx] = b
            best = OracleResult(x, total, "optimal", binaries=b.copy())
    return best
