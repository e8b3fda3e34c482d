"""Host-side (fp64) root cutting planes: Balas lift-and-project split
cuts for the condensed MIQP.

Counterpart of ``pyhybridcontrol_tpu/ops/cuts.py`` (``with_split_cuts``,
``_lifted_rows``, ``_cglp``, ``CutDiagnostics``): the same numpy code,
one scipy ``linprog`` (HiGHS) call a cut, on the port's own fp64 oracle
(solver/oracle.py). Nothing here touches the device.

Method. Split cuts from the cut-generating LP (Balas, Ceria & Cornuéjols
1993), generated in the LIFTED ``y = (V, x0)`` space: the condensed rows
``G V ≤ h0 + Hx x0`` are constant-rhs in y, so a cut

    a_Vᵀ V + a_xᵀ x0 ≤ β

valid for { y : C y ≤ d, V[binary] integral } with x0 in a trust box is
a parametric row of the ordinary ``(G, h0, Hx)`` frame:
``G ← [G; a_V], h0 ← [h0; β], Hx ← [Hx; −a_x]``. For the split on
binary j (δ_j ≤ 0 ∨ δ_j ≥ 1) the CGLP

    max  aᵀy* − β
    s.t. a = Cᵀu + u₀ e_j,   β ≥ dᵀu,          u, u₀ ≥ 0
         a = Cᵀv − v₀ e_j,   β ≥ dᵀv − v₀,     v, v₀ ≥ 0
         1ᵀu + u₀ + 1ᵀv + v₀ = 1

finds the most-violated inequality at the fractional root point y* that
is valid on both branches, hence for every integral point. Disturbance
channels are refused, as in the reference.

The trust box. A cut holds only for x0 inside ``[x0_lo, x0_hi]``. The
reference does not record the box; the port stores it on the returned
frame (``CondensedMpc.x0_box``, carried by every later transform and by
``device_qp`` into ``DeviceQP.x0_box``) and refuses an x0 outside it
with a ``ValueError``: on the host in ``assemble_np`` and
``MpcController.feedback``, on the device in ``DeviceQP.assemble`` (one
host read, paid only by frames that carry a box).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc


@dataclasses.dataclass
class CutDiagnostics:
    """Per-round record of the generation run (host-side, fp64)."""

    n_cuts: int
    root_bound_before: float
    root_bound_after: float
    rounds: int
    violations: list                 # accepted CGLP violations, in order
    notes: str = ""


def _lifted_rows(G, h0, Hx, lb, ub, x0_lo, x0_hi):
    """All-rows-constant lifted system C y ≤ d over y = [V; x0]:
    condensed rows, finite V box rows, x0 trust-box rows."""
    nV = G.shape[1]
    nx = Hx.shape[1]
    fin_u = np.isfinite(ub)
    fin_l = np.isfinite(lb)
    Iv = np.eye(nV)
    rows = [np.hstack([G, -Hx]),
            np.hstack([Iv[fin_u], np.zeros((int(fin_u.sum()), nx))]),
            np.hstack([-Iv[fin_l], np.zeros((int(fin_l.sum()), nx))]),
            np.hstack([np.zeros((nx, nV)), np.eye(nx)]),
            np.hstack([np.zeros((nx, nV)), -np.eye(nx)])]
    d = [h0, ub[fin_u], -lb[fin_l], np.asarray(x0_hi, np.float64),
         -np.asarray(x0_lo, np.float64)]
    return np.vstack(rows), np.concatenate(d)


def _cglp(C, d, j, ystar):
    """Most-violated split cut at ystar for the disjunction on y_j.
    Returns (a, beta, violation) or (None, None, 0.0)."""
    from scipy.optimize import linprog

    mC, ny = C.shape
    nz = 2 * mC + 2 + ny + 1      # [u, u0, v, v0, a, beta]
    ej = np.zeros(ny)
    ej[j] = 1.0
    Aeq = np.zeros((2 * ny + 1, nz))
    beq = np.zeros(2 * ny + 1)
    Aeq[:ny, :mC] = -C.T
    Aeq[:ny, mC] = -ej
    Aeq[:ny, 2 * mC + 2:2 * mC + 2 + ny] = np.eye(ny)
    Aeq[ny:2 * ny, mC + 1:2 * mC + 1] = -C.T
    Aeq[ny:2 * ny, 2 * mC + 1] = ej
    Aeq[ny:2 * ny, 2 * mC + 2:2 * mC + 2 + ny] = np.eye(ny)
    Aeq[2 * ny, :2 * mC + 2] = 1.0
    beq[2 * ny] = 1.0
    Aub = np.zeros((2, nz))
    Aub[0, :mC] = d
    Aub[0, -1] = -1.0
    Aub[1, mC + 1:2 * mC + 1] = d
    Aub[1, 2 * mC + 1] = -1.0
    Aub[1, -1] = -1.0
    cobj = np.zeros(nz)
    cobj[-1] = 1.0
    cobj[2 * mC + 2:2 * mC + 2 + ny] = -ystar
    bounds = [(0, None)] * (2 * mC + 2) + [(None, None)] * (ny + 1)
    r = linprog(cobj, A_ub=Aub, b_ub=np.zeros(2), A_eq=Aeq, b_eq=beq,
                bounds=bounds, method="highs")
    if not r.success:
        return None, None, 0.0
    a = r.x[2 * mC + 2:2 * mC + 2 + ny]
    beta = float(r.x[-1])
    return a, beta, float(a @ ystar - beta)


def with_split_cuts(cmpc: CondensedMpc, x0_lo, x0_hi, x0_nominal,
                    n_per_round: int = 8, rounds: int = 3,
                    min_violation: float = 1e-4,
                    n_tilts: int = 0, tilt_eps: float = 1e-4,
                    seed: int = 0,
                    return_diagnostics: bool = False):
    """Append lift-and-project split-cut rows to a CondensedMpc.

    ``x0_lo``/``x0_hi``: the x0 trust box the cuts stay valid on (the
    controller's operating envelope, not the model's state box: a wide box
    weakens the cuts). The returned frame carries it as ``x0_box`` and
    refuses an x0 outside it (module docstring). ``x0_nominal``: the
    instance whose fractional root solution seeds cut selection (validity
    never depends on it). Each round re-solves the fp64 root relaxation
    with the cuts so far and separates the ``n_per_round`` most
    fractional binaries. Apply before with_soft_constraints /
    with_move_blocking. ``n_tilts``: extra separation points per round,
    each the root re-solved under a small random linear tilt
    (±tilt_eps·|f|∞) — another vertex of a degenerate optimal face.
    """
    if cmpc.Hw.shape[1] != 0 and np.any(cmpc.Hw):
        raise ValueError(
            "split cuts over a model with a disturbance channel would "
            "need a W trust box lifted into the CGLP (not implemented); "
            "generate cuts on the nω=0 frame")
    from pyhybridcontrol_tpu_torch.solver.oracle import solve_qp_oracle

    x0_lo = np.asarray(x0_lo, np.float64)
    x0_hi = np.asarray(x0_hi, np.float64)
    x0n = np.asarray(x0_nominal, np.float64)
    if x0_lo.shape != (cmpc.info.nx,) or x0_hi.shape != x0_lo.shape:
        raise ValueError(f"the trust box needs two ({cmpc.info.nx},) "
                         f"corners, got {x0_lo.shape} and {x0_hi.shape}")
    if np.any(x0_lo > x0_hi):
        raise ValueError(f"empty trust box: {x0_lo} > {x0_hi}")
    nV = cmpc.H.shape[0]
    bidx = np.asarray(cmpc.binary_idx)
    G = np.array(cmpc.G, np.float64)
    h0 = np.array(cmpc.h0, np.float64)
    Hx = np.array(cmpc.Hx, np.float64)
    lb, ub = cmpc.lb, cmpc.ub
    viols: list = []
    bound0 = bound1 = float("nan")
    notes = ""
    done_rounds = 0
    rng = np.random.default_rng(seed)
    f_nom = cmpc.f0 + cmpc.Fx @ x0n
    tilt_scale = tilt_eps * max(float(np.abs(f_nom).max()), 1.0)
    cut_dirs: list = []              # unit rows, for near-duplicate drops

    def _dup(aV):
        u_ = aV / max(np.linalg.norm(aV), 1e-12)
        return any(abs(float(u_ @ v_)) > 1.0 - 1e-6 for v_ in cut_dirs)

    for rnd in range(rounds):
        # degenerate-face solves need a looser gate than the parity
        # oracle's 1e-8 (as the reference's)
        r = solve_qp_oracle(cmpc.H, f_nom, G, h0 + Hx @ x0n, lb, ub,
                            tol=1e-6, max_iter=60000)
        if r.status != "optimal" or r.x is None:
            notes = (f"round {rnd}: fp64 root solve status {r.status!r}"
                     " — stopped early (cuts so far kept)")
            break
        if rnd == 0:
            bound0 = float(r.obj)
        bound1 = float(r.obj)
        done_rounds = rnd
        points = [r.x]
        for _ in range(n_tilts):
            ft = f_nom + tilt_scale * rng.standard_normal(nV)
            rt = solve_qp_oracle(cmpc.H, ft, G, h0 + Hx @ x0n, lb, ub,
                                 tol=1e-6, max_iter=60000)
            if rt.status == "optimal" and rt.x is not None:
                points.append(rt.x)
        C, d = _lifted_rows(G, h0, Hx, lb, ub, x0_lo, x0_hi)
        added = 0
        for xpt in points:
            xb = xpt[bidx]
            frac = np.abs(xb - np.round(xb))
            ystar = np.concatenate([xpt, x0n])
            for k in np.argsort(-frac)[:n_per_round]:
                if frac[k] < 1e-3:
                    break
                a, beta, viol = _cglp(C, d, int(bidx[k]), ystar)
                if a is None or viol < min_violation:
                    continue
                s = 1.0 / max(np.abs(a[:nV]).max(), 1e-12)
                aV = s * a[:nV]
                ax = s * a[nV:]
                b2 = s * beta
                aV[np.abs(aV) < 1e-12] = 0.0
                ax[np.abs(ax) < 1e-12] = 0.0
                if _dup(aV):
                    continue
                cut_dirs.append(aV / max(np.linalg.norm(aV), 1e-12))
                G = np.vstack([G, aV])
                h0 = np.append(h0, b2)
                Hx = np.vstack([Hx, -ax])
                viols.append(round(viol * s, 6))
                added += 1
        if added == 0:
            break
    # post-cut root bound (fp64, at the nominal instance)
    r = solve_qp_oracle(cmpc.H, f_nom, G, h0 + Hx @ x0n, lb, ub,
                        tol=1e-6, max_iter=60000)
    if r.status == "optimal":
        bound1 = float(r.obj)
    c = cmpc._clone()
    c.G, c.h0, c.Hx = G, h0, Hx
    c.Hw = np.vstack([cmpc.Hw,
                      np.zeros((G.shape[0] - cmpc.G.shape[0],
                                cmpc.Hw.shape[1]))])
    # cuts over a frame that already carries a box hold on the
    # intersection of the two boxes
    if cmpc.x0_box is not None:
        x0_lo = np.maximum(x0_lo, cmpc.x0_box[0])
        x0_hi = np.minimum(x0_hi, cmpc.x0_box[1])
    c.x0_box = (x0_lo, x0_hi)
    diag = CutDiagnostics(n_cuts=G.shape[0] - cmpc.G.shape[0],
                          root_bound_before=bound0,
                          root_bound_after=bound1,
                          rounds=done_rounds + 1, violations=viols,
                          notes=notes)
    return (c, diag) if return_diagnostics else c
