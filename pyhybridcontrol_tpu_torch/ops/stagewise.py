"""Stagewise (sparse, O(N)) MPC QP solver: the long-horizon path.

Counterpart of ``pyhybridcontrol_tpu/ops/stagewise.py``. The host half
(``prepare_stagewise``: stage blocks, the fp64 block LU of K, soft, blocking,
terminal and consensus rows, the bordered Woodbury factors of horizon-coupled
rows) is the reference's numpy float64 code; the device half is plain torch
on fp32 data around one kernel on the card: K5, the whole fixed-iteration
ADMM loop in one launch (``ops/cuda_stagewise.py``, ``csrc/stagewise.cu``),
which runs the block-tridiagonal sweep K⁻¹r of K4 as its inner routine;
where K5 has no instantiation, the torch loop around K4's or K6's sweep
(``csrc/stagewise_any.cu``: any b, sequential or over windows).

Formulation. Stage variables ξ_k = [v_k; x_{k+1}], k = 0…N−1 (block size
b = nv + nx; states are not eliminated). OSQP-form rows per stage:

    dynamics (equality, l=u):  x_{k+1} − Bv v_k − A x_k = b5 + B4 ω_k
    stage ineq:                E x_k + Fv v_k ≤ f5 − F4 ω_k
    box:                       lb_k ≤ ξ_k ≤ ub_k

x_k lives in ξ_{k−1} (x_0 is data, folded into the k=0 bounds), so every
row couples at most (ξ_{k−1}, ξ_k), and the ADMM KKT matrix
K = P + σI + Aᵀdiag(ρ)A is block-tridiagonal. K is factored once on the
host (fp64 block LU); each ADMM iteration applies A/Aᵀ stage-locally and
solves Kξ = t with a forward and a backward sweep over the N stages.

Δu rate and y-output costs couple consecutive stages, so P is
block-tridiagonal too (``P_off``). Move blocking and terminal sets ride as
extra per-stage rows: blocking as adjacent-stage equality rows
u_k − u_{k−1} = 0 at non-leader stages (vacuous ±BIG bounds at leaders;
blocked binary inputs branch only at leaders, solver/bnb_stagewise.py),
terminal sets as rows on x_{k+1}, real at k = N−1 and vacuous elsewhere.
Soft inequality rows take the prox route (no slack variables): the z-update
of a soft row is the exact proximal step of lin·s + quad·s², and the
objective adds the penalty explicitly. Consensus selector rows (the
scenario tree's non-anticipativity, ops/stagewise_tree.py) are stage-local
identities on the leading ``n_cons`` coordinates of v_k whose z-update the
tree solver replaces by the probability-weighted group mean.
Horizon-coupled extra rows A_v·V ≤ b + B_x·x0 + B_w·vec(W) are global
rows: the x-update solves the rank-r bordered system by Woodbury on top of
the sweeps, x = K⁻¹t − KiU·Cw·(Aext·K⁻¹t), with KiU = K⁻¹Aextᵀ and
Cw = (diag(1/ρₑ) + Aext K⁻¹ Aextᵀ)⁻¹ prefactored on the host.

Port decisions:
- ``_solve_K`` is a Python loop over the stages: the plain version of K4.
  ``_admm_iterations`` is the ADMM loop in torch around a sweep the caller
  names (``_solve_K``, ``_solve_K_assoc`` or ``_solve_K_windowed``): the
  plain version of K5.
  ``stagewise_admm_solve`` dispatches the loop on the tensor's device and
  the shapes (``_admm_route``): a CUDA tensor launches K5 once
  (``cuda_stagewise.sw_admm_cuda``) wherever K5 has an instantiation
  (``cuda_stagewise.k5_plan``), else runs ``_admm_iterations`` on the
  card with a hand-written sweep: K4 (``_k4_sweep``) where its plan takes
  the shape, K6 (``_k6_sweep``, any b) where it does not; a CPU tensor
  runs ``_admm_iterations`` with ``_solve_K``. The set-up before the loop
  and the residuals, objective and certificate after it stay in torch.
- ``parallel_sweeps=True`` is another algorithm the caller picks, not a
  fallback. On a CPU tensor it runs the plain loop with ``_solve_K_assoc``,
  the reference's log-depth prefix over affine maps. On a CUDA tensor it
  launches K5 once with its parallel sweep (the horizon in C windows, each
  swept from a zero carry, joined by carries through the window maps; its
  plain version is ``_admm_iterations`` with ``_solve_K_windowed``): in
  the horizon variant where that takes the shape (one scenario, no extra
  rows, b ≤ 16, ``cuda_stagewise.horizon_applies``), else inside the
  variant K5's plan picks (extra rows, a group mean, b up to 128), the
  Woodbury step, the rows and the group mean then reading the corrected
  x. Where K5 has no instantiation (b above 128, a tree past its
  clusters) and for a group mean over ranks (``consensus_M`` a function)
  the torch loop runs with K6's windowed sweep (``_k6_windowed_sweep``,
  ``cuda_stagewise.any_windows(N)`` windows; its plain version
  ``_solve_K_windowed``). The plain sweeps never run on the card.
- The objective, the infeasibility certificate's support and gap sums and
  the dual bound's sums accumulate in float64, as in ops/admm.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import AdmmResult, _implied_box
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights, _sq, _vec
from pyhybridcontrol_tpu_torch.ops import cuda_stagewise as cs
from pyhybridcontrol_tpu_torch.ops.cuda_stagewise import sw_admm_cuda
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

BIG = 1e30


@dataclasses.dataclass
class StagewiseQP:
    """Prepared stagewise ADMM data: fp32 tensors on one device plus static
    ints and tuples. b = nv + nx is the block size and
    m_k = nx + nc + b + n_blk + n_term + n_cons the rows per stage."""

    Bv: torch.Tensor          # (nx, nv)
    A_dyn: torch.Tensor       # (nx, nx)
    E: torch.Tensor           # (nc, nx)
    Fv: torch.Tensor          # (nc, nv)
    P_diag: torch.Tensor      # (N, b, b) diagonal blocks of P
    P_off: torch.Tensor       # (N, b, b) P_{k,k−1}; [0] zero
    q0: torch.Tensor          # (N, b) constant linear term
    Rdu2: torch.Tensor        # (nu, nu) 2·Rdu: q[0,:nu] −= Rdu2 u_prev
    M_vy: torch.Tensor        # (nv, ny) 2·DvᵀQy: y-data → v linear term
    M_xy: torch.Tensor        # (nx, ny) 2·CᵀQy: y-data → x linear term
    Cy: torch.Tensor          # (ny, nx) output C (y_0 carries C x_0)
    D4y: torch.Tensor         # (ny, nw) output disturbance map
    soft_lin: torch.Tensor    # (N, m_k) linear penalty per row (0: hard)
    soft_quad: torch.Tensor   # (N, m_k) quadratic penalty per row
    tie: torch.Tensor         # (N, n_blk) 1 where stage k is tied to k−1
    Et: torch.Tensor          # (n_term, nx) terminal rows Et x_N ≤ ft
    ft: torch.Tensor          # (n_term,)
    L: torch.Tensor           # (N, b, b) forward factors, L[0] zero
    Uinv: torch.Tensor        # (N, b, b) inverses of the diagonal blocks
    C: torch.Tensor           # (N, b, b) back-substitution couplers,
    #                           C[N−1] zero
    lb_xi: torch.Tensor       # (N, b) variable box
    ub_xi: torch.Tensor       # (N, b)
    f5: torch.Tensor          # (nc,)
    b5: torch.Tensor          # (nx,)
    B4: torch.Tensor          # (nx, nw)
    F4: torch.Tensor          # (nc, nw)
    rho_rows: torch.Tensor    # (N, m_k) per-row ρ
    N: int
    nx: int
    nv: int
    nc: int
    sigma: float
    alpha: float
    binary_idx_v: tuple
    has_soft: bool
    blk_cols: tuple = ()      # v-coordinates carried by the blocking rows
    blk_groups: tuple = ()    # step-group ids (leaders branch)
    n_term: int = 0
    n_cons: int = 0           # consensus selector rows per stage
    # horizon-coupled extra rows (None when n_ext == 0)
    Aext: Optional[torch.Tensor] = None     # (r, N, b) coefficients on ξ
    bext: Optional[torch.Tensor] = None     # (r,)
    Bx_ext: Optional[torch.Tensor] = None   # (r, nx)
    Bw_ext: Optional[torch.Tensor] = None   # (r, N·nw)
    rho_ext: Optional[torch.Tensor] = None  # (r,)
    KiU: Optional[torch.Tensor] = None      # (N, b, r) K⁻¹ Aextᵀ
    Cw: Optional[torch.Tensor] = None       # (r, r)
    n_ext: int = 0
    # derived operator blocks, per (dtype, device) (``_row_blocks``)
    cache: dict = dataclasses.field(default_factory=dict, repr=False,
                                    compare=False)

    @property
    def b(self) -> int:
        return self.nv + self.nx

    @property
    def n_blk(self) -> int:
        return len(self.blk_cols)

    @property
    def m_k(self) -> int:
        return (self.nx + self.nc + self.b + self.n_blk + self.n_term
                + self.n_cons)

    @property
    def device(self) -> torch.device:
        return self.L.device

    @property
    def factors(self):
        return self.L, self.Uinv, self.C


def block_lu(diag, off):
    """Host fp64 block LU of a block-tridiagonal K with diagonal blocks
    ``diag`` (N, b, b) and sub-diagonal blocks ``off`` (K_{k,k−1}):
    U_0 = K_00, L_k = K_{k,k−1} U_{k−1}⁻¹, U_k = K_kk − L_k K_{k−1,k}.
    Returns (L, U⁻¹, C) with C_k = U_k⁻¹ K_{k,k+1}."""
    N, b, _ = diag.shape
    L = np.zeros((N, b, b))
    Uinv = np.zeros((N, b, b))
    C = np.zeros((N, b, b))
    U_prev = None
    off_T = np.transpose(off, (0, 2, 1))   # K_{k−1,k} = (K_{k,k−1})ᵀ
    for k in range(N):
        if k == 0:
            U = diag[0]
        else:
            L[k] = off[k] @ np.linalg.inv(U_prev)
            U = diag[k] - L[k] @ off_T[k]
        Uinv[k] = np.linalg.inv(U)
        U_prev = U
    for k in range(N - 1):
        C[k] = Uinv[k] @ off_T[k + 1]
    return L, Uinv, C


def _sweeps_np(L, Uinv, C, rhs):
    """K⁻¹ rhs on the host in fp64 for rhs (N, b, r)."""
    N, b, r = rhs.shape
    ys = np.zeros_like(rhs)
    prev = np.zeros((b, r))
    for k in range(N):
        ys[k] = rhs[k] - (L[k] @ prev if k else 0.0)
        prev = ys[k]
    xs = np.zeros_like(rhs)
    nxt = np.zeros((b, r))
    for k in range(N - 1, -1, -1):
        xs[k] = Uinv[k] @ ys[k] - (C[k] @ nxt if k < N - 1 else 0.0)
        nxt = xs[k]
    return xs


def prepare_stagewise(model: MldModel, N: int,
                      weights: Optional[MpcWeights] = None,
                      rho: float = 1.0, rho_eq_scale: float = 10.0,
                      sigma: float = 1e-6, alpha: float = 1.6,
                      reg: float = 1e-8, soft=None,
                      blocking=None, block_deltas: bool = False,
                      terminal=None, consensus: int = 0,
                      extra=None, device=DEFAULT_DEVICE) -> StagewiseQP:
    """Host fp64 build: stage blocks and the block-tridiagonal LU of K.

    ``soft``: optional (rows, lin_pen, quad_pen) with ``rows`` indexing
    stage-inequality rows over the horizon as ``k*ncons + r``.
    ``blocking``: optional length-N step-group ids (start at 0, contiguous,
    nondecreasing): u is held constant within each group by adjacent-stage
    equality rows; ``block_deltas=True`` ties δ as well. ``terminal``:
    optional (E_N, f_N) rows on x_N. ``consensus``: number of leading
    v-coordinates per stage that get a consensus selector row (only
    ops/stagewise_tree.py sets it). ``extra``: optional horizon-coupled
    rows ``(A_v, b, B_x, B_w)``, A_v·V ≤ b + B_x·x0 + B_w·vec(W) over the
    stacked per-stage v, solved as a rank-r bordered extension of K."""
    device = resolve_device(device)
    w = weights or MpcWeights()
    info = model.info
    if info.nxb > 0:
        raise ValueError(
            "stagewise solver does not support binary states (nxb>0): "
            "branching runs over per-step v binaries only. Use the "
            "condensed path, which enforces state integrality via "
            "auxiliary binaries (ops/condense.py)")
    m = model.numpy_mats()
    nx, nv, nc = info.nx, info.nv, info.ncons
    b = nv + nx
    Bv = np.hstack([m.B1, m.B2, m.B3])
    Fv = np.hstack([m.F1, m.F2, m.F3])

    # objective blocks (condense.py's convention: ×2 internally)
    Qx = _sq(w.Qx, nx)
    QxN = _sq(w.QxN, nx) if w.QxN is not None else Qx
    Rv = np.zeros((nv, nv))
    Rv[info.u_slice, info.u_slice] = _sq(w.Ru, info.nu)
    Rv[info.delta_slice, info.delta_slice] = _sq(w.Qdelta, info.ndelta)
    Rv[info.z_slice, info.z_slice] = _sq(w.Rz, info.nz)
    rv = np.concatenate([_vec(w.ru, info.nu), _vec(w.qdelta, info.ndelta),
                         _vec(w.rz, info.nz)])
    qx = _vec(w.qx, nx)
    qxN = _vec(w.qxN, nx) if w.qxN is not None else qx

    P_diag = np.zeros((N, b, b))
    P_off = np.zeros((N, b, b))        # P_{k,k−1}
    q0 = np.zeros((N, b))
    for k in range(N):
        Qk = QxN if k == N - 1 else Qx
        qk = qxN if k == N - 1 else qx
        if w.x_ref is not None:
            qk = qk - 2.0 * (Qk @ _vec(w.x_ref, nx))
        P_diag[k, :nv, :nv] = 2.0 * Rv
        P_diag[k, nv:, nv:] = 2.0 * Qk
        P_diag[k] += reg * np.eye(b)
        q0[k, :nv] = rv
        q0[k, nv:] = qk

    # Δu rate cost: Δu_k = u_k − u_{k−1}, u_{−1} supplied at feedback
    nu = info.nu
    Rdu2 = np.zeros((nu, nu))
    if w.Rdu is not None and nu > 0:
        Rdu2 = 2.0 * _sq(w.Rdu, nu)
        for k in range(N):
            P_diag[k, :nu, :nu] += Rdu2            # from Δu_k
            if k < N - 1:
                P_diag[k, :nu, :nu] += Rdu2        # from Δu_{k+1}
            if k >= 1:
                P_off[k, :nu, :nu] -= Rdu2         # u_k·u_{k−1} cross

    # y-output cost over y_0..y_{N−1}: y_k = C x_k + Dv v_k + D4 ω_k + d5;
    # x_k is ξ_{k−1}'s x part (k ≥ 1; x_0 is data), v_k is ξ_k's v part
    ny = m.C.shape[0]
    Dv = np.hstack([m.D1, m.D2, m.D3])
    M_vy = np.zeros((nv, ny))
    M_xy = np.zeros((nx, ny))
    if (w.Qy is not None or w.qy is not None) and ny > 0:
        Qy = _sq(w.Qy, ny)
        qy = _vec(w.qy, ny)
        M_vy = 2.0 * Dv.T @ Qy
        M_xy = 2.0 * m.C.T @ Qy
        d5 = m.d5[:, 0]
        gy = 2.0 * (Qy @ d5) + qy                  # constant y-data part
        for k in range(N):
            P_diag[k, :nv, :nv] += 2.0 * Dv.T @ Qy @ Dv
            q0[k, :nv] += Dv.T @ gy
            if k >= 1:
                P_diag[k - 1, nv:, nv:] += 2.0 * m.C.T @ Qy @ m.C
                q0[k - 1, nv:] += m.C.T @ gy
                P_off[k, :nv, nv:] += M_vy @ m.C   # v_k · x_k cross

    # ---- move blocking / terminal rows --------------------------------
    blk_cols: tuple = ()
    blk_groups: tuple = ()
    tie = np.zeros((N, 0))
    if blocking is not None:
        groups = [int(g) for g in blocking]
        if len(groups) != N:
            raise ValueError(f"blocking needs {N} group ids, got "
                             f"{len(groups)}")
        if groups[0] != 0 or any(g2 - g1 not in (0, 1) for g1, g2 in
                                 zip(groups, groups[1:])):
            raise ValueError("blocking groups must start at 0 and be "
                             "contiguous nondecreasing (condensed "
                             "with_move_blocking convention)")
        cols = list(range(info.nu))
        if block_deltas:
            cols += list(range(info.delta_slice.start,
                               info.delta_slice.stop))
        blk_cols = tuple(cols)
        blk_groups = tuple(groups)
        tie = np.zeros((N, len(cols)))
        for k in range(1, N):
            if groups[k] == groups[k - 1]:
                tie[k, :] = 1.0
    n_blk = len(blk_cols)
    if terminal is not None:
        Et = np.atleast_2d(np.asarray(terminal[0], np.float64))
        ft = np.asarray(terminal[1], np.float64).reshape(-1)
        if Et.shape != (len(ft), nx):
            raise ValueError(f"terminal E must be ({len(ft)}, {nx}), "
                             f"got {Et.shape}")
    else:
        Et = np.zeros((0, nx))
        ft = np.zeros((0,))
    n_term = len(ft)

    n_cons = int(consensus)
    if n_cons < 0 or n_cons > nv:
        raise ValueError(f"consensus must be in [0, nv={nv}]")

    # soft stage-inequality rows → per-row prox penalties
    m_k = nx + nc + b + n_blk + n_term + n_cons
    soft_lin = np.zeros((N, m_k))
    soft_quad = np.zeros((N, m_k))
    if soft is not None:
        rows, lin_pen, quad_pen = soft
        rows = np.asarray(rows, dtype=int)
        lin_a = np.broadcast_to(np.asarray(lin_pen, float), rows.shape)
        quad_a = np.broadcast_to(np.asarray(quad_pen, float), rows.shape)
        if np.any(rows < 0) or np.any(rows >= N * nc):
            raise ValueError(
                f"soft rows must lie in [0, N*ncons={N * nc})")
        k_idx, r_idx = rows // nc, rows % nc
        soft_lin[k_idx, nx + r_idx] = lin_a
        soft_quad[k_idx, nx + r_idx] = quad_a

    # Per-stage A blocks. Row layout [dyn(nx); ineq(nc); box(b); blk(n_blk);
    # term(n_term); cons(n_cons)]; J_k acts on ξ_k, M_k on ξ_{k−1}:
    #   J: dyn [−Bv, I]; ineq [Fv, 0]; box I_b; blk S; term [0, Et]; cons
    #   M: dyn [0, −A]; ineq [0, E]; blk −tie_k∘S (per stage, below)
    rho_rows = np.full(m_k, rho)
    rho_rows[:nx] = rho * rho_eq_scale          # dynamics equalities
    vb_mask = info.v_binary_mask
    box_rho = np.full(b, rho)
    box_rho[:nv][vb_mask] = rho * rho_eq_scale  # binary boxes
    rho_rows[nx + nc:nx + nc + b] = box_rho
    if n_blk:                                   # blocking equalities
        rho_rows[nx + nc + b:nx + nc + b + n_blk] = rho * rho_eq_scale
    if n_cons:                                  # consensus equalities
        rho_rows[nx + nc + b + n_blk + n_term:] = rho * rho_eq_scale
    rho_full = np.tile(rho_rows, (N, 1))

    J = np.zeros((m_k, b))
    J[:nx, :nv] = -Bv
    J[:nx, nv:] = np.eye(nx)
    J[nx:nx + nc, :nv] = Fv
    J[nx + nc:nx + nc + b, :] = np.eye(b)
    S_blk = np.zeros((n_blk, b))
    for j, cj in enumerate(blk_cols):
        S_blk[j, cj] = 1.0
    J[nx + nc + b:nx + nc + b + n_blk] = S_blk
    if n_term:
        J[nx + nc + b + n_blk:nx + nc + b + n_blk + n_term, nv:] = Et
    if n_cons:
        J[nx + nc + b + n_blk + n_term:, :n_cons] = np.eye(n_cons)
    M = np.zeros((m_k, b))
    M[:nx, nv:] = -m.A
    M[nx:nx + nc, nv:] = m.E

    # ---- K = P + σI + Aᵀdiag(ρ)A (block tridiagonal), host fp64 ----
    # stage-k rows touch ξ_k (J) and ξ_{k−1} (M):
    #   K_{k,k} += JᵀRJ (stage k) + MᵀRM (stage k+1);  K_{k,k−1} = JᵀRM
    # Stage-0 rows' M part multiplies x_0, which is data (it enters l/u).
    R = np.diag(rho_rows)
    JtRJ = J.T @ R @ J
    MtRM = M.T @ R @ M
    JtRM = J.T @ R @ M
    rho_blk = rho * rho_eq_scale
    bc = np.asarray(blk_cols, int)
    K_diag = np.zeros((N, b, b))
    K_off = np.zeros((N, b, b))
    for k in range(N):
        K_diag[k] = P_diag[k] + sigma * np.eye(b) + JtRJ
        if k + 1 < N:
            K_diag[k] += MtRM
            if n_blk:
                # stage-(k+1) blk rows' M part: (−tie∘S)ᵀρ(−tie∘S)
                K_diag[k][bc, bc] += rho_blk * tie[k + 1] ** 2
        if k >= 1:
            K_off[k] = JtRM + P_off[k]
            if n_blk:
                K_off[k][bc, bc] += -rho_blk * tie[k]
    L, Uinv, C = block_lu(K_diag, K_off)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float64),
                               dtype=torch.float32, device=device)

    # ---- horizon-coupled extra rows: host Woodbury factors ----
    nw = m.B4.shape[1]
    n_ext = 0
    ext_fields = {}
    if extra is not None:
        A_v, b_e = extra[0], extra[1]
        B_x = extra[2] if len(extra) > 2 else None
        B_w = extra[3] if len(extra) > 3 else None
        A_v = np.atleast_2d(np.asarray(A_v, np.float64))
        r_ext = A_v.shape[0]
        if A_v.shape[1] != N * nv:
            raise ValueError(
                f"extra A_v must have N*nv={N * nv} columns (stacked "
                f"per-stage v — the stagewise frame has no aux "
                f"columns), got {A_v.shape[1]}")
        bext_np = np.broadcast_to(
            np.asarray(b_e, np.float64).reshape(-1), (r_ext,)).copy()
        Bx_np = (np.zeros((r_ext, nx)) if B_x is None
                 else np.asarray(B_x, np.float64).reshape(r_ext, nx))
        Bw_np = (np.zeros((r_ext, N * nw)) if B_w is None
                 else np.asarray(B_w, np.float64).reshape(r_ext, N * nw))
        Aext_np = np.zeros((r_ext, N, b))
        Aext_np[:, :, :nv] = A_v.reshape(r_ext, N, nv)
        rho_ext_np = np.full(r_ext, rho)           # one-sided ineq rows
        KiU_np = _sweeps_np(L, Uinv, C, np.transpose(Aext_np, (1, 2, 0)))
        cap = (np.diag(1.0 / rho_ext_np)
               + np.einsum("rkb,kbs->rs", Aext_np, KiU_np))
        n_ext = r_ext
        ext_fields = dict(Aext=t(Aext_np), bext=t(bext_np), Bx_ext=t(Bx_np),
                          Bw_ext=t(Bw_np), rho_ext=t(rho_ext_np),
                          KiU=t(KiU_np), Cw=t(np.linalg.inv(cap)))

    lb_xi = np.full((N, b), -BIG)
    ub_xi = np.full((N, b), BIG)
    lb_xi[:, :nv][:, vb_mask] = 0.0
    ub_xi[:, :nv][:, vb_mask] = 1.0

    return StagewiseQP(
        Bv=t(Bv), A_dyn=t(m.A), E=t(m.E), Fv=t(Fv),
        P_diag=t(P_diag), P_off=t(P_off), q0=t(q0),
        Rdu2=t(Rdu2), M_vy=t(M_vy), M_xy=t(M_xy), Cy=t(m.C), D4y=t(m.D4),
        soft_lin=t(soft_lin), soft_quad=t(soft_quad),
        tie=t(tie), Et=t(Et), ft=t(ft), L=t(L), Uinv=t(Uinv), C=t(C),
        lb_xi=t(lb_xi), ub_xi=t(ub_xi),
        f5=t(m.f5[:, 0]), b5=t(m.b5[:, 0]), B4=t(m.B4), F4=t(m.F4),
        rho_rows=t(rho_full),
        N=N, nx=nx, nv=nv, nc=nc, sigma=float(sigma), alpha=float(alpha),
        binary_idx_v=tuple(int(i) for i in np.nonzero(vb_mask)[0]),
        has_soft=bool(soft_lin.any() or soft_quad.any()),
        blk_cols=blk_cols, blk_groups=blk_groups, n_term=n_term,
        n_cons=n_cons, n_ext=n_ext, **ext_fields)


# ---------------------------------------------------------------------------
# structured operators (batched over leading dims; stage axis = −2)
# ---------------------------------------------------------------------------


def stagewise_double(sw: StagewiseQP) -> StagewiseQP:
    """The prep in float64, with an operator cache of its own: the fp64
    reference the fp32 device half is read against."""
    return dataclasses.replace(sw, cache={}, **{
        f.name: getattr(sw, f.name).double()
        for f in dataclasses.fields(sw)
        if isinstance(getattr(sw, f.name), torch.Tensor)})


def _prev(a):
    """a shifted one stage later along −2: [0, a_0, …, a_{N−2}]."""
    return F.pad(a[..., :-1, :], (0, 0, 1, 0))


def _next(a):
    """a shifted one stage earlier along −2: [a_1, …, a_{N−1}, 0]."""
    return F.pad(a[..., 1:, :], (0, 0, 0, 1))


def _row_blocks(sw: StagewiseQP, dtype=None):
    """The stage rows as two blocks: A ξ_k-rows = J ξ_k + M_k ξ_{k−1}.
    J (m_k, b) is shared; M (N, m_k, b) carries the dynamics' −A and the
    inequalities' E on x_k, and the blocking rows' −tie_k∘S on v_{k−1}
    (M_0 multiplies x_0, which is data: zero). Row layout [dyn(nx);
    ineq(nc); box(b); blk(n_blk); term(n_term); cons(n_cons)]. Built once
    per dtype on the prep's device."""
    dtype = dtype or sw.L.dtype
    got = sw.cache.get(("rows", dtype))
    if got is not None:
        return got
    nx, nc, nv, b = sw.nx, sw.nc, sw.nv, sw.b
    i0 = nx + nc + b
    i1 = i0 + sw.n_blk
    i2 = i1 + sw.n_term
    opts = dict(dtype=dtype, device=sw.device)
    J = torch.zeros((sw.m_k, b), **opts)
    J[:nx, :nv] = -sw.Bv.to(dtype)
    J[:nx, nv:] = torch.eye(nx, **opts)
    J[nx:nx + nc, :nv] = sw.Fv.to(dtype)
    J[nx + nc:i0] = torch.eye(b, **opts)
    for j, cj in enumerate(sw.blk_cols):
        J[i0 + j, cj] = 1.0
    J[i1:i2, nv:] = sw.Et.to(dtype)
    J[i2:, :sw.n_cons] = torch.eye(sw.n_cons, **opts)
    M = torch.zeros((sw.N, sw.m_k, b), **opts)
    M[1:, :nx, nv:] = -sw.A_dyn.to(dtype)
    M[1:, nx:nx + nc, nv:] = sw.E.to(dtype)
    for j, cj in enumerate(sw.blk_cols):
        M[:, i0 + j, cj] = -sw.tie[:, j].to(dtype)
    got = sw.cache[("rows", dtype)] = (J, M, M.transpose(1, 2))
    return got


def _apply_A(sw: StagewiseQP, xi):
    """A ξ: (…, N, b) → (…, N, m_k): J ξ_k + M_k ξ_{k−1} (dynamics
    x_{k+1} − Bv v_k − A x_k, inequalities Fv v_k + E x_k, the box, the
    blocking rows u_k − tie_k·u_{k−1}, terminal Et x_{k+1}, the consensus
    selectors)."""
    J, M, _ = _row_blocks(sw, xi.dtype)
    return xi @ J.T + torch.einsum("kij,...kj->...ki", M, _prev(xi))


def _apply_AT(sw: StagewiseQP, w):
    """Aᵀ w: (…, N, m_k) → (…, N, b): Jᵀ w_k + M_{k+1}ᵀ w_{k+1} (x_{k+1},
    ξ_k's x part, appears in dyn_k, dyn_{k+1} and ineq_{k+1}; u_k in blk_k
    and blk_{k+1})."""
    J, _, MT = _row_blocks(sw, w.dtype)
    return w @ J + _next(torch.einsum("kij,...kj->...ki", MT, w))


def _apply_P(sw: StagewiseQP, x):
    """P x with block-tridiagonal P:
    (Px)_k = P_kk x_k + P_{k,k−1} x_{k−1} + P_{k+1,k}ᵀ x_{k+1}."""
    Px = torch.einsum("kij,...kj->...ki", sw.P_diag, x)
    Px = Px + torch.einsum("kij,...kj->...ki", sw.P_off, _prev(x))
    P_off_next = F.pad(sw.P_off[1:].transpose(1, 2), (0, 0, 0, 0, 0, 1))
    return Px + torch.einsum("kij,...kj->...ki", P_off_next, _next(x))


def _solve_K(sw: StagewiseQP, r, factors=None):
    """K⁻¹ r by the block LU sweeps, a Python loop over the stages: the
    plain version of K4. r: (…, N, b) → (…, N, b). ``factors``: an
    optional (L, Uinv, C) triple of another block-tridiagonal K."""
    Lf, Uf, Cf = factors if factors is not None else sw.factors
    N, b = r.shape[-2:]
    rr = r.reshape(-1, N, b)
    ys = []
    prev = torch.zeros_like(rr[:, 0])
    for k in range(N):                 # y_k = r_k − L_k y_{k−1}
        prev = torch.addmm(rr[:, k], prev, Lf[k].T, alpha=-1)
        ys.append(prev)
    xs = [None] * N
    nxt = torch.zeros_like(prev)
    for k in range(N - 1, -1, -1):     # x_k = U⁻¹_k y_k − C_k x_{k+1}
        nxt = torch.addmm(ys[k] @ Uf[k].T, nxt, Cf[k].T, alpha=-1)
        xs[k] = nxt
    return torch.stack(xs, dim=-2).reshape(r.shape)


def _affine_prefix(M, v, with_maps: bool = False):
    """All prefixes of the affine recurrence y_k = M_k y_{k−1} + v_k
    (y_{−1} = 0) in O(log N) depth: affine maps compose associatively,
    (M_b, v_b)∘(M_a, v_a) = (M_b M_a, M_b v_a + v_b), and a Hillis-Steele
    scan applies that composition at doubling distances. M: (N, b, b);
    v: (N, …, b) with the batch axes between the scan and vector axes.
    ``with_maps``: also the prefix products M_k ⋯ M_0, as (M, v)."""
    N = M.shape[0]
    d = 1
    while d < N:
        Ma, va = M[:-d], v[:-d]
        Mb, vb = M[d:], v[d:]
        v = torch.cat([v[:d], torch.einsum("cij,c...j->c...i", Mb, va) + vb])
        M = torch.cat([M[:d], Mb @ Ma])
        d *= 2
    return (M, v) if with_maps else v


def _solve_K_assoc(sw: StagewiseQP, r, factors=None):
    """K⁻¹ r with log-depth sweeps: the horizon-parallel twin of
    ``_solve_K`` on the same factorization (L, U⁻¹, C). Extra work is the
    O(N log N b³) composition of the stage maps; the depth drops from O(N)
    to O(log N)."""
    Lf, Uf, Cf = factors if factors is not None else sw.factors
    r_t = torch.movedim(r, -2, 0)                 # (N, …, b)
    ys = _affine_prefix(-Lf, r_t)                 # forward: y = r − L y⁻
    # backward x_k = U⁻¹_k y_k − C_k x_{k+1}: flipped into a forward map
    vy = torch.einsum("cij,c...j->c...i", Uf, ys)
    xs = _affine_prefix(-Cf.flip(0), vy.flip(0)).flip(0)
    return torch.movedim(xs, 0, -2)


def window_maps(sw: StagewiseQP, windows, factors=None):
    """(Π, Ψ), each (N, b, b), of the windows ``windows`` (stage bounds
    w[0] = 0 < … < w[C] = N): for k in window [s, e), Π_k = (−L_k)⋯(−L_s)
    and Ψ_k = (−C_k)⋯(−C_{e−1}), so that y_k = y⁰_k + Π_k y_{s−1} and x_k =
    x⁰_k + Ψ_k x_e, y⁰ and x⁰ the window's sweeps from a zero carry. Products
    in float64 on the host from the factors (the prep's, or ``factors``),
    returned in their dtype on their device; the prep's cached per window
    split (K5's horizon variant reads them, ``cuda_stagewise``)."""
    Lf, _, Cf = factors if factors is not None else sw.factors
    key = ("window_maps", tuple(windows), Lf.dtype, Lf.device)
    got = None if factors is not None else sw.cache.get(key)
    if got is not None:
        return got
    Ld = -Lf.detach().double().cpu().numpy()
    Cd = -Cf.detach().double().cpu().numpy()
    Pi, Psi = np.zeros_like(Ld), np.zeros_like(Cd)
    for s, e in zip(windows[:-1], windows[1:]):
        Pi[s] = Ld[s]
        for k in range(s + 1, e):
            Pi[k] = Ld[k] @ Pi[k - 1]
        Psi[e - 1] = Cd[e - 1]
        for k in range(e - 2, s - 1, -1):
            Psi[k] = Cd[k] @ Psi[k + 1]
    got = tuple(torch.as_tensor(a, dtype=Lf.dtype, device=Lf.device)
                for a in (Pi, Psi))
    if factors is None:
        sw.cache[key] = got
    return got


def _solve_K_windowed(sw: StagewiseQP, r, windows, factors=None):
    """K⁻¹ r with the horizon in windows (stage bounds ``windows``, as
    ``cuda_stagewise.horizon_windows`` gives them): the plain version of
    K5's parallel sweep, step for step. Each window runs ``_solve_K``'s
    forward sweep from a zero carry; the carries y_{s−1} compose over the
    windows in order (carry ← Π_{e−1}·carry + y⁰_{e−1}, from zero); every
    stage is corrected, y_k = y⁰_k + Π_k·carry; then the same backward
    (x⁰ from zero, carries x_e over the windows in reverse, carry ←
    Ψ_s·carry + x⁰_s, x_k = x⁰_k + Ψ_k·carry). Window maps from
    ``window_maps``; r (…, N, b) → (…, N, b)."""
    Lf, Uf, Cf = factors if factors is not None else sw.factors
    Pi, Psi = window_maps(sw, windows, factors)
    N, b = r.shape[-2:]
    rr = r.reshape(-1, N, b)
    bounds = list(zip(windows[:-1], windows[1:]))
    lo, hi = list(windows[:-1]), [e - 1 for e in windows[1:]]
    at = torch.repeat_interleave(         # each stage's window
        torch.arange(len(bounds), device=r.device),
        torch.tensor([e - s for s, e in bounds], device=r.device))
    zero = torch.zeros_like(rr[:, 0])
    ys = [None] * N
    for s, e in bounds:                # y⁰ over each window
        prev = zero
        for k in range(s, e):
            prev = torch.addmm(rr[:, k], prev, Lf[k].T, alpha=-1)
            ys[k] = prev
    Y = torch.stack(ys)                # (N, …, b)
    cin = _exclusive_carries((Pi[hi], Y[hi]), Y.dtype)
    Y = Y + torch.einsum("kij,kpj->kpi", Pi, cin[at])
    xs = [None] * N
    for s, e in bounds:                # x⁰ over each window
        nxt = zero
        for k in range(e - 1, s - 1, -1):
            nxt = torch.addmm(Y[k] @ Uf[k].T, nxt, Cf[k].T, alpha=-1)
            xs[k] = nxt
    X = torch.stack(xs)                # carries x_e in reverse window order
    xin = _exclusive_carries((Psi[lo].flip(0), X[lo].flip(0)),
                             X.dtype).flip(0)
    X = X + torch.einsum("kij,kpj->kpi", Psi, xin[at])
    return X.transpose(0, 1).reshape(r.shape)


def _exclusive_carries(maps, dtype):
    """Carry-in of each block of a chained affine recurrence: ``maps`` is
    the pair (M (P, b, b), v (P, …, b)) of the blocks' whole maps
    y_out = M y_in + v in chain order; returns (P, …, b), the carry-in of
    block p composed from blocks 0..p−1 (zero for block 0)."""
    M, v = maps
    c = torch.zeros_like(v[0])
    out = [c]
    for p in range(M.shape[0] - 1):
        c = torch.einsum("ij,...j->...i", M[p], c) + v[p]
        out.append(c)
    return torch.stack(out).to(dtype)


def solve_K_horizon_sharded(sw: StagewiseQP, r, mesh, axis: str = "hz",
                            factors=None):
    """K⁻¹ r with the horizon split over ``mesh[axis]``: rank d holds the
    N/P stages [d·N/P, (d+1)·N/P) of r (…, N/P, b) and returns those
    stages of x. Each sweep is the log-depth scan of ``_solve_K_assoc``
    over the rank's stages from a zero carry, one all_gather of every
    rank's whole block map (b×b and the batch's b-vector), an exclusive
    prefix over the ranks (forward: earlier stages; backward: later
    ones), and the carry applied through the prefix maps. ``factors``:
    the full (L, U⁻¹, C), default the prep's; raises unless P divides
    N."""
    from pyhybridcontrol_tpu_torch.parallel.mesh import AxisComm

    comm = AxisComm(mesh, axis)
    P, d = comm.size, comm.rank
    Lf, Uf, Cf = factors if factors is not None else sw.factors
    N = Lf.shape[0]
    if N % P:
        raise ValueError(f"N={N} does not split over the {P} ranks of "
                         f"axis {axis!r}")
    Nl = N // P
    if r.shape[-2] != Nl:
        raise ValueError(f"r holds {r.shape[-2]} stages; a rank holds {Nl}")
    lo = d * Nl
    Lf, Uf, Cf = Lf[lo:lo + Nl], Uf[lo:lo + Nl], Cf[lo:lo + Nl]

    def sweep(Ms, v):
        """The block's prefix maps from a zero carry, and every rank's
        whole block map after one all_gather."""
        Mp, vp = _affine_prefix(Ms, v, with_maps=True)
        got = comm.all_gather(torch.cat([Mp[-1].reshape(-1),
                                         vp[-1].reshape(-1)]))
        b = Ms.shape[-1]
        return Mp, vp, (got[:, :b * b].reshape(P, b, b),
                        got[:, b * b:].reshape((P,) + vp.shape[1:]))

    # forward: y_k = r_k − L_k y_{k−1}, carries from the earlier ranks
    Mp, vp, maps = sweep(-Lf, torch.movedim(r, -2, 0))
    cin = _exclusive_carries(maps, r.dtype)[d]
    ys = torch.einsum("cij,...j->c...i", Mp, cin) + vp
    # backward: x_k = U⁻¹_k y_k − C_k x_{k+1}, flipped; carries from the
    # later ranks, so the chain runs in reversed rank order
    vy = torch.einsum("cij,c...j->c...i", Uf, ys)
    Mq, vq, (Mall, vall) = sweep(-Cf.flip(0), vy.flip(0))
    cin = _exclusive_carries((Mall.flip(0), vall.flip(0)),
                             r.dtype)[P - 1 - d]
    xs = (torch.einsum("cij,...j->c...i", Mq, cin) + vq).flip(0)
    return torch.movedim(xs, 0, -2)


def _k4_sweep(sw: StagewiseQP, t):
    """K⁻¹t through K4 (the stagewise sweep kernel) on the card."""
    from pyhybridcontrol_tpu_torch.ops.cuda_stagewise import sw_solve_k_cuda

    return sw_solve_k_cuda(t.contiguous(), sw.factors)


def _k6_sweep(sw: StagewiseQP, t):
    """K⁻¹t through K6 (the sweep at any b), sequential, on the card: its
    plain version is ``_solve_K``."""
    return cs.sw_solve_k_any_cuda(t.contiguous(), sw.factors)


def _k6_windowed_sweep(sw: StagewiseQP, t):
    """K⁻¹t through K6 over ``cuda_stagewise.any_windows(N)`` windows on the
    card (the window maps cached on the prep): its plain version is
    ``_solve_K_windowed`` on those windows."""
    C = cs.any_windows(sw.N)
    return cs.sw_solve_k_any_cuda(t.contiguous(), sw.factors, windows=C,
                                  maps=cs.any_maps(sw, C) if C > 1 else None)


def _solve_K_bordered(sw: StagewiseQP, t, sweep):
    """(K + Aextᵀ diag(ρₑ) Aext)⁻¹ t, the x-update solve: Woodbury on top
    of the sweeps, x = K⁻¹t − KiU·(Cw·(Aext·K⁻¹t)), with the prepared
    fp64 factors KiU and Cw. Assumes the prepared K. ``sweep(sw, t)`` is
    K⁻¹t: ``_solve_K`` or ``_solve_K_assoc``."""
    base = sweep(sw, t)
    if not sw.n_ext:
        return base
    s = torch.einsum("rkb,...kb->...r", sw.Aext, base)
    corr = s @ sw.Cw.T
    return base - torch.einsum("kbr,...r->...kb", sw.KiU, corr)


def assemble_stagewise_ext(sw: StagewiseQP, x0, W=None):
    """Per-solve upper bounds of the horizon-coupled extra rows:
    u_ext = b + B_x·x0 + B_w·vec(W). Pass as ``ext_u`` to
    ``stagewise_admm_solve`` / ``stagewise_dual_bound`` /
    ``solve_miqp_bnb_stagewise``. Refuses a missing W when the rows
    depend on the disturbance."""
    u_ext = sw.bext + sw.Bx_ext @ x0
    if W is None:
        if sw.Bw_ext.shape[1] > 0 and bool(sw.Bw_ext.ne(0).any()):
            raise ValueError(
                "assemble_stagewise_ext: Bw_ext has nonzero entries "
                "(disturbance-dependent extra rows) but no omega "
                "forecast W was passed — supply W explicitly")
    elif sw.Bw_ext.shape[1] > 0:
        u_ext = u_ext + sw.Bw_ext @ W.reshape(-1)
    return u_ext


def block_lu_device(K_diag, K_off):
    """Block-tridiagonal LU on the device (the twin of the host
    ``block_lu``), a loop over the stages carrying U_{k−1}; for a K that
    must be refactored on the device. Returns (L, Uinv, C) shaped like
    ``StagewiseQP.L/Uinv/C``."""
    N, b, _ = K_diag.shape
    off_T = K_off.transpose(-1, -2)               # K_{k−1,k} = K_{k,k−1}ᵀ
    eye = torch.eye(b, dtype=K_diag.dtype, device=K_diag.device)
    U_prev = eye
    Ls, Us = [], []
    for k in range(N):
        # U_{−1} = I and K_{0,−1} = 0: the k=0 step gives L_0 = 0, U_0 = K_00
        Lk = K_off[k] @ torch.linalg.solve(U_prev, eye)
        U_prev = K_diag[k] - Lk @ off_T[k]
        Ls.append(Lk)
        Us.append(U_prev)
    L, U = torch.stack(Ls), torch.stack(Us)
    Uinv = torch.linalg.solve(U, eye.expand(N, b, b))
    C = F.pad(Uinv[:-1] @ off_T[1:], (0, 0, 0, 0, 0, 1))
    return L, Uinv, C


def _dsum(a, dims=(-2, -1)):
    return a.double().sum(dim=dims)


def stagewise_dual_bound(sw: StagewiseQP, q, l, u, res: AdmmResult,
                         ext_u=None):
    """Certified lower bound from the final iterate (the stagewise analogue
    of ops/admm.py ``admm_dual_bound``): dualizes the dynamics rows (free
    sign) and the hard stage-inequality rows (clamped ≥ 0), keeps the
    variable box explicit and underestimates the inner box-QP by its
    tangent at the iterate. Soft rows' duals are zeroed and their penalty
    dropped; consensus duals are zeroed (this bounds the decoupled
    per-scenario relaxation, still a valid lower bound of the tree). Box
    widths of the unbounded stage variables come from
    ``_implied_box_stage``. The sums accumulate in float64."""
    nx, nc = sw.nx, sw.nc
    nbox = nx + nc
    bb = nbox + sw.b
    xi = res.x
    y = res.y.clone()
    y[..., nbox:bb] = 0.0                          # box rows not dualized
    y[..., nx:nbox] = y[..., nx:nbox].clamp_min(0.0)
    if sw.n_blk:
        # tied stages: equalities (free sign, rhs 0); leaders vacuous (0)
        y[..., bb:bb + sw.n_blk] *= sw.tie
    if sw.n_term:
        # one-sided; only the finite (last-stage) rows carry a dual
        i1 = bb + sw.n_blk
        ut = u[..., i1:i1 + sw.n_term]
        yt = y[..., i1:i1 + sw.n_term]
        y[..., i1:i1 + sw.n_term] = torch.where(ut < 0.9 * BIG,
                                                yt.clamp_min(0.0), 0.0)
    if sw.n_cons:
        y[..., bb + sw.n_blk + sw.n_term:] = 0.0
    if sw.has_soft:
        soft = (sw.soft_lin > 0) | (sw.soft_quad > 0)
        y = torch.where(soft, 0.0, y)
    w = q + _apply_AT(sw, y)
    S_ext = 0.0
    if sw.n_ext:
        # one-sided A_e x ≤ u_e: dual ≥ 0, zero on vacuous BIG rows
        if ext_u is None:
            raise ValueError("sw has n_ext extra rows: pass ext_u")
        ye = res.y_ext.clamp_min(0.0)
        ye = torch.where(ext_u < 0.9 * BIG, ye, 0.0)
        w = w + torch.einsum("rkb,...r->...kb", sw.Aext, ye)
        S_ext = (ext_u.double() * ye.double()).sum(-1)
    Px = _apply_P(sw, xi)
    grad = Px + w
    lbe, ube = _implied_box_stage(sw, l, u)
    tangent = _dsum(torch.minimum(grad * (lbe - xi), grad * (ube - xi)))
    f0 = 0.5 * _dsum(xi * Px) + _dsum(w * xi)
    # S over the dualized rows: dyn l=u → u·y; ineq y ≥ 0 → u·y; blk tied
    # rows u=0 and term finite rows u=f_t (the masked y zeroes BIG rows)
    S = (_dsum(u[..., :nbox] * y[..., :nbox])
         + _dsum(u[..., bb:] * y[..., bb:]) + S_ext)
    return (f0 + tangent - S).float()


def _implied_box_stage(sw: StagewiseQP, l, u, passes: int = 2):
    """Implied variable boxes for the tangent bound, from the per-stage
    rows over ζ_k = (x_k, v_k, x_{k+1}):

        ineq_k:  E x_k + Fv v_k ≤ u_ineq_k        (soft rows masked out)
        dyn_k:  ±(x_{k+1} − A x_k − Bv v_k) ≤ ±rhs_dyn_k   (equality)

    x_k is ξ_{k−1}'s x block (box [0, 0] at k=0: x_0's terms are folded
    into l/u). All stages tighten at once; ``passes`` rounds carry
    information across neighbouring stages through the shared x blocks."""
    nx, nc, nv = sw.nx, sw.nc, sw.nv
    nbox = nx + nc
    dt, dev = l.dtype, l.device
    Z = torch.zeros((nc, nx), dtype=dt, device=dev)
    I = torch.eye(nx, dtype=dt, device=dev)
    M = torch.cat([
        torch.cat([sw.E, sw.Fv, Z], dim=1),
        torch.cat([-sw.A_dyn, -sw.Bv, I], dim=1),
        torch.cat([sw.A_dyn, sw.Bv, -I], dim=1),
    ], dim=0)                                     # (nc+2nx, nx+nv+nx)
    u_ineq = u[..., nx:nbox]
    if sw.has_soft:
        soft_i = ((sw.soft_lin > 0) | (sw.soft_quad > 0))[..., nx:nbox]
        u_ineq = torch.where(soft_i, BIG, u_ineq)
    rhs_dyn = u[..., :nx]
    rhs = torch.cat([u_ineq, rhs_dyn, -rhs_dyn], dim=-1)
    # box rows only (blocking/terminal rows do not join: skipping rows is
    # always valid)
    lb_box = l[..., nbox:nbox + sw.b]             # (…, N, b) [v_k; x_{k+1}]
    ub_box = u[..., nbox:nbox + sw.b]
    for _ in range(passes):
        lz = torch.cat([_prev(lb_box[..., nv:]), lb_box], dim=-1)
        uz = torch.cat([_prev(ub_box[..., nv:]), ub_box], dim=-1)
        lz, uz = _implied_box(M, rhs, lz, uz, passes=1)
        # v_k and x_{k+1} from stage k; x_{k+1} also from stage k+1's
        # leading x_k columns (shifted back): intersect
        lx_next = torch.cat([lz[..., 1:, :nx],
                             torch.full_like(lz[..., :1, :nx], -BIG)], dim=-2)
        ux_next = torch.cat([uz[..., 1:, :nx],
                             torch.full_like(uz[..., :1, :nx], BIG)], dim=-2)
        lb_box = torch.cat([lz[..., nx:nx + nv],
                            torch.maximum(lz[..., nx + nv:], lx_next)], dim=-1)
        ub_box = torch.cat([uz[..., nx:nx + nv],
                            torch.minimum(uz[..., nx + nv:], ux_next)], dim=-1)
    return lb_box, ub_box


def assemble_stagewise(sw: StagewiseQP, x0, W=None, price_seq=None,
                       u_prev=None):
    """Per-solve data: q (N, b), l/u (N, m_k) from (x0, forecast W (N, nw),
    prices (N, nv), previous input u_prev (nu,): the Δu_0 = u_0 − u_prev
    linear term, used only with Rdu weights)."""
    N, nx, nc, nv = sw.N, sw.nx, sw.nc, sw.nv
    q = sw.q0.clone()
    if price_seq is not None:
        q[:, :nv] += price_seq
    if u_prev is not None and sw.Rdu2.shape[0] > 0:
        nu = sw.Rdu2.shape[0]
        q[0, :nu] -= u_prev @ sw.Rdu2.T
    # y-output cost data: y_k's data part is D4 ω_k (+ C x_0 at k=0)
    ydat0 = x0 @ sw.Cy.T                           # (ny,)
    if W is not None and sw.D4y.shape[1] > 0:
        yw = W @ sw.D4y.T                          # (N, ny)
        ydat0 = ydat0 + yw[0]
        q[1:, :nv] += yw[1:] @ sw.M_vy.T
        q[:-1, nv:] += yw[1:] @ sw.M_xy.T
    q[0, :nv] += ydat0 @ sw.M_vy.T
    dyn_rhs = sw.b5.expand(N, nx).clone()
    ineq_ub = sw.f5.expand(N, nc).clone()
    if W is not None and sw.B4.shape[1] > 0:
        dyn_rhs = dyn_rhs + W @ sw.B4.T
        ineq_ub = ineq_ub - W @ sw.F4.T
    # k=0: x_0 is data → its A/E terms move to the bounds
    dyn_rhs[0] += x0 @ sw.A_dyn.T
    ineq_ub[0] -= x0 @ sw.E.T
    full = dict(dtype=q.dtype, device=q.device)
    l_parts = [dyn_rhs, torch.full((N, nc), -BIG, **full), sw.lb_xi]
    u_parts = [dyn_rhs, ineq_ub, sw.ub_xi]
    if sw.n_blk:
        # tied stages: equality u_k − u_{k−1} = 0; leaders: vacuous
        tied = sw.tie > 0
        l_parts.append(torch.where(tied, 0.0, -BIG).to(q.dtype))
        u_parts.append(torch.where(tied, 0.0, BIG).to(q.dtype))
    if sw.n_term:
        l_parts.append(torch.full((N, sw.n_term), -BIG, **full))
        u_term = torch.full((N, sw.n_term), BIG, **full)
        u_term[N - 1] = sw.ft
        u_parts.append(u_term)
    if sw.n_cons:
        # consensus rows never clip: the tree solver's z-update replaces
        # them with the group mean
        l_parts.append(torch.full((N, sw.n_cons), -BIG, **full))
        u_parts.append(torch.full((N, sw.n_cons), BIG, **full))
    return q, torch.cat(l_parts, dim=-1), torch.cat(u_parts, dim=-1)


def _with_box(sw: StagewiseQP, l, u, lb_xi, ub_xi):
    """l/u with their box rows replaced by node boxes lb_xi/ub_xi
    (…, N, b), broadcast to the common batch."""
    nbox = sw.nx + sw.nc
    batch = torch.broadcast_shapes(l.shape[:-2], lb_xi.shape[:-2])
    l = l.expand(batch + l.shape[-2:]).clone()
    u = u.expand(batch + u.shape[-2:]).clone()
    l[..., nbox:nbox + sw.b] = lb_xi
    u[..., nbox:nbox + sw.b] = ub_xi
    return l, u


def _admm_iterations(sw: StagewiseQP, q, l, u, x, z, y, z_e, y_e, ext_u,
                     iters: int, consensus_M=None, sweep=None):
    """``iters`` stagewise ADMM iterations in torch from the carries (x, z,
    y) and, with extra rows, (z_e, y_e): the plain version of K5 (the
    reference's ``fori_loop`` body). z starts inside [l, u]; q, l, u, ext_u
    broadcast to the carries' batch. ``sweep(sw, t)`` is K⁻¹t (``_solve_K``,
    the default, ``_solve_K_assoc`` or K4). ``consensus_M`` (S, S, N): the
    z-update of the trailing ``n_cons`` rows is the p-weighted group mean
    over the scenario axis (dim −3 of the (…, S, N, n_cons) block); or a
    function of that block that returns the means (the scenario axis split
    over ranks: ops/stagewise_tree.py). Returns
    (x, z, y, dy, z_e, y_e, dy_e): dy and dy_e the last iteration's dual
    steps (zeros after no iteration); the extra rows' three are None
    without extra rows."""
    sweep = _solve_K if sweep is None else sweep
    rho = sw.rho_rows
    alpha, sigma = sw.alpha, sw.sigma
    soft = (sw.soft_lin > 0) | (sw.soft_quad > 0)     # (N, m_k)
    mc = sw.m_k - sw.n_cons                           # consensus rows
    r_ext = sw.n_ext
    rho_e = sw.rho_ext

    def z_update(s):
        """Box projection on hard rows; the exact penalty prox on soft rows
        (upper side: min lin·t + quad·t² + ρ/2(z−s)², t = (z−u)₊); the
        group mean on the trailing n_cons rows."""
        z_new = torch.clamp(s, l, u)
        if sw.has_soft:
            t = (rho * (s - u) - sw.soft_lin) / (rho + 2.0 * sw.soft_quad)
            z_soft = torch.where(s > u, u + t.clamp_min(0.0),
                                 torch.maximum(s, l))
            z_new = torch.where(soft, z_soft, z_new)
        if callable(consensus_M) and sw.n_cons:
            z_new = torch.cat([z_new[..., :mc], consensus_M(s[..., mc:])],
                              dim=-1)
        elif consensus_M is not None and sw.n_cons:
            z_new = torch.cat([z_new[..., :mc], torch.einsum(
                "stk,...tkj->...skj", consensus_M, s[..., mc:])], dim=-1)
        return z_new

    dy = torch.zeros_like(y)
    dy_e = torch.zeros_like(y_e) if r_ext else None
    for it in range(iters):
        t = sigma * x - q + _apply_AT(sw, rho * z - y)
        if r_ext:
            t = t + torch.einsum("rkb,...r->...kb", sw.Aext, rho_e * z_e - y_e)
        x = _solve_K_bordered(sw, t, sweep)
        zr = alpha * _apply_A(sw, x) + (1.0 - alpha) * z
        z = z_update(zr + y / rho)
        y_new = y + rho * (zr - z)
        if it == iters - 1:
            dy = y_new - y
        y = y_new
        if r_ext:
            zr_e = (alpha * torch.einsum("rkb,...kb->...r", sw.Aext, x)
                    + (1.0 - alpha) * z_e)
            z_e = torch.minimum(zr_e + y_e / rho_e, ext_u)
            y_e_new = y_e + rho_e * (zr_e - z_e)
            if it == iters - 1:
                dy_e = y_e_new - y_e
            y_e = y_e_new
    return x, z, y, dy, z_e, y_e, dy_e


def _certificate(sw: StagewiseQP, dy, dy_e, l, u, ext_u):
    """The primal-infeasibility certificate (ops/admm.py) of the last dual
    steps dy (…, N, m_k) and, with extra rows, dy_e (…, r): (cert, ratios),
    ratios (…, 3) the three quantities it tests over ‖δy‖∞ — ‖Aᵀδy‖∞ and
    the support sum (each at most 1e-4 for a certificate) and minus the gap
    sum (at least 1e-4). Soft rows can never witness infeasibility, nor can
    the consensus rows (cross-scenario infeasibility is not certified), so
    their dy is masked out."""
    if sw.has_soft:
        dy = torch.where((sw.soft_lin > 0) | (sw.soft_quad > 0), 0.0, dy)
    if sw.n_cons:
        mc = sw.m_k - sw.n_cons
        dy = torch.cat([dy[..., :mc], torch.zeros_like(dy[..., mc:])],
                       dim=-1)
    dy_norm = dy.abs().amax(dim=(-2, -1)).double()
    Atdy_full = _apply_AT(sw, dy)
    if sw.n_ext:
        Atdy_full = Atdy_full + torch.einsum("rkb,...r->...kb", sw.Aext,
                                             dy_e)
    Atdy = Atdy_full.abs().amax(dim=(-2, -1)).double()
    fin_u = u < 0.9 * BIG
    fin_l = l > -0.9 * BIG
    dyp = dy.clamp_min(0.0).double()
    dyn_ = dy.clamp_max(0.0).double()
    support = (torch.where(~fin_u, dyp, 0.0).sum(dim=(-2, -1))
               + torch.where(~fin_l, -dyn_, 0.0).sum(dim=(-2, -1)))
    gap_term = (torch.where(fin_u, u.double() * dyp, 0.0).sum(dim=(-2, -1))
                + torch.where(fin_l, l.double() * dyn_, 0.0).sum(dim=(-2, -1)))
    if sw.n_ext:
        # extra rows are one-sided: a negative dy_e witnesses the unbounded
        # lower side; a positive one adds u_e (finite) to the gap term
        dy_norm = torch.maximum(dy_norm, dy_e.abs().amax(dim=-1).double())
        dyp_e = dy_e.clamp_min(0.0).double()
        fin_ue = ext_u < 0.9 * BIG
        support = (support + (-dy_e.clamp_max(0.0).double()).sum(-1)
                   + torch.where(~fin_ue, dyp_e, 0.0).sum(-1))
        gap_term = gap_term + torch.where(
            fin_ue, ext_u.double() * dyp_e, 0.0).sum(-1)
    eps_c = 1e-4
    cert = ((dy_norm > 1e-12) & (Atdy <= eps_c * dy_norm)
            & (support <= eps_c * dy_norm)
            & (gap_term <= -eps_c * dy_norm))
    dn = dy_norm.clamp_min(1e-300)
    return cert, torch.stack([Atdy / dn, support / dn, -gap_term / dn], -1)


def _admm_route(sw: StagewiseQP, device, parallel_sweeps: bool,
                consensus_M=None):
    """(function, keywords) that run a solve's iterations on ``device``,
    decided from the shapes before any launch: on the CPU the plain loop,
    its sweep ``_solve_K`` or, with ``parallel_sweeps``,
    ``_solve_K_assoc``. On the card one launch of K5 (``sw_admm_cuda``;
    with ``parallel_sweeps`` its parallel sweep) wherever K5 has an
    instantiation for the shape (``cuda_stagewise.k5_plan``); elsewhere
    (b above 128, a group that would leave a scenario under a warp, a
    group mean over ranks: ``consensus_M`` a function) the torch loop
    ``_admm_iterations`` with a hand-written sweep: K6 over windows with
    ``parallel_sweeps``, else K4 where it has a plan
    (``cuda_stagewise.k4_plan``) and K6 where it has none. Raises
    ValueError for another device."""
    if device.type == "cpu":
        return _admm_iterations, dict(
            sweep=_solve_K_assoc if parallel_sweeps else _solve_K)
    if device.type != "cuda":
        raise ValueError(f"no stagewise ADMM for device {device}")
    if not callable(consensus_M):
        mean = consensus_M is not None and sw.n_cons > 0
        S = consensus_M.shape[0] if mean else 1
        if cs.k5_plan(sw.N, sw.b, sw.m_k, S, sw.n_blk, sw.n_ext, sw.n_cons,
                      mean, parallel_sweeps) is not None:
            return sw_admm_cuda, (dict(parallel=True) if parallel_sweeps
                                  else {})
    if parallel_sweeps:
        return _admm_iterations, dict(sweep=_k6_windowed_sweep)
    if cs.k4_plan(sw.N, sw.b) is not None:
        return _admm_iterations, dict(sweep=_k4_sweep)
    return _admm_iterations, dict(sweep=_k6_sweep)


def stagewise_admm_solve(sw: StagewiseQP, q, l, u, iters: int = 200,
                         lb_xi=None, ub_xi=None, warm=None,
                         parallel_sweeps: bool = False,
                         consensus_M=None, ext_u=None,
                         warm_ext=None, consensus_z=None) -> AdmmResult:
    """Fixed-iteration ADMM in the stagewise frame. q (…, N, b), l/u
    (…, N, m_k) from ``assemble_stagewise``; optional node boxes
    lb_xi/ub_xi (…, N, b) override the box-row bounds (B&B); ``warm``:
    (x, z, y) of a prior result in this frame. The iterations run as one
    launch of K5 on a CUDA tensor and as ``_admm_iterations`` (torch, the
    plain sweeps) on a CPU tensor; another device raises. Where K5 has no
    instantiation for the shape, a CUDA tensor runs the torch loop with
    K4's or K6's sweep (``_admm_route``).
    ``parallel_sweeps``: the horizon-parallel sweeps, an algorithm of its
    own (module doc): on a CUDA tensor one launch of K5 with its parallel
    sweep, or the torch loop with K6's windowed sweep where K5 has no
    instantiation (a group mean over ranks included); on the CPU the torch
    loop with ``_solve_K_assoc``.
    ``consensus_M`` (S, S, N): the p-weighted group-mean weights
    (``StagewiseTreeQP.M``) that replace the z-update on the trailing
    ``n_cons`` rows over the scenario axis, dim −3 (their residual then
    measures |Ax − z| and their dy leaves the certificate); a function in
    its place computes the means itself (the scenario axis split over
    ranks): no one launch holds a mean that crosses ranks, so then the
    torch loop runs, its sweep K4 or K6 on the card. ``consensus_z``: the
    reference's name for such a function (the group-mean prox of the
    consensus rows, ``s[..., mc:]`` ↦ z); it takes ``consensus_M``'s place.
    ``ext_u``
    (…, r): required with extra rows (``assemble_stagewise_ext``); their
    z/y come back in ``res.z_ext``/``res.y_ext``; ``warm_ext``: (z_ext,
    y_ext) of a prior result."""
    if consensus_z is not None:
        if consensus_M is not None:
            raise ValueError("stagewise_admm_solve: pass consensus_M or "
                             "consensus_z, not both")
        consensus_M = consensus_z
    if lb_xi is not None:
        l, u = _with_box(sw, l, u, lb_xi, ub_xi)
    soft = (sw.soft_lin > 0) | (sw.soft_quad > 0)     # (N, m_k)
    any_soft = sw.has_soft
    batch = torch.broadcast_shapes(q.shape[:-2], l.shape[:-2])
    if warm is None:
        x = q.new_zeros(batch + (sw.N, sw.b))
        z = torch.clamp(q.new_zeros(batch + (sw.N, sw.m_k)), l, u)
        y = q.new_zeros(batch + (sw.N, sw.m_k))
    else:
        x, z, y = warm
        z = torch.clamp(z, l, u)

    r_ext = sw.n_ext
    z_e = y_e = None
    if r_ext:
        if ext_u is None:
            raise ValueError("sw has n_ext extra rows: pass ext_u from "
                             "assemble_stagewise_ext")
        if warm_ext is None:
            z_e = torch.clamp_max(q.new_zeros(batch + (r_ext,)), ext_u)
            y_e = torch.zeros_like(z_e)
        else:
            z_e, y_e = warm_ext
            z_e = torch.minimum(z_e, ext_u)
    mc = sw.m_k - sw.n_cons                           # consensus rows

    carries = (sw, q, l, u, x, z, y, z_e, y_e, ext_u, iters, consensus_M)
    run, kw = _admm_route(sw, q.device, parallel_sweeps, consensus_M)
    x, z, y, dy, z_e, y_e, dy_e = run(*carries, **kw)

    Ax = _apply_A(sw, x)
    # hard rows: distance to the box; soft rows: the split gap |Ax − z|
    # (violation beyond the bound is allowed, and paid in the objective)
    viol = torch.abs(Ax - torch.clamp(Ax, l, u))
    if any_soft:
        viol = torch.where(soft, torch.abs(Ax - z), viol)
    if consensus_M is not None and sw.n_cons:
        # consensus rows: the non-anticipativity residual (z = group mean)
        viol = torch.cat([viol[..., :mc], torch.abs(Ax - z)[..., mc:]],
                         dim=-1)
    r_prim = viol.amax(dim=(-2, -1))
    r_rel = (viol / torch.clamp_min(Ax.abs(), 1.0)).amax(dim=(-2, -1))
    Px = _apply_P(sw, x)
    dual = Px + q + _apply_AT(sw, y)
    if r_ext:
        Ax_e = torch.einsum("rkb,...kb->...r", sw.Aext, x)
        viol_e = torch.clamp_min(Ax_e - ext_u, 0.0)    # one-sided upper
        r_prim = torch.maximum(r_prim, viol_e.amax(dim=-1))
        r_rel = torch.maximum(
            r_rel, (viol_e / torch.clamp_min(Ax_e.abs(), 1.0)).amax(dim=-1))
        dual = dual + torch.einsum("rkb,...r->...kb", sw.Aext, y_e)
    r_dual = dual.abs().amax(dim=(-2, -1))
    obj = 0.5 * _dsum(x * Px) + _dsum(q * x)
    if any_soft:
        sviol = torch.where(soft, torch.clamp_min(Ax - u, 0.0), 0.0)
        obj = obj + _dsum(sw.soft_lin * sviol + sw.soft_quad * sviol * sviol)
    obj = obj.float()
    cert = _certificate(sw, dy, dy_e, l, u, ext_u)[0]
    return AdmmResult(x=x, obj=obj, r_prim=r_prim, r_prim_rel=r_rel,
                      r_dual=r_dual, infeas_cert=cert, y=y, z=z,
                      z_ext=(z_e if r_ext else None),
                      y_ext=(y_e if r_ext else None))
