"""Horizon condensation: MLD model + horizon N → one MIQP per control step.

Counterpart of ``pyhybridcontrol_tpu/ops/condense.py``: ``CondensedMpc``
with its transforms, ``assemble_np``, ``device_qp`` and ``DeviceQP``. The
host code is the reference's numpy float64 code unchanged; only the
device form differs: ``DeviceQP`` holds fp32 torch tensors on one device
and assembles the per-step data with torch matmuls (TF32 is off — see
ops/admm.py).

Prediction operators over the horizon:

    X̃ = [x_0; …; x_{N-1}] = Φ̃ x0 + Γ̃v V + Γ̃ω W + Γ̃c      (constraints)
    X  = [x_1; …; x_N]     = Φ  x0 + Γv V + Γω W + Γc       (cost/terminal)

with V = [v_0; …; v_{N-1}], v_k = [u_k; δ_k; z_k]. Stacked stage
constraints  E x_k + Fv v_k + F4 ω_k ≤ f5  become

    G V ≤ h0 + Hx x0 + Hω W,
    G = Ē Γ̃v + F̄v,  h0 = f̄5 − Ē Γ̃c,  Hx = −Ē Φ̃,  Hω = −(Ē Γ̃ω + F̄ω).

An optional terminal set E_N x_N ≤ f_N appends rows; ``v_lb``/``v_ub``
bound the continuous entries of every v_k. The transforms — horizon-
coupled extra rows, move blocking, soft constraints and the root
presolve (ops/presolve.py) — each return a new ``CondensedMpc``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
from pyhybridcontrol_tpu_torch.utils.matrix_utils import (
    block_diag_rep,
    block_toeplitz,
    matrix_powers,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

BIG = 1e30  # fp32-safe stand-in for ±inf in box bounds


@dataclasses.dataclass
class MpcWeights:
    """Per-variable-class MPC weights (reference ``set_std_obj_weights``).

    All optional; shapes: Qx (nx,nx) or (nx,), Ru (nu,nu) or (nu,), etc.
    Linear weights are vectors. ``Rdu`` penalizes Δu_k = u_k − u_{k−1}
    (u_{−1} supplied at feedback). ``x_ref`` shifts the Qx/QxN terms.
    """

    Qx: Optional[np.ndarray] = None
    QxN: Optional[np.ndarray] = None
    qx: Optional[np.ndarray] = None
    qxN: Optional[np.ndarray] = None
    Ru: Optional[np.ndarray] = None
    ru: Optional[np.ndarray] = None
    Qdelta: Optional[np.ndarray] = None
    qdelta: Optional[np.ndarray] = None
    Rz: Optional[np.ndarray] = None
    rz: Optional[np.ndarray] = None
    Qy: Optional[np.ndarray] = None
    qy: Optional[np.ndarray] = None
    Rdu: Optional[np.ndarray] = None
    x_ref: Optional[np.ndarray] = None


def _sq(w, n):
    """Weight → (n, n) matrix (accept scalar / vector-diag / matrix)."""
    if w is None:
        return np.zeros((n, n))
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 0:
        return np.eye(n) * float(w)
    if w.ndim == 1:
        return np.diag(w)
    return w


def _vec(w, n):
    if w is None:
        return np.zeros(n)
    w = np.asarray(w, dtype=np.float64)
    if w.ndim == 0:
        return np.full(n, float(w))
    return w.reshape(n)


# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DeviceQP:
    """Condensed MPC MIQP in device (fp32 torch) form.

    min_V  ½ Vᵀ H V + f(x0,W,u_prev,q)ᵀ V
    s.t.   G V ≤ h(x0,W),   lb ≤ V ≤ ub,   V[binary_idx] ∈ {0,1}.
    """

    H: torch.Tensor
    f0: torch.Tensor
    Fx: torch.Tensor
    Fw: torch.Tensor
    Fup: torch.Tensor
    G: torch.Tensor
    h0: torch.Tensor
    Hx: torch.Tensor
    Hw: torch.Tensor
    lb: torch.Tensor
    ub: torch.Tensor
    T_full: torch.Tensor  # (N*nv, nV): decision → full per-step v sequence
    binary_idx: Tuple[int, ...]
    N: int
    info: MldInfo
    binary_shift: Tuple[int, ...] = ()

    @property
    def n(self) -> int:
        return self.H.shape[-1]

    @property
    def m(self) -> int:
        return self.G.shape[-2]

    @property
    def n_binary(self) -> int:
        return len(self.binary_idx)

    def assemble(self, x0, W=None, u_prev=None, price_seq=None):
        """Feedback-time RHS assembly: returns (f, h); leading batch dims
        of x0 / W broadcast."""
        f = self.f0 + x0 @ self.Fx.T
        h = self.h0 + x0 @ self.Hx.T
        if W is not None and self.Fw.shape[-1] > 0:
            Wf = W.reshape(W.shape[:-2] + (-1,)) if W.ndim >= 2 else W
            f = f + Wf @ self.Fw.T
            h = h + Wf @ self.Hw.T
        if u_prev is not None and self.Fup.shape[-1] > 0:
            f = f + u_prev @ self.Fup.T
        if price_seq is not None:
            f = f + price_seq.reshape(price_seq.shape[:-2] + (-1,)) \
                @ self.T_full
        return f, h

    def full_v(self, V):
        """Map solver decision V → (N, nv) per-step [u; δ; z] sequence."""
        seq = V @ self.T_full.T
        return seq.reshape(seq.shape[:-1] + (self.N, self.info.nv))


# ---------------------------------------------------------------------------


class CondensedMpc:
    """Host-side (numpy float64) condensed MPC problem builder.

    Usage:
        c = CondensedMpc(model, N, weights)
        c = c.with_move_blocking(groups)      # optional, before soft
        c = c.with_soft_constraints(rows, lin_pen, quad_pen)  # optional
        qp = c.device_qp()                    # fp32 tensors on the card
    """

    def __init__(self, model: MldModel, N: int,
                 weights: Optional[MpcWeights] = None,
                 v_lb: Optional[np.ndarray] = None,
                 v_ub: Optional[np.ndarray] = None,
                 terminal_E: Optional[np.ndarray] = None,
                 terminal_f: Optional[np.ndarray] = None,
                 reg: float = 1e-8):
        self.model = model
        self.info = info = model.info
        self.N = N
        self.weights = weights or MpcWeights()
        m = model.numpy_mats()
        nx, nv, nw = info.nx, info.nv, info.nomega

        Bv = np.hstack([m.B1, m.B2, m.B3])      # (nx, nv)
        Fv = np.hstack([m.F1, m.F2, m.F3])      # (nc, nv)
        Dv = np.hstack([m.D1, m.D2, m.D3])      # (ny, nv)

        pw = matrix_powers(m.A, N)              # [I … A^N]
        # x_0..x_{N-1} operators (constraints) and x_1..x_N (cost/terminal)
        Phi_t = np.vstack(pw[:N])               # (N nx, nx)
        Phi = np.vstack(pw[1 : N + 1])
        Gv_t = block_toeplitz(
            [np.zeros((nx, nv))] + [pw[k] @ Bv for k in range(N - 1)], N)
        Gv = block_toeplitz([pw[k] @ Bv for k in range(N)], N)
        Gw_t = block_toeplitz(
            [np.zeros((nx, nw))] + [pw[k] @ m.B4 for k in range(N - 1)], N)
        Gw = block_toeplitz([pw[k] @ m.B4 for k in range(N)], N)
        b5 = m.b5[:, 0]
        Gc_t = np.concatenate(
            [sum((pw[k - 1 - i] @ b5 for i in range(k)), np.zeros(nx))
             for k in range(N)])
        Gc = np.concatenate(
            [sum((pw[k - i] @ b5 for i in range(k + 1)), np.zeros(nx))
             for k in range(N)])

        # ---- stacked stage constraints ----
        E_bar = block_diag_rep(m.E, N)
        Fv_bar = block_diag_rep(Fv, N)
        Fw_bar = block_diag_rep(m.F4, N)
        f5_bar = np.tile(m.f5[:, 0], N)
        G = E_bar @ Gv_t + Fv_bar
        h0 = f5_bar - E_bar @ Gc_t
        Hx = -E_bar @ Phi_t
        Hw = -(E_bar @ Gw_t + Fw_bar)

        # ---- optional terminal constraint  E_N x_N ≤ f_N ----
        if terminal_E is not None:
            EN = np.atleast_2d(np.asarray(terminal_E, dtype=np.float64))
            fN = np.asarray(terminal_f, dtype=np.float64).reshape(-1)
            rowN = slice((N - 1) * nx, N * nx)
            G = np.vstack([G, EN @ Gv[rowN]])
            h0 = np.concatenate([h0, fN - EN @ Gc[rowN]])
            Hx = np.vstack([Hx, -EN @ Phi[rowN]])
            Hw = np.vstack([Hw, -EN @ Gw[rowN]])

        # ---- objective ----
        w = self.weights
        ny, nu = info.ny, info.nu
        Qx = _sq(w.Qx, nx)
        QxN = _sq(w.QxN, nx) if w.QxN is not None else Qx
        Rv = np.zeros((nv, nv))
        Rv[info.u_slice, info.u_slice] = _sq(w.Ru, nu)
        Rv[info.delta_slice, info.delta_slice] = _sq(w.Qdelta, info.ndelta)
        Rv[info.z_slice, info.z_slice] = _sq(w.Rz, info.nz)
        rv = np.concatenate([
            _vec(w.ru, nu), _vec(w.qdelta, info.ndelta), _vec(w.rz, info.nz)])

        # stage-x cost over x_1..x_N (x_0 is data: only the offset moves)
        Qbar = block_diag_rep(Qx, N)
        Qbar[(N - 1) * nx :, (N - 1) * nx :] = QxN
        qbar = np.concatenate([np.tile(_vec(w.qx, nx), N - 1),
                               _vec(w.qxN if w.qxN is not None else w.qx, nx)])
        if w.x_ref is not None:
            xr = np.tile(_vec(w.x_ref, nx), N)
            qbar = qbar - 2.0 * (Qbar @ xr)  # (x−r)'Q(x−r): −2 Q r linear part

        # User cost convention: J = Σ xᵀQx + qᵀx + vᵀRv + rᵀv (no ½s).
        # Internal form: min ½VᵀHV + fᵀV  ⇒  quadratic-derived terms get ×2.
        H = 2.0 * (Gv.T @ Qbar @ Gv + block_diag_rep(Rv, N))
        f0 = 2.0 * Gv.T @ (Qbar @ Gc) + Gv.T @ qbar + np.tile(rv, N)
        Fx = 2.0 * Gv.T @ Qbar @ Phi
        Fw = 2.0 * Gv.T @ Qbar @ Gw

        # output cost: y_k over k=0..N-1, Y = C̄ X̃ + D̄v V + D̄ω W + d̄5
        if w.Qy is not None or w.qy is not None:
            C_bar = block_diag_rep(m.C, N)
            Dv_bar = block_diag_rep(Dv, N)
            Dw_bar = block_diag_rep(m.D4, N)
            d5_bar = np.tile(m.d5[:, 0], N)
            Yv = C_bar @ Gv_t + Dv_bar          # (N ny, nV)
            Yc = C_bar @ Gc_t + d5_bar
            Yx = C_bar @ Phi_t
            Yw = C_bar @ Gw_t + Dw_bar
            Qy_bar = block_diag_rep(_sq(w.Qy, ny), N)
            qy_bar = np.tile(_vec(w.qy, ny), N)
            H += 2.0 * Yv.T @ Qy_bar @ Yv
            f0 += 2.0 * Yv.T @ (Qy_bar @ Yc) + Yv.T @ qy_bar
            Fx += 2.0 * Yv.T @ Qy_bar @ Yx
            Fw += 2.0 * Yv.T @ Qy_bar @ Yw

        # Δu rate cost: Δu_k = u_k − u_{k−1}, u_{−1} given at feedback.
        Fup = np.zeros((N * nv, nu))
        if w.Rdu is not None and nu > 0:
            Rdu = _sq(w.Rdu, nu)
            Su = np.zeros((N * nu, N * nv))    # select u parts of V
            for k in range(N):
                Su[k * nu : (k + 1) * nu,
                   k * nv : k * nv + nu] = np.eye(nu)
            Dmat = np.eye(N * nu)
            for k in range(1, N):
                Dmat[k * nu : (k + 1) * nu,
                     (k - 1) * nu : k * nu] = -np.eye(nu)
            DS = Dmat @ Su
            H += 2.0 * DS.T @ block_diag_rep(Rdu, N) @ DS
            # Δ = DS·V − E0·u_prev ⇒ f gets −2 DSᵀ R̄du E0 u_prev
            Fup = -2.0 * DS.T @ np.vstack(
                [Rdu] + [np.zeros((nu, nu))] * (N - 1))

        H = 0.5 * (H + H.T) + reg * np.eye(N * nv)

        # ---- variable bounds ----
        lb = np.full(N * nv, -np.inf)
        ub = np.full(N * nv, np.inf)
        vb = info.v_binary_mask
        for k in range(N):
            s = slice(k * nv, (k + 1) * nv)
            lb[s] = np.where(vb, 0.0, v_lb if v_lb is not None else -np.inf)
            ub[s] = np.where(vb, 1.0, v_ub if v_ub is not None else np.inf)

        self.H, self.f0, self.Fx, self.Fw, self.Fup = H, f0, Fx, Fw, Fup
        self.G, self.h0, self.Hx, self.Hw = G, h0, Hx, Hw
        self.lb, self.ub = lb, ub
        self.T_full = np.eye(N * nv)
        self.binary_mask = np.tile(vb, N)
        # stage rows carrying z coefficients = the big-M product rows; they
        # bind as (near-)equalities at every fixed-binary B&B leaf, so the
        # ADMM layer boosts their rho statically
        z_stage = np.nonzero(np.abs(m.F3).sum(axis=1) > 0)[0]
        self.z_rows = (np.concatenate(
            [k * info.ncons + z_stage for k in range(N)]) if len(z_stage)
            else np.zeros(0, dtype=int))
        self.pred = StructDict(Phi=Phi, Gv=Gv, Gw=Gw, Gc=Gc,
                               Phi_t=Phi_t, Gv_t=Gv_t, Gw_t=Gw_t, Gc_t=Gc_t)

        # ---- binary states: one auxiliary BINARY d per (k, i) tied to the
        # predicted state by an equality pair  Γv[r]·V − d = −Φ[r]x0 − … ----
        xb_idx = np.nonzero([t == "b" for t in info.x_types])[0]
        self.n_state_aux = 0
        self.n_soft = 0
        if len(xb_idx):
            rows_r = np.concatenate(
                [k * nx + xb_idx for k in range(N)])      # x_1..x_N rows
            na = len(rows_r)
            self.n_state_aux = na
            nV0 = self.H.shape[0]
            self.H = np.block([[self.H, np.zeros((nV0, na))],
                               [np.zeros((na, nV0)), reg * np.eye(na)]])
            self.f0 = np.concatenate([self.f0, np.zeros(na)])
            self.Fx = np.vstack([self.Fx, np.zeros((na, nx))])
            self.Fw = np.vstack([self.Fw, np.zeros((na, self.Fw.shape[1]))])
            self.Fup = np.vstack([self.Fup,
                                  np.zeros((na, self.Fup.shape[1]))])
            Gtie = np.hstack([Gv[rows_r], -np.eye(na)])   # Γv V − d
            Gpad = np.hstack([self.G, np.zeros((self.G.shape[0], na))])
            base = Gpad.shape[0]
            self.G = np.vstack([Gpad, Gtie, -Gtie])
            self.h0 = np.concatenate([self.h0, -Gc[rows_r], Gc[rows_r]])
            self.Hx = np.vstack([self.Hx, -Phi[rows_r], Phi[rows_r]])
            self.Hw = np.vstack([self.Hw, -Gw[rows_r], Gw[rows_r]])
            self.lb = np.concatenate([self.lb, np.zeros(na)])
            self.ub = np.concatenate([self.ub, np.ones(na)])
            self.binary_mask = np.concatenate(
                [self.binary_mask, np.ones(na, dtype=bool)])
            self.T_full = np.hstack(
                [self.T_full, np.zeros((self.T_full.shape[0], na))])
            self.z_rows = np.concatenate(
                [self.z_rows, base + np.arange(2 * na)])

    # -- transforms ------------------------------------------------------------
    def _clone(self) -> "CondensedMpc":
        c = CondensedMpc.__new__(CondensedMpc)
        c.__dict__.update(self.__dict__)
        return c

    def with_move_blocking(self, groups: Sequence[int],
                           block_deltas: bool = False) -> "CondensedMpc":
        """Move blocking: hold the INPUT u constant within step-groups;
        δ and z stay per-step (they are consequences of the trajectory:
        blocking a startup indicator δ makes any turn-on infeasible).
        ``groups[k]`` is the block id of step k (nondecreasing, from 0).
        Binary inputs shrink from N·nub to B·nub branching variables.
        ``block_deltas=True`` blocks u and δ jointly."""
        info, N, nv = self.info, self.N, self.info.nv
        groups = list(groups)
        if len(groups) != N:
            raise ValueError("groups must have length N")
        B = max(groups) + 1
        nblk = info.nu + (info.ndelta if block_deltas else 0)
        nstep = nv - nblk                    # per-step: (δ,) z
        nVb = B * nblk + N * nstep
        T = np.zeros((N * nv, nVb))
        for k in range(N):
            g = groups[k]
            T[k * nv : k * nv + nblk,
              g * nblk : (g + 1) * nblk] = np.eye(nblk)
            T[k * nv + nblk : (k + 1) * nv,
              B * nblk + k * nstep : B * nblk + (k + 1) * nstep] = (
                np.eye(nstep))
        n_extra = self.nV - N * nv    # binary-state aux cols stay 1:1
        if n_extra:
            T = np.block([[T, np.zeros((N * nv, n_extra))],
                          [np.zeros((n_extra, T.shape[1])),
                           np.eye(n_extra)]])
        return self._apply_T(T)

    def _apply_T(self, T: np.ndarray) -> "CondensedMpc":
        c = self._clone()
        c.H = 0.5 * ((T.T @ self.H @ T) + (T.T @ self.H @ T).T)
        c.f0 = T.T @ self.f0
        c.Fx = T.T @ self.Fx
        c.Fw = T.T @ self.Fw
        c.Fup = T.T @ self.Fup
        c.G = self.G @ T
        c.T_full = self.T_full @ T
        # bounds/binaries: column j of T selects rows of the old decision
        nVb = T.shape[1]
        lb = np.full(nVb, -np.inf)
        ub = np.full(nVb, np.inf)
        bm = np.zeros(nVb, dtype=bool)
        for j in range(nVb):
            rows = np.nonzero(T[:, j])[0]
            lb[j] = np.max(self.lb[rows])
            ub[j] = np.min(self.ub[rows])
            bm[j] = bool(np.any(self.binary_mask[rows]))
        c.lb, c.ub, c.binary_mask = lb, ub, bm
        return c

    def with_root_presolve(self, passes: int = 3) -> "CondensedMpc":
        """Root presolve (ops/presolve.py): fp64 interval bound
        tightening + big-M coefficient tightening over the constant-rhs
        rows. The MIQP's binary slices are kept exactly, so the optimum is
        unchanged while every relaxation in the tree gets tighter. Apply
        it last (it reads the final G/lb/ub frame); row and column layout
        are unchanged."""
        from pyhybridcontrol_tpu_torch.ops.presolve import tighten_condensed

        const_rows = ((np.abs(self.Hx).sum(axis=1) == 0)
                      & (np.abs(self.Hw).sum(axis=1) == 0))
        G, h0, lb, ub = tighten_condensed(
            self.G, self.h0, self.lb, self.ub, self.binary_mask,
            const_rows, passes=passes)
        c = self._clone()
        c.G, c.h0, c.lb, c.ub = G, h0, lb, ub
        return c

    def with_extra_constraints(self, A_v: np.ndarray, b: np.ndarray,
                               B_x: Optional[np.ndarray] = None,
                               B_w: Optional[np.ndarray] = None
                               ) -> "CondensedMpc":
        """Append horizon-coupled rows ``A_v · V_full ≤ b + B_x x0 + B_w W``
        with ``A_v`` in the FULL per-step-v layout (N·nv columns):
        cross-step logic such as min-up/min-down unit commitment, which
        MLD stage rows (one step each) cannot express."""
        A_v = np.atleast_2d(np.asarray(A_v, np.float64))
        r = A_v.shape[0]
        if A_v.shape[1] != self.T_full.shape[0]:
            raise ValueError(
                f"A_v has {A_v.shape[1]} cols, expected "
                f"{self.T_full.shape[0]} (N*nv full-v layout)")
        c = self._clone()
        c.G = np.vstack([self.G, A_v @ self.T_full])
        c.h0 = np.concatenate([self.h0, np.asarray(b, np.float64).reshape(r)])
        Bx = (np.zeros((r, self.Hx.shape[1])) if B_x is None
              else np.atleast_2d(np.asarray(B_x, np.float64)))
        Bw = (np.zeros((r, self.Hw.shape[1])) if B_w is None
              else np.atleast_2d(np.asarray(B_w, np.float64)))
        c.Hx = np.vstack([self.Hx, Bx])
        c.Hw = np.vstack([self.Hw, Bw])
        return c

    def with_soft_constraints(self, rows: Sequence[int],
                              lin_pen=1e3, quad_pen=0.0) -> "CondensedMpc":
        """Soften constraint ``rows`` with slacks s ≥ 0 (upper bound +inf):
        G_r V − s_r ≤ h_r, penalty  lin_penᵀ s + sᵀ diag(quad_pen) s (the
        no-½ user cost convention of MpcWeights)."""
        rows = np.asarray(list(rows), dtype=int)
        ns = len(rows)
        nV = self.H.shape[0]
        lam = _vec(lin_pen, ns)
        mu = _vec(quad_pen, ns)
        c = self._clone()
        c.H = np.block([
            [self.H, np.zeros((nV, ns))],
            [np.zeros((ns, nV)), 2.0 * np.diag(mu) + 1e-8 * np.eye(ns)]])
        c.f0 = np.concatenate([self.f0, lam])
        c.Fx = np.vstack([self.Fx, np.zeros((ns, self.Fx.shape[1]))])
        c.Fw = np.vstack([self.Fw, np.zeros((ns, self.Fw.shape[1]))])
        c.Fup = np.vstack([self.Fup, np.zeros((ns, self.Fup.shape[1]))])
        Ssel = np.zeros((self.G.shape[0], ns))
        Ssel[rows, np.arange(ns)] = 1.0
        c.G = np.hstack([self.G, -Ssel])
        c.T_full = np.hstack([self.T_full,
                              np.zeros((self.T_full.shape[0], ns))])
        c.lb = np.concatenate([self.lb, np.zeros(ns)])
        c.ub = np.concatenate([self.ub, np.full(ns, np.inf)])
        c.binary_mask = np.concatenate([self.binary_mask,
                                        np.zeros(ns, dtype=bool)])
        c.n_soft = self.n_soft + ns
        return c

    # -- host-side assembly (oracle path, float64) --------------------------
    def assemble_np(self, x0, W=None, u_prev=None, price_seq=None):
        f = self.f0 + self.Fx @ np.asarray(x0, dtype=np.float64)
        h = self.h0 + self.Hx @ np.asarray(x0, dtype=np.float64)
        if W is not None and self.Fw.shape[1] > 0:
            Wf = np.asarray(W, dtype=np.float64).reshape(-1)
            f = f + self.Fw @ Wf
            h = h + self.Hw @ Wf
        if u_prev is not None and self.Fup.shape[1] > 0:
            f = f + self.Fup @ np.asarray(u_prev, dtype=np.float64)
        if price_seq is not None:
            f = f + self.T_full.T @ np.asarray(
                price_seq, dtype=np.float64).reshape(-1)
        return f, h

    # -- export -------------------------------------------------------------
    def _binary_shift_perm(self) -> tuple:
        """Stage-shift permutation over the binaries for the closed-loop
        shifted-plan warm start: entry j is the index of the binary holding
        the same per-stage slot one stage later (identity at the final
        stage). A binary column spanning several stages degrades the whole
        permutation to identity; a layout that is not stage-structured
        returns () (shift disabled)."""
        bidx = np.nonzero(self.binary_mask)[0]
        if len(bidx) == 0:
            return ()
        nv, N = self.info.nv, self.N
        if self.T_full.shape[0] != N * nv:
            return ()
        na = self.n_state_aux
        aux_lo = self.nV - self.n_soft - na   # aux cols: [aux_lo, aux_lo+na)
        nxb = na // N if na else 0
        stage_slot = []
        for bj in bidx:
            rows = np.nonzero(np.abs(self.T_full[:, bj]) > 1e-9)[0]
            if len(rows):
                if len({int(r) // nv for r in rows}) > 1:
                    return tuple(range(len(bidx)))   # blocked → identity
                r = rows[-1]
                stage_slot.append((r // nv, r % nv))
            elif na and aux_lo <= bj < aux_lo + na:
                a = bj - aux_lo
                stage_slot.append((a // nxb, nv + (a % nxb)))
            else:
                stage_slot.append(None)
        pos = {}
        for j, ss in enumerate(stage_slot):
            if ss is not None and ss in pos:
                return ()                  # ambiguous layout — disable
            pos[ss] = j
        return tuple(
            j if ss is None else pos.get((ss[0] + 1, ss[1]), j)
            for j, ss in enumerate(stage_slot))

    def device_qp(self, device=DEFAULT_DEVICE,
                  dtype=torch.float32) -> DeviceQP:
        device = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a, np.float64), dtype=dtype,
                                   device=device)

        return DeviceQP(
            H=t(self.H), f0=t(self.f0), Fx=t(self.Fx), Fw=t(self.Fw),
            Fup=t(self.Fup), G=t(self.G), h0=t(self.h0), Hx=t(self.Hx),
            Hw=t(self.Hw),
            lb=t(np.clip(self.lb, -BIG, BIG)),
            ub=t(np.clip(self.ub, -BIG, BIG)),
            T_full=t(self.T_full),
            binary_idx=tuple(int(i) for i in np.nonzero(self.binary_mask)[0]),
            N=self.N,
            info=self.info,
            binary_shift=self._binary_shift_perm(),
        )

    @property
    def nV(self) -> int:
        return self.H.shape[0]

    @property
    def binary_idx(self) -> np.ndarray:
        return np.nonzero(self.binary_mask)[0]
