"""Horizon condensation: MLD model + horizon N → one MIQP per control step.

Counterpart of ``pyhybridcontrol_tpu/ops/condense.py`` (base
``CondensedMpc``, ``assemble_np``, ``device_qp`` and ``DeviceQP``). The
host builder is the reference's numpy float64 code unchanged; only the
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

The transforms (move blocking, soft constraints, extra rows, root
presolve), the terminal set and per-variable v bounds are not ported yet
(ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.utils.matrix_utils import (
    block_diag_rep,
    block_toeplitz,
    matrix_powers,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

BIG = 1e30  # fp32-safe stand-in for ±inf in box bounds
REG = 1e-8  # Hessian regularization (the reference's default)


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
        qp = c.device_qp(device)              # fp32 tensors on the card
    """

    def __init__(self, model: MldModel, N: int,
                 weights: Optional[MpcWeights] = None):
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

        H = 0.5 * (H + H.T) + REG * np.eye(N * nv)

        # ---- variable bounds ----
        lb = np.full(N * nv, -np.inf)
        ub = np.full(N * nv, np.inf)
        vb = info.v_binary_mask
        for k in range(N):
            s = slice(k * nv, (k + 1) * nv)
            lb[s] = np.where(vb, 0.0, -np.inf)
            ub[s] = np.where(vb, 1.0, np.inf)

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
                               [np.zeros((na, nV0)), REG * np.eye(na)]])
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

    def device_qp(self, device="cpu", dtype=torch.float32) -> DeviceQP:
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
