"""Domestic electric water heater (DEWH) MLD model: thermal dynamics, a
binary heater switch and a stochastic hot-water-draw disturbance ω, plus
unit-commitment (startup) logic for benchmark config 3.

Counterpart of ``pyhybridcontrol_tpu/models/dewh.py`` (the same float64
numpy code; the model is materialized from an ``MldTemplate``).

Thermal model (single-node tank, linearized draw loss):

    T⁺ = a·T + b·u + c + d·ω
    a = exp(−U·A·Ts / C_w)                     ambient losses
    b = (1−a)·P_h / (U·A)                      heater gain (steady-state form)
    c = (1−a)·T_amb                            ambient pull
    d = −ΔT_nom·ρc·V_draw_unit / C_w           draw energy loss, ω = draw
                                               volume in [0,1] units

State x = [T, m] with m ∈ {0,1} the previous heater state (binary state,
memory for switching logic). Input u ∈ {0,1} (binary heater). Auxiliary
binary δ_s = startup indicator (δ_s = u ∧ ¬m):

    δ_s ≥ u − m;   δ_s ≤ u;   δ_s ≤ 1 − m        (exact for binary u,m)

Comfort band T_min ≤ T ≤ T_max enters as (softenable) stage rows.
Min-up/min-down over the horizon are cross-step rows built by
``min_up_down_rows`` for ``CondensedMpc.with_extra_constraints``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.mld.symbolic import MldTemplate
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights


@dataclasses.dataclass
class DewhParams:
    Ts: float = 900.0           # s (15 min)
    C_w: float = 1.2e6          # J/K  (≈ 300 L tank)
    UA: float = 2.5             # W/K
    P_h: float = 3000.0         # W heater power
    T_amb: float = 20.0         # °C
    dT_draw: float = 12.0       # °C temperature drop per unit draw
    T_min: float = 50.0
    T_max: float = 75.0


def dewh_matrices(Ts, C_w, UA, P_h, T_amb, dT_draw, T_min, T_max):
    a = float(np.exp(-UA * Ts / C_w))
    b = (1.0 - a) * P_h / UA
    c = (1.0 - a) * T_amb
    d = -dT_draw

    # x = [T, m]; u = [heater]; δ = [startup]; ω = [draw]
    A = np.array([[a, 0.0], [0.0, 0.0]])
    B1 = np.array([[b], [1.0]])          # m⁺ = u
    B2 = np.zeros((2, 1))
    B4 = np.array([[d], [0.0]])
    b5 = np.array([c, 0.0])

    E, F1, F2, F4, f5 = [], [], [], [], []

    def row(e=(0.0, 0.0), f1=0.0, f2=0.0, f4=0.0, rhs=0.0):
        E.append(list(e)); F1.append([f1]); F2.append([f2]); F4.append([f4])
        f5.append(rhs)

    # comfort band (soften these rows in the controller as needed)
    row(e=(1.0, 0.0), rhs=T_max)          # T ≤ T_max          (row 0)
    row(e=(-1.0, 0.0), rhs=-T_min)        # T ≥ T_min          (row 1)
    # heater box (binary handled by var-type, box keeps relaxation tight)
    row(f1=1.0, rhs=1.0)
    row(f1=-1.0, rhs=0.0)
    # startup logic: δ_s ≥ u − m;  δ_s ≤ u;  δ_s ≤ 1 − m
    row(e=(0.0, -1.0), f1=1.0, f2=-1.0, rhs=0.0)   # u − m − δs ≤ 0
    row(f1=-1.0, f2=1.0, rhs=0.0)                  # δs − u ≤ 0
    row(e=(0.0, 1.0), f2=1.0, rhs=1.0)             # δs + m ≤ 1

    return dict(A=A, B1=B1, B2=B2, B4=B4, b5=b5,
                C=np.array([[1.0, 0.0]]), E=np.array(E), F1=np.array(F1),
                F2=np.array(F2), F4=np.array(F4), f5=np.array(f5))


DEWH_INFO = MldInfo(nx=2, nu=1, ndelta=1, nz=0, nomega=1, ny=1, ncons=7,
                    x_types=("c", "b"), u_types=("b",))

dewh_template = MldTemplate(
    dewh_matrices,
    required=("Ts", "C_w", "UA", "P_h", "T_amb", "dT_draw", "T_min", "T_max"),
    info=DEWH_INFO)


def dewh_model(params: Optional[DewhParams] = None) -> MldModel:
    p = params or DewhParams()
    return dewh_template.materialize(dataclasses.asdict(p))


def dewh_weights(T_set: float = 60.0, q_comfort: float = 1.0,
                 q_startup: float = 0.1) -> MpcWeights:
    """Track a setpoint, penalize startups; energy cost arrives as the
    TOU price sequence at feedback time (price on u)."""
    return MpcWeights(
        Qx=np.array([q_comfort, 0.0]),
        qdelta=np.array([q_startup]),
        x_ref=np.array([T_set, 0.0]),
    )


def dewh_energy_price_seq(prices_per_kwh: np.ndarray, params: DewhParams,
                          nv: int = 2) -> np.ndarray:
    """Map a TOU tariff (N,) [$/kWh] onto the per-step linear weight on u:
    cost_k = price_k · P_h · Ts  (per-step energy cost when heater on)."""
    N = len(prices_per_kwh)
    seq = np.zeros((N, nv))
    seq[:, 0] = np.asarray(prices_per_kwh) * params.P_h * params.Ts / 3.6e6
    return seq


def min_up_down_rows(N: int, nv: int, min_up: int = 0, min_down: int = 0,
                     u_idx: int = 0, delta_idx: int = 1):
    """Cross-step unit-commitment rows in full-v layout for
    ``CondensedMpc.with_extra_constraints``.

    min-up:  startup at step k (δs_k = 1) forces u on for the next
             min_up−1 steps:  δs_k − u_j ≤ 0,  j = k+1 … k+min_up−1.
    min-down: shutdown at k (u_{k−1}=1 ∧ u_k=0 ⇔ u_{k−1} − u_k = 1,
             exact for binaries) forces u off for the next min_down−1
             steps: u_{k−1} − u_k + u_j ≤ 1, j = k+1 … k+min_down−1.
    Returns (A_v, b) with one row per implication inside the horizon.
    """
    rows, rhs = [], []
    for k in range(N):
        for j in range(k + 1, min(k + min_up, N)):
            r = np.zeros(N * nv)
            r[k * nv + delta_idx] = 1.0
            r[j * nv + u_idx] = -1.0
            rows.append(r)
            rhs.append(0.0)
    for k in range(1, N):
        for j in range(k + 1, min(k + min_down, N)):
            r = np.zeros(N * nv)
            r[(k - 1) * nv + u_idx] = 1.0
            r[k * nv + u_idx] = -1.0
            r[j * nv + u_idx] = 1.0
            rows.append(r)
            rhs.append(1.0)
    if not rows:
        return np.zeros((0, N * nv)), np.zeros(0)
    return np.stack(rows), np.asarray(rhs)
