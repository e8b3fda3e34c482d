"""Battery storage MLD model — completes the micro-grid domain layer
(SURVEY.md §2a L4). Asymmetric charge/discharge efficiency is the
textbook MLD use-case: the round-trip losses make power-to-SoC gain
depend on the SIGN of the power flow, which needs a binary mode δ and
the product auxiliary z = δ·p.

    SoC⁺ = SoC + Ts·(η_c·p_c − p_d/η_d)/E_cap

with one signed grid-side power p ∈ [−p_max, p_max] (p>0 charging):
δ = 1 ⇔ p ≥ 0;  z = δ·p  ⇒  p_c = z, p_d = z − p, so

    SoC⁺ = SoC + Ts/E_cap · ( (η_c − 1/η_d)·z + (1/η_d)·p )

Constraints: SoC band, |p| ≤ p_max, sign-consistency big-M rows, and the
four z-product rows. Costs: energy price on p (TOU via price_seq),
optional cycling penalty on δ switches via Rdu-style terms upstream.

Counterpart of ``pyhybridcontrol_tpu/models/battery.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights


@dataclasses.dataclass
class BatteryParams:
    """kW / kWh / hour units — keeps every decision variable O(1),
    which the row-equilibrated fixed-rho ADMM needs."""

    Ts_h: float = 0.25           # h (15 min)
    E_cap: float = 10.0          # kWh
    p_max: float = 5.0           # kW
    eta_c: float = 0.95
    eta_d: float = 0.92
    soc_min: float = 0.1
    soc_max: float = 0.9


def battery_model(p: BatteryParams = BatteryParams()) -> MldModel:
    """x = [SoC] ∈ [0,1]; u = [p] (kW, signed, + = charging);
    δ = [mode]; z = [δ·p]."""
    a_z = p.Ts_h / p.E_cap * (p.eta_c - 1.0 / p.eta_d)
    a_p = p.Ts_h / p.E_cap * (1.0 / p.eta_d)
    M = p.p_max

    E, F1, F2, F3, f5 = [], [], [], [], []

    def row(e=0.0, f1=0.0, f2=0.0, f3=0.0, rhs=0.0):
        E.append([e]); F1.append([f1]); F2.append([f2]); F3.append([f3])
        f5.append(rhs)

    row(e=1.0, rhs=p.soc_max)             # SoC ≤ max
    row(e=-1.0, rhs=-p.soc_min)           # SoC ≥ min
    row(f1=1.0, rhs=M)                    # p ≤ p_max
    row(f1=-1.0, rhs=M)                   # −p ≤ p_max
    # canonical big-M sign pair (δ ⇔ charging):
    # δ=1 ⇒ p ≥ 0:   −p ≤ M(1−δ)   →  −p + Mδ ≤ M
    # δ=0 ⇒ p ≤ 0:    p ≤ Mδ       →   p − Mδ ≤ 0
    row(f1=-1.0, f2=M, rhs=M)
    row(f1=1.0, f2=-M, rhs=0.0)
    # z = δ·p product rows (|p| ≤ M):
    row(f3=1.0, f2=-M, rhs=0.0)           # z ≤ Mδ
    row(f3=-1.0, f2=-M, rhs=0.0)          # −z ≤ Mδ
    row(f1=-1.0, f3=1.0, f2=M, rhs=M)     # z − p ≤ M(1−δ)
    row(f1=1.0, f3=-1.0, f2=M, rhs=M)     # p − z ≤ M(1−δ)

    info = MldInfo(nx=1, nu=1, ndelta=1, nz=1, nomega=0, ny=1,
                   ncons=len(f5))
    return MldModel.from_matrices(
        info,
        A=np.array([[1.0]]),
        B1=np.array([[a_p]]),
        B3=np.array([[a_z]]),
        C=np.array([[1.0]]),
        E=np.array(E), F1=np.array(F1), F2=np.array(F2),
        F3=np.array(F3), f5=np.array(f5))


def battery_weights(soc_ref: float = 0.5, q_soc: float = 0.1,
                    r_p: float = 1e-9) -> MpcWeights:
    """Mild SoC tracking + tiny power regularization; the economics come
    from the TOU price sequence on p at feedback time."""
    return MpcWeights(Qx=np.array([q_soc]), x_ref=np.array([soc_ref]),
                      Ru=np.array([r_p]))


def battery_price_seq(prices_per_kwh, p: BatteryParams, nv: int = 3):
    """$/kWh tariff → per-step linear cost on the signed power p (kW):
    buying (p>0) costs, selling (p<0) earns at the same price."""
    N = len(prices_per_kwh)
    seq = np.zeros((N, nv))
    seq[:, 0] = np.asarray(prices_per_kwh) * p.Ts_h
    return seq
