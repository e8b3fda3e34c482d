"""Grid / tariff model (SURVEY.md §2a "Micro-grid layer": grid agent,
time-of-use energy price objective, aggregate power coupling).

The grid side of the micro-grid is (i) a TOU tariff signal mapped onto
per-step linear costs of the agents' heater inputs and (ii) the coupling
row  Σ_i P_h,i · u_i ≤ P_max  appended to the aggregate MLD.

Counterpart of ``pyhybridcontrol_tpu/models/grid.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from pyhybridcontrol_tpu_torch.mld.compose import aggregate_mld
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.models.dewh import DewhParams, dewh_model


@dataclasses.dataclass
class GridParams:
    P_max: float = 9000.0                 # W aggregate limit
    tou_prices: Optional[np.ndarray] = None   # $/kWh per control period

    def price_at(self, k: int) -> float:
        if self.tou_prices is None:
            return 0.15
        return float(self.tou_prices[k % len(self.tou_prices)])


def default_tou_profile(periods_per_day: int = 96) -> np.ndarray:
    """Simple two-level TOU tariff: peak 07:00–23:00, off-peak night."""
    t = np.arange(periods_per_day) / periods_per_day * 24.0
    return np.where((t >= 7.0) & (t < 23.0), 0.28, 0.09)


def micro_grid_mld(dewh_params: Sequence[DewhParams],
                   grid: Optional[GridParams] = None) -> MldModel:
    """Aggregate MLD of M DEWH agents + grid power coupling
    (SURVEY.md §3.5 centralized micro-grid solve)."""
    grid = grid or GridParams()
    models = [dewh_model(p) for p in dewh_params]
    nu = len(models)                      # one heater input per agent
    coupling_F1 = np.array([[p.P_h for p in dewh_params]])
    return aggregate_mld(models, coupling_F1=coupling_F1,
                         coupling_f5=np.array([grid.P_max]))


def micro_grid_price_seq(N: int, k0: int, dewh_params: Sequence[DewhParams],
                         grid: GridParams, nv: int) -> np.ndarray:
    """Per-step linear weights on the joint v: energy cost of each
    heater under the TOU tariff for steps k0 … k0+N−1."""
    M = len(dewh_params)
    seq = np.zeros((N, nv))
    for k in range(N):
        price = grid.price_at(k0 + k)
        for i, p in enumerate(dewh_params):
            seq[k, i] = price * p.P_h * p.Ts / 3.6e6
    return seq
