"""Micro-grid coordination: M DEWH agents and a grid agent, an aggregate
power coupling and a shared TOU price — one centralized aggregate MIQP a
control step, its inputs distributed back to the agents.

Counterpart of ``pyhybridcontrol_tpu/agents/micro_grid.py``. The
aggregate problem is an ordinary MldModel (mld/compose.py), so the whole
coordinator step is one ``MpcController.feedback`` on the controller's
device (the card unless ``device="cpu"`` is passed), with soft comfort
bands.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.agents.agent import Agent
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.mld.compose import joint_v_layout
from pyhybridcontrol_tpu_torch.models.dewh import DewhParams, dewh_model
from pyhybridcontrol_tpu_torch.models.grid import (
    GridParams,
    micro_grid_mld,
    micro_grid_price_seq,
)
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict


class MicroGridCoordinator:
    def __init__(self, dewh_params: Sequence[DewhParams],
                 grid: Optional[GridParams] = None, N: int = 24,
                 T_set: float = 60.0, q_comfort: float = 1.0,
                 q_startup: float = 0.1, **controller_kw):
        self.dewh_params = list(dewh_params)
        self.grid = grid or GridParams()
        self.M = len(self.dewh_params)
        self.N = N
        self.model = micro_grid_mld(self.dewh_params, self.grid)
        # joint weights: per-agent comfort tracking + startup penalties
        Qx = np.concatenate([[q_comfort, 0.0]] * self.M)
        x_ref = np.concatenate([[T_set, 0.0]] * self.M)
        qdelta = np.full(self.M, q_startup)
        weights = MpcWeights(Qx=Qx, x_ref=x_ref, qdelta=qdelta)
        self.controller = MpcController(self.model, N, weights,
                                        **controller_kw)
        dev = self.controller.device
        self.agents = [Agent(dewh_model(p), name=f"dewh_{i}", device=dev)
                       for i, p in enumerate(self.dewh_params)]
        self.layout = [{k: torch.as_tensor(v, device=dev)
                        for k, v in lay.items()}
                       for lay in joint_v_layout([a.sim_model.info
                                                  for a in self.agents])]
        # comfort bands are soft (hard bands are infeasible whenever a
        # draw outpaces the heater — reference DSM practice)
        nc_a = 7                       # rows per DEWH agent
        nc_joint = self.model.info.ncons
        soft = [k * nc_joint + i * nc_a + r
                for k in range(N) for i in range(self.M) for r in (0, 1)]
        self.controller.set_soft_constraints(soft, lin_pen=5.0,
                                             quad_pen=1.0)
        self.k = 0

    @property
    def x(self):
        return torch.cat([a.x for a in self.agents])

    def reset(self, x0s: Sequence[np.ndarray]):
        for a, x0 in zip(self.agents, x0s):
            a.reset(x0)
        self.k = 0

    def price_seq(self) -> np.ndarray:
        return micro_grid_price_seq(self.N, self.k, self.dewh_params,
                                    self.grid, self.model.info.nv)

    def feedback(self, omega_forecast=None) -> StructDict:
        """Solve the aggregate MIQP; returns joint + per-agent splits."""
        sol = self.controller.feedback(
            self.x, omega_forecast=omega_forecast,
            price_seq=self.price_seq())
        v0 = torch.cat([sol.u, sol.delta, sol.z])
        sol.per_agent = [
            StructDict({k: v0[idx] if len(idx) else None
                        for k, idx in lay.items()})
            for lay in self.layout]
        return sol

    def sim_step(self, omega_k=None, omega_forecast=None) -> StructDict:
        """Coordinator step: aggregate solve → distribute → advance all.
        Binary heater inputs are rounded to exact {0,1} before being
        applied (solver binaries carry ~1e-6 fp noise); the applied total
        power must hold the coupling row."""
        sol = self.feedback(omega_forecast)
        total_power = 0.0
        for i, (agent, pa) in enumerate(zip(self.agents, sol.per_agent)):
            w = (torch.as_tensor(omega_k[i], dtype=torch.float32,
                                 device=agent.device).reshape(1)
                 if omega_k is not None else None)
            u = torch.round(pa.u)
            d = torch.round(pa.delta) if pa.delta is not None else None
            y = agent.sim_model.output(agent.x, u, d, None, w)
            x_next = agent.sim_model.step(agent.x, u, d, None, w)
            agent.record(x=agent.x, u=u, delta=d, y=y,
                         omega=omega_k[i] if omega_k is not None else None)
            agent.x = x_next
            agent.k += 1
            total_power += float(u[0]) * self.dewh_params[i].P_h
        sol.total_power = total_power
        if total_power > self.grid.P_max * (1 + 1e-6) + 1e-3:
            raise RuntimeError(
                f"coupling violated in distributed inputs: total power "
                f"{total_power} > P_max {self.grid.P_max}")
        self.k += 1
        return sol
