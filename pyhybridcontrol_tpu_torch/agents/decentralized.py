"""Decentralized micro-grid coordination: dual decomposition on the grid
coupling constraint.

Counterpart of ``pyhybridcontrol_tpu/agents/decentralized.py``. Instead
of one joint MIQP over all agents (agents/micro_grid.py), each dual round
solves every agent's OWN horizon MIQP with the shared congestion price λ
added to its energy cost:

    agent i:  min  J_i(V_i) + Σ_k λ_k · P_i · u_{i,k}
    master:   λ_k ← [λ_k + α (Σ_i P_i u*_{i,k} − P_max)]₊

All agents share one model structure, so a dual round is ONE pooled B&B
over the M agents (solver/bnb_pooled.py), where the reference vmaps the
single-instance search over them: the M instances' nodes share one pool,
every wave is one K2 launch over all agents (a global wave of
M·``wave_size`` nodes, a pool of M·``capacity``, the wave cap
``max_waves``: each agent keeps its node budget). Each agent has its own
price sequence, so f and h come from one batched assembly with (M, N, nv)
prices. The dual update and the rationing projection are host numpy.

MIQP duality gaps mean the coupling need not hold at convergence; a
final *rationing projection* keeps the step implementable (greedy: switch
off excess heaters with the highest temperature — they need the energy
least).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.models.dewh import (
    DewhParams,
    dewh_model,
    dewh_weights,
)
from pyhybridcontrol_tpu_torch.models.grid import GridParams
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import solve_miqp_bnb_pooled
from pyhybridcontrol_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict


class DecentralizedMicroGrid:
    """M identical-structure DEWH agents + dual-price coordination, on
    ``device`` (the card unless the caller asks for the CPU)."""

    def __init__(self, dewh_params: Sequence[DewhParams],
                 grid: Optional[GridParams] = None, N: int = 8,
                 T_set: float = 60.0,
                 bnb_spec: Optional[BnbSpec] = None,
                 dual_rounds: int = 5, dual_step: float = 2e-4,
                 soft_comfort: bool = True, device=DEFAULT_DEVICE):
        self.dewh_params = list(dewh_params)
        self.M = len(self.dewh_params)
        self.grid = grid or GridParams()
        self.N = N
        self.dual_rounds = dual_rounds
        self.dual_step = dual_step
        self.bnb_spec = bnb_spec or BnbSpec(capacity=128, wave_size=16,
                                            qp_iters=200)
        self.device = resolve_device(device)
        # one condensed problem — agents share the model structure
        self.model = dewh_model(self.dewh_params[0]).to(self.device)
        c = CondensedMpc(self.model, N, dewh_weights(T_set=T_set))
        if soft_comfort:
            nc = self.model.info.ncons
            c = c.with_soft_constraints(
                [k * nc + r for k in range(N) for r in (0, 1)],
                lin_pen=5.0, quad_pen=1.0)
        self.qp = c.device_qp(self.device)
        self.admm = prepare_admm_mpc(c, device=self.device)
        self.P_h = np.array([p.P_h for p in self.dewh_params])
        self.x = torch.tensor([55.0, 0.0],
                              device=self.device).repeat(self.M, 1)
        self.k = 0
        # the pooled search over the M agents: each agent's node budget
        spec = self.bnb_spec
        self.pool_slots = self.M * spec.capacity
        self.pooled_spec = dataclasses.replace(
            spec, wave_size=self.M * spec.wave_size,
            capacity=self.pool_slots)

    def reset(self, x0s):
        self.x = torch.as_tensor(np.stack(x0s), dtype=torch.float32,
                                 device=self.device)
        self.k = 0

    def solve_agents(self, prices: np.ndarray):
        """One dual round's M agent MIQPs, ``prices`` (M, N, nv), in one
        pooled B&B. Returns (v_seqs (M, N, nv), objs (M,), found (M,))."""
        qp = self.qp
        f, h = qp.assemble(self.x, None, None,
                           torch.as_tensor(prices, dtype=torch.float32,
                                           device=self.device))
        r = solve_miqp_bnb_pooled(self.admm, qp, f, h, self.pooled_spec,
                                  pool_slots=self.pool_slots)
        return qp.full_v(r.x), r.obj, r.found

    def feedback(self) -> StructDict:
        """One control step: dual rounds of pooled agent MIQPs +
        rationing projection. Returns u (M,), λ, power trace."""
        N, M = self.N, self.M
        # per-agent tariff on the agent's OWN u column (col 0 of its nv)
        nv = self.model.info.nv
        base_price = np.zeros((M, N, nv))
        for k in range(N):
            price = self.grid.price_at(self.k + k)
            for i, p in enumerate(self.dewh_params):
                base_price[i, k, 0] = price * p.P_h * p.Ts / 3.6e6
        lam = np.zeros(N)
        u_prof = None
        for _ in range(self.dual_rounds):
            prices = base_price.copy()
            for i in range(M):
                prices[i, :, 0] += lam * self.P_h[i]
            v_seqs, objs, founds = self.solve_agents(
                prices.astype(np.float32))
            u_prof = np.round(v_seqs[:, :, 0].cpu().numpy())   # (M, N)
            agg = u_prof.T @ self.P_h                         # (N,)
            viol = agg - self.grid.P_max
            lam = np.maximum(0.0, lam + self.dual_step * viol)
            if np.all(viol <= 1e-6):
                break
        # rationing projection on the FIRST step only (the applied one):
        # drop warmest heaters until the coupling holds
        u0 = u_prof[:, 0].copy()
        temps = self.x[:, 0].cpu().numpy()
        order = np.argsort(-temps)       # warmest first
        for i in order:
            if u0 @ self.P_h <= self.grid.P_max + 1e-6:
                break
            u0[i] = 0.0
        return StructDict(u=u0, lam=lam, agg_power=float(u0 @ self.P_h),
                          found=bool(founds.all()), v_seqs=v_seqs)

    def sim_step(self, omega_k=None) -> StructDict:
        sol = self.feedback()
        dev = self.device
        w = (torch.as_tensor(np.asarray(omega_k, np.float32)[:, None],
                             device=dev) if omega_k is not None else None)
        u = torch.as_tensor(sol.u[:, None], dtype=torch.float32, device=dev)
        d = torch.round(sol.v_seqs[:, 0, 1:2])
        self.x = self.model.step(self.x, u, d, None, w)
        self.k += 1
        return sol
