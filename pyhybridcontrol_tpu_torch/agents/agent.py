"""Agent layer: an Agent binds a simulation model, a control model and a
controller; the receding-horizon loop is  measure x_k → feedback →
apply u_k → step the dynamics → log.

Counterpart of ``pyhybridcontrol_tpu/agents/agent.py``. Two ways to run:

  * the interactive host loop (``sim_step`` / ``run``): one control step
    at a time, for studies that inspect or intervene mid-run;
  * ``run_compiled``: the whole trajectory through ``loop.closed_loop``
    (the reference's one scanned program; here the port's closed loop, a
    Python loop over the steps on the controller's device).

The history is kept per step and returned stacked by ``history()``: a
pandas DataFrame (with a DatetimeIndex at the control period Ts when it
is given) where pandas imports, else a dict of the same columns as numpy
arrays.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.loop.closed_loop import (
    closed_loop,
    make_mpc_step,
)
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.utils.device import (
    DEFAULT_DEVICE,
    resolve_device,
    to_numpy,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict


def _f32(a, device):
    return (None if a is None
            else torch.as_tensor(a, dtype=torch.float32, device=device))


class Agent:
    """Identity + simulation model, on ``device`` (the card unless the
    caller asks for the CPU)."""

    _count = 0

    def __init__(self, sim_model: MldModel, name: Optional[str] = None,
                 device=DEFAULT_DEVICE):
        Agent._count += 1
        self.name = name or f"agent_{Agent._count}"
        self.device = resolve_device(device)
        self.sim_model = sim_model.to(self.device)
        self.x = torch.zeros(sim_model.info.nx, device=self.device)
        self.k = 0
        self._hist = []

    def reset(self, x0):
        self.x = _f32(x0, self.device)
        self.k = 0
        self._hist = []

    def record(self, **kw):
        self._hist.append(dict(k=self.k, **kw))

    def _columns(self) -> dict:
        """The history as columns: scalars by name, vectors split into
        ``name0``, ``name1``, ... (the reference's DataFrame columns)."""
        cols = {}
        for n, rec in enumerate(self._hist):
            row = {}
            for key, val in rec.items():
                a = to_numpy(val)
                if a.ndim == 0:
                    row[key] = a.item()
                else:
                    for i, v in enumerate(a.reshape(-1)):
                        row[f"{key}{i}"] = float(v)
            for key, v in row.items():
                cols.setdefault(key, [None] * n)
            for key, col in cols.items():
                col.append(row.get(key))
        return cols

    def history(self, Ts: Optional[float] = None, t0=None):
        """The simulation log: a pandas DataFrame (DatetimeIndex when
        ``Ts`` is given) where pandas imports, else a dict of numpy
        columns."""
        cols = self._columns()
        try:
            import pandas as pd
        except ImportError:
            return {k: np.asarray(v) for k, v in cols.items()}
        if not cols:
            return pd.DataFrame()
        df = pd.DataFrame(cols)
        if Ts is not None:
            start = t0 or "2020-01-01"
            df.index = pd.date_range(start=start, periods=len(df),
                                     freq=f"{int(Ts)}s")
        return df


class ControlledAgent(Agent):
    """Agent + control model (may differ from the simulation model —
    e.g. control on the nominal model, simulate with disturbances)."""

    def __init__(self, sim_model: MldModel,
                 control_model: Optional[MldModel] = None,
                 name: Optional[str] = None, device=DEFAULT_DEVICE):
        super().__init__(sim_model, name, device)
        self.control_model = control_model or sim_model


class MpcAgent(ControlledAgent):
    """A controlled agent whose controller is an ``MpcController``; it
    simulates on the controller's device."""

    def __init__(self, sim_model: MldModel, controller: MpcController,
                 control_model: Optional[MldModel] = None,
                 name: Optional[str] = None):
        super().__init__(sim_model, control_model, name, controller.device)
        ci, si = controller.model.info, sim_model.info
        # the controller's plan (u, δ, z) is applied verbatim to the sim
        # model, and the sim state is handed back — dims must line up
        # (shape coincidences otherwise make wrong pairings run silently)
        if (ci.nx, ci.nu, ci.ndelta, ci.nz) != (si.nx, si.nu, si.ndelta,
                                                si.nz):
            raise ValueError(
                f"controller model dims (nx,nu,nδ,nz)="
                f"{(ci.nx, ci.nu, ci.ndelta, ci.nz)} do not match sim "
                f"model {(si.nx, si.nu, si.ndelta, si.nz)}")
        self.controller = controller
        self._u_prev = None

    def feedback(self, omega_forecast=None, price_seq=None) -> StructDict:
        """Solve the MIQP at the current state → planned decision."""
        return self.controller.feedback(
            self.x, omega_forecast=omega_forecast, price_seq=price_seq,
            u_prev=self._u_prev)

    def sim_step(self, omega_k=None, omega_forecast=None, price_seq=None
                 ) -> StructDict:
        """One receding-horizon step: feedback → apply → advance → log."""
        sol = self.feedback(omega_forecast, price_seq)
        w = _f32(omega_k, self.device)
        y = self.sim_model.output(self.x, sol.u, sol.delta, sol.z, w)
        x_next = self.sim_model.step(self.x, sol.u, sol.delta, sol.z, w)
        self.record(x=self.x, u=sol.u, delta=sol.delta, z=sol.z, y=y,
                    obj=sol.obj, found=sol.found, omega=omega_k)
        self.x = x_next
        self.k += 1
        self._u_prev = sol.u
        return sol

    def run(self, T: int, omega_traj=None, price_traj=None,
            Ts: Optional[float] = None):
        """Host-loop simulation for T steps; returns ``history(Ts)``."""
        N = self.controller.N
        for _ in range(T):
            k = self.k
            w_k = omega_traj[k] if omega_traj is not None else None
            W = (omega_traj[k : k + N] if omega_traj is not None else None)
            Pq = (price_traj[k : k + N] if price_traj is not None else None)
            self.sim_step(w_k, W, Pq)
        return self.history(Ts)

    def run_compiled(self, T: int, omega_traj=None, price_traj=None):
        """The whole trajectory through ``loop.closed_loop``; returns its
        ClosedLoopResult."""
        ctrl = self.controller
        ctrl.build()
        step = make_mpc_step(
            self.control_model, ctrl.device_qp, ctrl.admm,
            method=ctrl.solver if ctrl.solver in ("bnb", "enumerate")
            else "bnb",
            bnb_spec=ctrl.bnb_spec, qp_iters=ctrl.qp_iters)
        return closed_loop(self.sim_model, step, self.x, T,
                           omega_traj=omega_traj, price_traj=price_traj)
