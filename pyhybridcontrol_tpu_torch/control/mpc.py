"""MpcController: the user-facing receding-horizon controller.

Counterpart of ``pyhybridcontrol_tpu/control/mpc.py`` for the condensed
``bnb`` and ``enumerate`` solvers: ``build`` condenses once on the host
in float64 and moves the problem to ``device``; ``feedback(x0)`` solves
the MIQP there and returns the first input. The other paths of the
reference raise ``NotImplementedError`` naming the ROADMAP item that
ports them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc, MpcWeights
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

_SOLVERS = ("bnb", "enumerate")


def _not_ported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to pyhybridcontrol_tpu_torch yet "
        f"(ROADMAP queue 1: {item})")


class MpcController:
    def __init__(self, model: MldModel, N: int,
                 weights: Optional[MpcWeights] = None,
                 solver: str = "bnb",
                 bnb_spec: Optional[BnbSpec] = None,
                 qp_iters: int = 150,
                 rho: float = 1.0,
                 device="cpu"):
        if solver == "stagewise":
            _not_ported('solver="stagewise"', "stagewise O(N) frame")
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        self.model = model
        self.N = N
        self.weights = weights or MpcWeights()
        self.solver = solver
        self.bnb_spec = bnb_spec or BnbSpec(qp_iters=qp_iters)
        self.qp_iters = qp_iters
        self.rho = rho
        self.device = torch.device(device)
        self._cmpc = None
        self._qp = None
        self._admm = None
        self._admm_probe = None
        self._repair = None

    # -- configuration the port does not have yet ----------------------------
    def set_soft_constraints(self, *a, **kw):
        _not_ported("set_soft_constraints", "condense transforms")

    def set_move_blocking(self, *a, **kw):
        _not_ported("set_move_blocking", "condense transforms")

    def set_extra_constraints(self, *a, **kw):
        _not_ported("set_extra_constraints", "condense transforms")

    def set_scenario_tree(self, *a, **kw):
        _not_ported("set_scenario_tree", "scenario trees")

    # -- build ---------------------------------------------------------------
    def build(self) -> "MpcController":
        """Condense + prepare solver data (once)."""
        if self._cmpc is not None:
            return self
        c = CondensedMpc(self.model, self.N, self.weights)
        dev = self.device
        self._qp = c.device_qp(dev)
        self._admm = prepare_admm_mpc(c, rho=self.rho, device=dev)
        # stiff-rho prep for dive probes (same Ruiz frame): fixed-binary
        # solves converge faster at rho*10, relaxed nodes are insensitive
        self._admm_probe = (prepare_admm_mpc(c, rho=self.rho * 10.0,
                                             device=dev)
                            if self.solver == "bnb" else None)
        # rollout-repair incumbent heuristic (full per-step v frame)
        self._repair = None
        if self.solver == "bnb" and self.model.info.nxb == 0:
            from pyhybridcontrol_tpu_torch.solver.repair import prepare_repair

            self._repair = prepare_repair(self.model, self.weights,
                                          device=dev)
        self._cmpc = c
        return self

    @property
    def condensed(self) -> CondensedMpc:
        self.build()
        return self._cmpc

    # -- feedback ------------------------------------------------------------
    def _tensor(self, a):
        return (None if a is None
                else torch.as_tensor(np.asarray(a, np.float32),
                                     device=self.device))

    def feedback(self, x0, omega_forecast=None, price_seq=None,
                 u_prev=None) -> StructDict:
        """One control step: measure → solve MIQP → first input.

        Returns StructDict(u, delta, z, v_seq, obj, found, nodes, gap) of
        tensors on the controller's device.
        """
        self.build()
        info = self.model.info
        x0 = self._tensor(x0)
        if x0.ndim != 1 or x0.shape[0] != info.nx:
            raise ValueError(f"x0 must have shape ({info.nx},), got "
                             f"{tuple(x0.shape)}")
        if omega_forecast is not None and info.nomega == 0:
            raise ValueError(
                "omega_forecast given but the model has no disturbance "
                "channel (nomega=0)")
        if price_seq is not None and np.shape(price_seq)[0] != self.N:
            raise ValueError(
                f"price_seq must have N={self.N} rows (per control step), "
                f"got {np.shape(price_seq)}")
        qp, admm = self._qp, self._admm
        W, Pq = self._tensor(omega_forecast), self._tensor(price_seq)
        up = self._tensor(u_prev)
        f, h = qp.assemble(x0, W, up, Pq)
        if self.solver == "bnb":
            seed = None
            if self._repair is not None:
                from pyhybridcontrol_tpu_torch.solver.repair import (
                    root_repair_incumbent)

                seed = root_repair_incumbent(
                    admm, qp, self._repair, x0, f, h, W=W, price_seq=Pq,
                    qp_iters=self.bnb_spec.qp_iters,
                    feas_tol=self.bnb_spec.feas_tol)
            res = solve_miqp_bnb(admm, qp, f, h, self.bnb_spec,
                                 init_incumbent=seed,
                                 admm_probe=self._admm_probe)
            x, obj, found = res.x, res.obj, res.found
            nodes = res.nodes_solved
            # certified relative optimality gap (0 when the frontier was
            # exhausted; folds overflow-dropped bounds)
            bo = res.best_open_bound
            gap = torch.where(found & torch.isfinite(bo) & (bo < obj),
                              (obj - bo) / torch.clamp_min(obj.abs(), 1.0),
                              0.0)
        else:
            x, obj, _, feas = solve_miqp_enumerate_device(
                admm, qp, f, h, iters=self.qp_iters)
            found = feas.any()
            nodes = torch.tensor(2 ** qp.n_binary, device=self.device)
            gap = torch.zeros((), device=self.device)   # exhaustive
        v_seq = qp.full_v(x)
        v0 = v_seq[0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=v_seq, obj=obj, found=found,
            nodes=nodes, gap=gap)

    def feedback_batch(self, *a, **kw):
        _not_ported("feedback_batch (batched requests)",
                    "pooled engine with feedback_batch and serve --tcp")
