"""MpcController: the user-facing receding-horizon controller.

Counterpart of ``pyhybridcontrol_tpu/control/mpc.py`` for the condensed
``bnb`` and ``enumerate`` solvers: ``build`` condenses once on the host
in float64 and moves the problem to ``device`` (the card unless the
caller asks for the CPU); ``feedback(x0)`` solves the MIQP there and
returns the first input; ``feedback_batch(x0s)`` solves a batch of
control steps in one pooled B&B (solver/bnb_pooled.py), or instance by
instance (engine "vmap"). The other paths of the reference raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

from typing import Optional

import dataclasses

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import prepare_admm_mpc
from pyhybridcontrol_tpu_torch.ops.condense import CondensedMpc, MpcWeights
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import solve_miqp_bnb_pooled
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device
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
                 device=DEFAULT_DEVICE):
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
        self.device = resolve_device(device)
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
        if a is None:
            return None
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.float32)
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

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

    def feedback_batch(self, x0s, omega_forecasts=None, price_seq=None,
                       u_prevs=None, mesh=None, engine="auto",
                       pooled_wave: int = 1024,
                       pool_slots: int = 0) -> StructDict:
        """Solve a batch of independent control steps at once.

        ``engine``: "pooled" (solver="bnb": all instances' B&B nodes in
        one global pool, solver/bnb_pooled.py; each wave is one K2 launch
        over ``pooled_wave`` nodes), "vmap" (one ``feedback`` per
        instance, in a loop: the reference vmaps independent
        per-instance searches, so the results are the same function;
        ``torch.func.vmap`` cannot carry the wave loop's host reads) or
        "auto" (pooled for solver="bnb", else vmap). Scenario trees and
        ``mesh`` placement are not ported.
        ``pooled_wave``/``pool_slots`` size the pooled search; the
        per-instance node budget matches ``bnb_spec`` (``max_waves``
        rescales to the global wave size).

        ``x0s`` (B, nx); ``omega_forecasts``/``u_prevs`` optionally carry
        the same leading batch dimension; ``price_seq`` is shared.
        Returns StructDict(u, delta, z, v_seq, obj, found, nodes, gap)
        with a leading (B,) axis; ``nodes`` is the global node count.
        """
        self.build()
        if mesh is not None:
            _not_ported("feedback_batch(mesh=...)", "multi-device")
        if engine == "auto":
            engine = "pooled" if self.solver == "bnb" else "vmap"
        if engine not in ("pooled", "vmap"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "pooled" and self.solver != "bnb":
            raise ValueError(
                f'engine="pooled" requires solver="bnb", got '
                f'{self.solver!r}')
        info = self.model.info
        x0s = self._tensor(x0s)
        if x0s.ndim != 2 or x0s.shape[1] != info.nx:
            raise ValueError(f"x0s must have shape (B, {info.nx}), got "
                             f"{tuple(x0s.shape)}")
        if omega_forecasts is not None and info.nomega == 0:
            raise ValueError(
                "omega_forecasts given but the model has no disturbance "
                "channel (nomega=0)")
        W, Pq = self._tensor(omega_forecasts), self._tensor(price_seq)
        up = self._tensor(u_prevs)
        if engine == "vmap":
            return self._feedback_batch_each(x0s, W, Pq, up)
        return self._feedback_batch_pooled(x0s, W, Pq, up, pooled_wave,
                                           pool_slots)

    def _feedback_batch_each(self, x0s, W, Pq, up) -> StructDict:
        """feedback_batch engine="vmap": ``feedback`` of each instance, the
        fields stacked on a leading (B,) axis."""
        outs = [self.feedback(x0s[i], None if W is None else W[i], Pq,
                              None if up is None else up[i])
                for i in range(x0s.shape[0])]
        return StructDict({k: torch.stack([o[k] for o in outs])
                           for k in outs[0]})

    def _feedback_batch_pooled(self, x0s, W, Pq, up, pooled_wave,
                               pool_slots) -> StructDict:
        """feedback_batch engine="pooled": batched assembly, batched
        rollout-repair seeds, one pooled B&B over the batch."""
        qp, admm, spec = self._qp, self._admm, self.bnb_spec
        B = x0s.shape[0]
        f, h = qp.assemble(x0s, W, up, Pq)
        seed = None
        if self._repair is not None:
            from pyhybridcontrol_tpu_torch.solver.repair import (
                root_repair_incumbent)

            seed = root_repair_incumbent(
                admm, qp, self._repair, x0s, f, h, W=W, price_seq=Pq,
                qp_iters=spec.qp_iters, feas_tol=spec.feas_tol)
        # The global wave cannot exceed the pool. The reference snaps it
        # to its TPU kernels' 128-lane batch grain; the CUDA kernels have
        # no grain, but the arithmetic is kept so that both packages
        # search with the same wave size and node budget.
        P = pool_slots or 32 * B
        gwave = min(pooled_wave, P)
        if gwave >= 128:
            gwave -= gwave % 128
        # equal per-instance node budget at the global wave size
        gw = max(1, (B * spec.max_waves * spec.wave_size + gwave - 1)
                 // gwave)
        pspec = dataclasses.replace(spec, wave_size=gwave,
                                    capacity=max(spec.capacity, gwave),
                                    max_waves=gw)
        res = solve_miqp_bnb_pooled(admm, qp, f, h, pspec, pool_slots=P,
                                    init_incumbent=seed,
                                    admm_probe=self._admm_probe)
        v_seq = qp.full_v(res.x)                          # (B, N, nv)
        info = self.model.info
        v0 = v_seq[:, 0]
        bo = res.best_open_bound
        gap = torch.where(res.found & torch.isfinite(bo) & (bo < res.obj),
                          (res.obj - bo)
                          / torch.clamp_min(res.obj.abs(), 1.0), 0.0)
        return StructDict(
            u=v0[:, info.u_slice], delta=v0[:, info.delta_slice],
            z=v0[:, info.z_slice], v_seq=v_seq, obj=res.obj,
            found=res.found, nodes=res.nodes_solved.expand(B), gap=gap)
