"""MpcController: the user-facing receding-horizon controller.

Counterpart of ``pyhybridcontrol_tpu/control/mpc.py``: ``build``
prepares the problem once on the host in float64 and moves it to
``device`` (the card unless the caller asks for the CPU); ``feedback(x0)``
solves the MIQP there and returns the first input; ``feedback_batch(x0s)``
solves a batch of control steps in one pooled B&B (solver/bnb_pooled.py),
or instance by instance (engine "vmap"). The setters (weights, horizon,
soft rows, move blocking, terminal set, horizon-coupled rows, scenario
tree) bump a version, and ``build`` prepares again on the next call.

Solvers: "bnb" and "enumerate" on the condensed frame; "stagewise" on the
O(N) block-tridiagonal frame (ops/stagewise.py, B&B through
solver/bnb_stagewise.py, each relaxation one K5 launch on the card), where
soft rows, move blocking, terminal sets and horizon-coupled rows ride
natively.
A condensed scenario tree is either the dense joint frame
(ops/scenario_tree.py; ``feedback`` branches per coordinate through K2,
the pooled engine branches per information set through K1) or the
consensus tree (ops/consensus_tree.py, plain torch ADMM); under
solver="stagewise" a tree is always the stagewise consensus tree
(ops/stagewise_tree.py).
Across ranks (parallel/): ``feedback_batch(mesh=)`` solves each rank's
slice of the batch and gathers the results on every rank;
``set_scenario_tree(scen_mesh=)`` splits a consensus tree's (or a
stagewise tree's) scenarios over ranks.
"""

from __future__ import annotations

from typing import Optional, Sequence

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

_SOLVERS = ("bnb", "enumerate", "stagewise")


class MpcController:
    def __init__(self, model: MldModel, N: int,
                 weights: Optional[MpcWeights] = None,
                 solver: str = "bnb",
                 bnb_spec: Optional[BnbSpec] = None,
                 qp_iters: int = 150,
                 rho: float = 1.0,
                 sw_parallel: bool = False,
                 device=DEFAULT_DEVICE):
        if solver not in _SOLVERS:
            raise ValueError(f"unknown solver {solver!r}")
        self.model = model
        self.N = N
        self.weights = weights or MpcWeights()
        self.solver = solver
        self.bnb_spec = bnb_spec or BnbSpec(qp_iters=qp_iters)
        self.qp_iters = qp_iters
        self.rho = rho
        # stagewise only: the log-depth sweeps (ops/stagewise.py
        # _solve_K_assoc) instead of the sequential ones
        self.sw_parallel = sw_parallel
        self.device = resolve_device(device)
        self._soft = None          # (rows, lin_pen, quad_pen)
        self._blocking = None      # groups
        self._terminal = None      # (E_N, f_N)
        self._extra = None         # (A_v, b, B_x, B_w)
        self._tree = None          # ScenarioTree (stochastic MPC)
        self._tree_consensus = False
        self._scen_mesh = None     # (mesh, axis) or mesh: tree over ranks
        self._tqp = None           # consensus-tree preps (ρ, stiff ρ)
        self._tqp_probe = None
        self._sw = None            # stagewise preps (ρ, stiff ρ)
        self._sw_probe = None
        self._swt = None           # stagewise-tree preps (ρ, stiff ρ)
        self._swt_probe = None
        self._version = 0
        self._built_version = None
        self._cmpc = None
        self._qp = None
        self._admm = None
        self._admm_probe = None
        self._repair = None        # (RepairSpec, layout) or None

    # -- configuration (each bumps the version → rebuild on next use) --------
    def set_std_obj_weights(self, **kw) -> "MpcController":
        """Update per-class weights (fields of ``MpcWeights``)."""
        for k, v in kw.items():
            if not hasattr(self.weights, k):
                raise AttributeError(f"unknown weight {k!r}")
            setattr(self.weights, k, v)
        self._version += 1
        return self

    def set_horizon(self, N: int) -> "MpcController":
        self.N = N
        self._version += 1
        return self

    def set_soft_constraints(self, rows: Sequence[int], lin_pen=1e3,
                             quad_pen=0.0) -> "MpcController":
        self._soft = (list(rows), lin_pen, quad_pen)
        self._version += 1
        return self

    def set_move_blocking(self, groups: Sequence[int]) -> "MpcController":
        self._blocking = list(groups)
        self._version += 1
        return self

    def set_terminal_constraint(self, E_N, f_N) -> "MpcController":
        self._terminal = (np.asarray(E_N), np.asarray(f_N))
        self._version += 1
        return self

    def set_extra_constraints(self, A_v, b, B_x=None, B_w=None
                              ) -> "MpcController":
        """Horizon-coupled rows in full-v layout (e.g. min-up/down
        unit-commitment logic — models/dewh.py ``min_up_down_rows``)."""
        self._extra = (np.asarray(A_v), np.asarray(b), B_x, B_w)
        self._version += 1
        return self

    def set_scenario_tree(self, tree, consensus: bool = False,
                          scen_mesh=None) -> "MpcController":
        """Stochastic MPC over an ``ops.scenario_tree.ScenarioTree``: the
        joint problem couples S probability-weighted scenario copies under
        non-anticipativity; ``feedback`` returns the shared first-stage
        input and takes the tree's own disturbance paths as the forecast.
        ``v_seq`` is the stacked (S·N, nv) scenario plan.

        ``consensus=False``: one dense joint condensed QP. ``consensus=
        True``: per-scenario QPs coupled by group means inside the ADMM
        (ops/consensus_tree.py). With solver="stagewise" the tree rides
        the O(N) frame (ops/stagewise_tree.py, always the consensus
        formulation; ``consensus`` is ignored) and composes with soft
        rows, move blocking, terminal sets and horizon-coupled rows (per
        scenario: the budget holds on every path). ``scen_mesh``
        ((mesh, axis), or a mesh with a "scen" axis): the consensus and
        stagewise trees split their scenarios over the ranks (every rank
        calls ``feedback`` with the same state and gets the same plan);
        the dense joint frame is one QP and ignores it, as in the
        reference."""
        g0 = np.asarray(tree.groups)[:, 0]
        if not np.all(g0 == g0[0]):
            raise ValueError(
                "scenario tree branches at step 0: every scenario is its "
                "own information set, so there is no shared first-stage "
                "input for feedback to return. Branch at step >= 1 "
                "(here-and-now control requires a common step-0 decision)")
        self._tree = tree
        self._tree_consensus = bool(consensus)
        self._scen_mesh = scen_mesh
        self._version += 1
        return self

    # -- build ---------------------------------------------------------------
    def build(self) -> "MpcController":
        """Condense + prepare solver data (once per configuration
        version). The transforms apply in the reference's order: extra
        rows, then move blocking, then soft rows. A condensed scenario tree
        takes none of them; the stagewise frame takes them all."""
        if self._built_version == self._version:
            return self
        if self.solver == "stagewise":
            return self._build_stagewise()
        tree = self._tree
        if tree is not None and (
                self._soft is not None or self._blocking is not None
                or self._extra is not None or self._terminal is not None):
            raise ValueError(
                "scenario-tree MPC composes with plain stage problems; "
                "apply soft/blocking/extra/terminal transforms to the "
                "joint problem via ops.scenario_tree directly")
        term = {}
        if self._terminal is not None:
            term = dict(terminal_E=self._terminal[0],
                        terminal_f=self._terminal[1])
        c = CondensedMpc(self.model, self.N, self.weights, **term)
        dev = self.device
        if tree is not None and self._tree_consensus:
            from pyhybridcontrol_tpu_torch.ops.consensus_tree import (
                prepare_tree_consensus)

            self._tqp = prepare_tree_consensus(c, tree, rho=self.rho,
                                               device=dev)
            self._tqp_probe = prepare_tree_consensus(
                c, tree, rho=self.rho * 10.0, device=dev)
            self._qp = self._admm = self._admm_probe = self._repair = None
            self._cmpc = c
            self._built_version = self._version
            return self
        if tree is not None:
            from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
                build_scenario_tree_qp)

            c = build_scenario_tree_qp(c, tree)
        if self._extra is not None:
            c = c.with_extra_constraints(*self._extra)
        if self._blocking is not None:
            c = c.with_move_blocking(self._blocking)
        if self._soft is not None:
            c = c.with_soft_constraints(*self._soft)
        self._qp = c.device_qp(dev)
        self._admm = prepare_admm_mpc(c, rho=self.rho, device=dev)
        # stiff-rho prep for dive probes (same Ruiz frame): fixed-binary
        # solves converge faster at rho*10, relaxed nodes are insensitive
        self._admm_probe = (prepare_admm_mpc(c, rho=self.rho * 10.0,
                                             device=dev)
                            if self.solver == "bnb" else None)
        # rollout-repair incumbent heuristic: valid only when the decision
        # frame is the full per-step v (optionally + slacks) of one scenario
        self._repair = None
        if (self.solver == "bnb" and self._blocking is None
                and tree is None and self.model.info.nxb == 0):
            from pyhybridcontrol_tpu_torch.solver.repair import prepare_repair

            rkw = {}
            if self._soft is not None:
                rows, lin, quad = self._soft
                nc = self.model.info.ncons
                rkw = dict(soft_rows=sorted({r % nc for r in rows}),
                           soft_lin=float(np.mean(np.atleast_1d(lin))),
                           soft_quad=float(np.mean(np.atleast_1d(quad))))
            rspec = prepare_repair(self.model, self.weights, device=dev,
                                   **rkw)
            if rspec is not None:
                self._repair = (rspec,
                                "soft" if self._soft is not None else "plain")
        self._cmpc = c
        self._built_version = self._version
        return self

    def _build_stagewise(self) -> "MpcController":
        """The stagewise frame (or, under a scenario tree, the stagewise
        consensus tree) at ρ and the stiff ρ·10 of the dive probes; both
        carry the extra rows, with bordered factors of their own."""
        kw = dict(soft=self._soft, blocking=self._blocking,
                  terminal=self._terminal, extra=self._extra,
                  device=self.device)
        self._cmpc = self._qp = self._admm = self._admm_probe = None
        self._repair = self._tqp = self._tqp_probe = None
        self._sw = self._sw_probe = self._swt = self._swt_probe = None
        if self._tree is not None:
            from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
                prepare_stagewise_tree)

            if self._tree.N != self.N:
                raise ValueError(
                    f"tree N={self._tree.N} != horizon N={self.N}")
            self._swt, self._swt_probe = (
                prepare_stagewise_tree(self.model, self._tree, self.weights,
                                       rho=r, **kw)
                for r in (self.rho, self.rho * 10.0))
        else:
            from pyhybridcontrol_tpu_torch.ops.stagewise import (
                prepare_stagewise)

            self._sw, self._sw_probe = (
                prepare_stagewise(self.model, self.N, self.weights, rho=r,
                                  **kw)
                for r in (self.rho, self.rho * 10.0))
        self._built_version = self._version
        return self

    @property
    def stagewise(self):
        """The stagewise prep (``StagewiseQP``, or ``StagewiseTreeQP``
        under a scenario tree) of solver="stagewise"."""
        self.build()
        return self._swt if self._tree is not None else self._sw

    @property
    def condensed(self) -> CondensedMpc:
        self.build()
        return self._cmpc

    @property
    def device_qp(self):
        self.build()
        return self._qp

    @property
    def admm(self):
        self.build()
        return self._admm

    @property
    def admm_probe(self):
        self.build()
        return self._admm_probe

    @property
    def repair(self):
        """``(RepairSpec, layout)`` of the rollout-repair seed, or None."""
        self.build()
        return self._repair

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
        tensors on the controller's device (a consensus tree returns no
        ``gap``: its node bounds are not certified; the stagewise frame
        adds ``x_seq``, the planned states). Under a scenario tree
        ``omega_forecast`` defaults to the tree's own paths, ``price_seq``
        may have N rows (weighted by the probabilities; unweighted under
        solver="stagewise") or S·N, and ``v_seq`` is the stacked (S·N, nv)
        plan.
        """
        self.build()
        info = self.model.info
        if self._cmpc is not None and not isinstance(x0, torch.Tensor):
            self._cmpc.check_x0(x0)      # a frame with cuts: its trust box
        x0 = self._tensor(x0)
        if x0.ndim != 1 or x0.shape[0] != info.nx:
            raise ValueError(f"x0 must have shape ({info.nx},), got "
                             f"{tuple(x0.shape)}")
        if omega_forecast is not None and info.nomega == 0:
            raise ValueError(
                "omega_forecast given but the model has no disturbance "
                "channel (nomega=0)")
        tree = self._tree
        if price_seq is not None:
            S = tree.S if tree is not None else 1
            if np.shape(price_seq)[0] not in (self.N, S * self.N):
                raise ValueError(
                    f"price_seq must have N={self.N} rows (per control "
                    f"step), got {np.shape(price_seq)}")
        if self.solver == "stagewise":
            if tree is not None:
                return self._feedback_tree_stagewise(x0, price_seq, u_prev)
            return self._feedback_stagewise(x0, omega_forecast, price_seq,
                                            u_prev)
        if tree is not None and self._tree_consensus:
            return self._feedback_tree_consensus(x0, price_seq, u_prev)
        if tree is not None:
            if omega_forecast is None:
                omega_forecast = self._tree_omega()
            if price_seq is not None and np.shape(price_seq)[0] == self.N:
                price_seq = self._tree_prices(price_seq)
        qp, admm = self._qp, self._admm
        W, Pq = self._tensor(omega_forecast), self._tensor(price_seq)
        up = self._tensor(u_prev)
        f, h = qp.assemble(x0, W, up, Pq)
        if self.solver == "bnb":
            seed = None
            if self._repair is not None:
                from pyhybridcontrol_tpu_torch.solver.repair import (
                    root_repair_incumbent)

                rspec, layout = self._repair
                seed = root_repair_incumbent(
                    admm, qp, rspec, x0, f, h, W=W, price_seq=Pq,
                    qp_iters=self.bnb_spec.qp_iters, layout=layout,
                    feas_tol=self.bnb_spec.feas_tol)
            res = solve_miqp_bnb(admm, qp, f, h, self.bnb_spec,
                                 init_incumbent=seed,
                                 admm_probe=self._admm_probe)
            x, obj, found = res.x, res.obj, res.found
            nodes = res.nodes_solved
            gap = self._gap(res)
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
        over ``pooled_wave`` nodes — under a dense scenario tree, with
        rep-map branching, K1 launches of the relaxation and the probe),
        "vmap" (one ``feedback`` per instance, in a loop: the reference
        vmaps independent per-instance searches, so the results are the
        same function; ``torch.func.vmap`` cannot carry the wave loop's
        host reads; every solver) or "auto" (pooled for solver="bnb"
        without a consensus tree, else vmap). ``mesh``: a mesh with a
        "scen" axis; every rank passes the whole batch, solves its slice
        (P must divide B) with the engine "auto" picks for that slice, and
        gets the whole gathered result.
        ``pooled_wave``/``pool_slots`` size the pooled search; the
        per-instance node budget matches ``bnb_spec`` (``max_waves``
        rescales to the global wave size).

        ``x0s`` (B, nx); ``omega_forecasts``/``u_prevs`` optionally carry
        the same leading batch dimension; ``price_seq`` is shared.
        Returns StructDict(u, delta, z, v_seq, obj, found, nodes, gap)
        with a leading (B,) axis; ``nodes`` is the global node count.
        """
        self.build()
        consensus = self._tree is not None and self._tree_consensus
        if engine == "auto":
            engine = ("pooled" if self.solver == "bnb" and not consensus
                      else "vmap")
        if engine not in ("pooled", "vmap"):
            raise ValueError(f"unknown engine {engine!r}")
        if engine == "pooled" and self.solver != "bnb":
            raise ValueError(
                f'engine="pooled" requires solver="bnb", got '
                f'{self.solver!r}')
        if engine == "pooled" and consensus:
            raise ValueError('engine="pooled" supports dense-joint '
                             "scenario trees (rep-map branching); batch "
                             "consensus trees through the vmap engine")
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
        if mesh is not None:
            from pyhybridcontrol_tpu_torch.parallel.mesh import (
                scenario_sharding)

            sh = scenario_sharding(mesh, "scen")
            part = self.feedback_batch(
                sh.local(x0s), None if W is None else sh.local(W), Pq,
                None if up is None else sh.local(up), engine=engine,
                pooled_wave=pooled_wave, pool_slots=pool_slots)
            return sh.gather(part)
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

    def _tree_omega(self):
        """The tree's own disturbance paths, stacked scenario-major:
        (S·N, nω), or None for a model without disturbances."""
        t = self._tree
        if not t.omega_paths.size:
            return None
        return np.asarray(t.omega_paths, np.float32).reshape(t.S * t.N, -1)

    def _tree_prices(self, price_seq):
        """(N, nv) single-scenario prices → the joint frame's (S·N, nv),
        weighted by the scenario probabilities."""
        from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
            tree_price_seq)

        if isinstance(price_seq, torch.Tensor):
            price_seq = price_seq.cpu().numpy()
        return tree_price_seq(self._tree, np.asarray(price_seq))

    def _feedback_batch_pooled(self, x0s, W, Pq, up, pooled_wave,
                               pool_slots) -> StructDict:
        """feedback_batch engine="pooled": batched assembly, batched
        rollout-repair seeds, one pooled B&B over the batch. A dense
        scenario tree is one MIQP of the joint frame per instance, branched
        once per information-set group (``tree_branch_map``), with the
        tree's paths as every instance's forecast."""
        qp, admm, spec = self._qp, self._admm, self.bnb_spec
        B = x0s.shape[0]
        branch_map = None
        if self._tree is not None:
            from pyhybridcontrol_tpu_torch.ops.scenario_tree import (
                tree_branch_map)

            branch_map = tree_branch_map(self._cmpc, self._tree)
            if W is None and self._tree_omega() is not None:
                W = self._tensor(self._tree_omega()).expand(
                    B, -1, -1)
            if Pq is not None and Pq.shape[0] == self.N:
                Pq = self._tensor(self._tree_prices(Pq))
        f, h = qp.assemble(x0s, W, up, Pq)
        seed = None
        if self._repair is not None:
            from pyhybridcontrol_tpu_torch.solver.repair import (
                root_repair_incumbent)

            rspec, layout = self._repair
            seed = root_repair_incumbent(
                admm, qp, rspec, x0s, f, h, W=W, price_seq=Pq,
                qp_iters=spec.qp_iters, layout=layout,
                feas_tol=spec.feas_tol)
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
                                    admm_probe=self._admm_probe,
                                    branch_map=branch_map)
        v_seq = qp.full_v(res.x)                          # (B, N, nv)
        info = self.model.info
        v0 = v_seq[:, 0]
        return StructDict(
            u=v0[:, info.u_slice], delta=v0[:, info.delta_slice],
            z=v0[:, info.z_slice], v_seq=v_seq, obj=res.obj,
            found=res.found, nodes=res.nodes_solved.expand(B),
            gap=self._gap(res))

    def _feedback_tree_consensus(self, x0, price_seq, u_prev) -> StructDict:
        """Consensus-ADMM tree MIQP (ops/consensus_tree.py): per-scenario
        QPs with non-anticipativity through group means. The tree supplies
        its own disturbance paths; ``price_seq`` is the single-scenario
        (N, nv) sequence, unweighted (the iteration carries the
        probabilities)."""
        from pyhybridcontrol_tpu_torch.ops.consensus_tree import (
            assemble_tree, solve_tree_miqp)

        tqp, info = self._tqp, self.model.info
        f, h = assemble_tree(tqp, x0, price_seq=self._tensor(price_seq),
                             u_prev=self._tensor(u_prev))
        res = solve_tree_miqp(tqp, f, h, self.bnb_spec,
                              tqp_probe=self._tqp_probe,
                              scen_mesh=self._scen_mesh)
        V = res.x.reshape(tqp.S, tqp.N, info.nv)
        v0 = V[0, 0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=V.reshape(tqp.S * tqp.N, info.nv),
            obj=res.obj, found=res.found, nodes=res.nodes_solved)

    def _gap(self, res):
        """Certified relative optimality gap of a B&B result (0 when the
        frontier was exhausted; folds overflow-dropped bounds)."""
        bo = res.best_open_bound
        return torch.where(res.found & torch.isfinite(bo) & (bo < res.obj),
                           (res.obj - bo)
                           / torch.clamp_min(res.obj.abs(), 1.0), 0.0)

    def _feedback_stagewise(self, x0, omega_forecast, price_seq, u_prev):
        """The MIQP on the stagewise O(N) frame (solver/bnb_stagewise.py)."""
        from pyhybridcontrol_tpu_torch.ops.stagewise import (
            assemble_stagewise, assemble_stagewise_ext)
        from pyhybridcontrol_tpu_torch.solver.bnb_stagewise import (
            solve_miqp_bnb_stagewise)

        sw, info = self._sw, self.model.info
        W = self._tensor(omega_forecast)
        q, l, u = assemble_stagewise(sw, x0, W, self._tensor(price_seq),
                                     u_prev=self._tensor(u_prev))
        ext_u = assemble_stagewise_ext(sw, x0, W) if sw.n_ext else None
        res = solve_miqp_bnb_stagewise(sw, q, l, u, self.bnb_spec,
                                       sw_probe=self._sw_probe,
                                       parallel_sweeps=self.sw_parallel,
                                       ext_u=ext_u)
        xi = res.x.reshape(sw.N, sw.b)
        v_seq = xi[:, :sw.nv]
        v0 = v_seq[0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=v_seq, obj=res.obj, found=res.found,
            nodes=res.nodes_solved, gap=self._gap(res), x_seq=xi[:, sw.nv:])

    def _feedback_tree_stagewise(self, x0, price_seq, u_prev):
        """Scenario-tree MIQP on the stagewise O(N) frame
        (ops/stagewise_tree.py): per-scenario block-tridiagonal
        relaxations and the group-mean consensus prox. The tree supplies
        its own disturbance paths; ``price_seq`` is the single-scenario
        (N, nv) sequence, unweighted (the probabilities live in the
        iteration)."""
        from pyhybridcontrol_tpu_torch.ops.stagewise_tree import (
            assemble_stagewise_tree, assemble_stagewise_tree_ext,
            solve_tree_miqp_stagewise)

        swt, info = self._swt, self.model.info
        sw = swt.sw
        q, l, u = assemble_stagewise_tree(
            swt, x0, price_seq=self._tensor(price_seq),
            u_prev=self._tensor(u_prev))
        ext_u = assemble_stagewise_tree_ext(swt, x0) if sw.n_ext else None
        res = solve_tree_miqp_stagewise(
            swt, q, l, u, self.bnb_spec, swt_probe=self._swt_probe,
            parallel_sweeps=self.sw_parallel, scen_mesh=self._scen_mesh,
            ext_u=ext_u)
        xi = res.x.reshape(swt.S, sw.N, sw.b)
        v_seq = xi[:, :, :sw.nv]
        v0 = v_seq[0, 0]
        return StructDict(
            u=v0[info.u_slice], delta=v0[info.delta_slice],
            z=v0[info.z_slice], v_seq=v_seq.reshape(swt.S * sw.N, info.nv),
            obj=res.obj, found=res.found, nodes=res.nodes_solved,
            gap=self._gap(res), x_seq=xi[:, :, sw.nv:])
