"""Receding-horizon closed loop: the MIQP control step run over T steps.

Counterpart of ``pyhybridcontrol_tpu/loop/closed_loop.py``. The reference
scans the step with ``lax.scan`` inside one jitted program; here the scan
is a Python loop over T on the step's device, carrying ``(x, u_prev)``
and, for a B&B step built with ``shift_warm``, the last plan and whether
it was found. Each step measures the state, solves the MIQP (B&B through
K2, or exhaustive enumeration), applies the first decision to the model
and logs it. ``closed_loop_batch`` runs B scenarios per step through the
pooled B&B (solver/bnb_pooled.py): all instances' nodes share one pool,
so every wave is one kernel launch over many instances.

Logs are tensors stacked over time: states, decisions, outputs, per-step
objectives, ``found`` flags and node counts, and the final carried plan,
which resumes a chunked study exactly (``prev_plan``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import BoxQP
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import solve_miqp_bnb_pooled
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)
from pyhybridcontrol_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass
class ClosedLoopResult:
    xs: torch.Tensor       # (T+1, nx) state trajectory
    vs: torch.Tensor       # (T, nv) applied per-step decision [u; δ; z]
    ys: torch.Tensor       # (T, ny) outputs
    objs: torch.Tensor     # (T,) per-step MIQP objective (no offset)
    found: torch.Tensor    # (T,) solver reported a feasible incumbent
    nodes: torch.Tensor    # (T,) B&B nodes solved (0 for enumeration)
    # final carried plan: pass (plan, plan_ok) as ``prev_plan`` to resume
    # a chunked study on the trajectory of the uninterrupted one; empty
    # and False when the step carries no plan
    plan: torch.Tensor     # (n,) last solved decision vector
    plan_ok: torch.Tensor  # () bool


def _shifted_node(qp: DeviceQP, Vp, okp):
    """The carried-plan candidate ``(bvals, ok, V)``: the previous plan's
    binaries, rounded and shifted one stage by ``qp.binary_shift`` (any
    leading batch axis)."""
    bidx = torch.as_tensor(qp.binary_idx, dtype=torch.long, device=Vp.device)
    shift = torch.as_tensor(qp.binary_shift, dtype=torch.long,
                            device=Vp.device)
    bprev = torch.round(torch.clamp(Vp[..., bidx], 0.0, 1.0))
    return bprev[..., shift], okp, Vp


def _uses_shift(qp: DeviceQP, shift_warm: bool) -> bool:
    return (shift_warm and qp.n_binary > 0
            and len(qp.binary_shift) == qp.n_binary)


def make_mpc_step(model: MldModel, qp: DeviceQP, admm: BoxQP,
                  method: str = "bnb",
                  bnb_spec: Optional[BnbSpec] = None,
                  qp_iters: int = 100,
                  repair=None, shift_warm: bool = True,
                  admm_probe: Optional[BoxQP] = None) -> Callable:
    """Build the single-control-step function
    ``step(x, W, price_seq, u_prev[, prev]) -> (v_seq (N,nv), obj, found,
    nodes, V)`` on the device of ``qp``.

    ``method``: "bnb" (wave-parallel B&B) or "enumerate" (exact, 2^nb
    batched QPs of ``qp_iters`` iterations). ``repair``: optional
    ``(RepairSpec, "plain")`` — seeds the B&B incumbent with the greedy
    rollout repair (solver/repair.py). ``shift_warm``: when the caller
    passes the previous step's ``prev=(V, ok)`` (``closed_loop`` carries
    it), the previous plan's binaries shifted one stage are injected as a
    fully-fixed wave-1 node: its relaxation is the fixed-binary
    re-optimization and its probe an incumbent, at no extra QP solve.
    """
    if method not in ("bnb", "enumerate"):
        raise ValueError(f"unknown method {method!r}")
    spec = bnb_spec or BnbSpec()
    rspec = None
    if repair is not None:
        from pyhybridcontrol_tpu_torch.solver.repair import (
            root_repair_incumbent)

        rspec, layout = repair
        if layout != "plain":
            raise NotImplementedError(
                f"repair layout {layout!r} is not ported to "
                "pyhybridcontrol_tpu_torch yet (ROADMAP queue 1: condense "
                "transforms)")
    use_shift = method == "bnb" and _uses_shift(qp, shift_warm)

    def step(x, W=None, price_seq=None, u_prev=None, prev=None):
        f, h = qp.assemble(x, W, u_prev, price_seq)
        if method == "enumerate":
            xV, obj, _, feas = solve_miqp_enumerate_device(
                admm, qp, f, h, iters=qp_iters)
            return (qp.full_v(xV), obj, feas.any(),
                    torch.zeros((), dtype=torch.long, device=f.device), xV)
        seed = None
        if rspec is not None:
            seed = root_repair_incumbent(
                admm, qp, rspec, x, f, h, W=W, price_seq=price_seq,
                qp_iters=spec.qp_iters, feas_tol=spec.feas_tol)
        init_node = (_shifted_node(qp, *prev)
                     if use_shift and prev is not None else None)
        res = solve_miqp_bnb(admm, qp, f, h, spec, init_incumbent=seed,
                             init_node=init_node, admm_probe=admm_probe)
        return qp.full_v(res.x), res.obj, res.found, res.nodes_solved, res.x

    step.carries_plan = use_shift
    step.n_dec = qp.n
    step.device = qp.H.device
    return step


def _device(step):
    """The device a step solves on (its ``device``; the card for a step
    that does not say, as every entry point defaults to it)."""
    dev = getattr(step, "device", None)
    return dev if dev is not None else resolve_device()


def _on(device, a):
    return (None if a is None
            else torch.as_tensor(a, dtype=torch.float32, device=device))


def _window(traj, k: int, T: int, axis: int = 0):
    """``traj[k : k + len − T]`` along ``axis`` (the reference's
    ``dynamic_slice_in_dim`` with a window of the trajectory's length less
    T), or None."""
    if traj is None:
        return None
    return traj.narrow(axis, k, traj.shape[axis] - T)


def _run(model: MldModel, mpc_step, x0, T: int, omega_traj, price_traj,
         u_prev0, plan0, batched: bool = False) -> ClosedLoopResult:
    """The receding-horizon loop: T steps carrying ``(x, u_prev)`` and,
    where ``plan0`` is given, ``(plan, plan_ok)``. ``batched``: a leading
    (B,) axis on every carried and logged tensor; the disturbance
    trajectory's time axis is then its second."""
    if T < 1:
        raise ValueError(f"closed loop: T must be at least 1, got {T}")
    info = model.info
    t_ax = 1 if batched else 0
    x, u_prev = x0, u_prev0
    carries = plan0 is not None
    plan, plan_ok = plan0 if carries else (None, None)
    logs = []
    for k in range(T):
        W = _window(omega_traj, k, T, t_ax)
        P = _window(price_traj, k, T)
        out = mpc_step(x, W, P, u_prev,
                       prev=(plan, plan_ok) if carries else None)
        v0 = out[0] if batched else out[0][0]
        obj, found, nodes, V = out[1:]
        u, d, z = info.split_v(v0)
        w_k = None if omega_traj is None else omega_traj.select(t_ax, k)
        y = model.output(x, u, d, z, w_k)
        x = model.step(x, u, d, z, w_k)
        u_prev = u
        if carries:
            plan, plan_ok = V, found
        logs.append((x, v0, y, obj, found, nodes))
    xs, vs, ys, objs, found, nodes = (torch.stack(c) for c in zip(*logs))
    if not carries:
        plan = x0.new_zeros((0,))
        plan_ok = torch.zeros((), dtype=torch.bool, device=x0.device)
    return ClosedLoopResult(xs=torch.cat([x0[None], xs]), vs=vs, ys=ys,
                            objs=objs, found=found, nodes=nodes, plan=plan,
                            plan_ok=plan_ok)


def closed_loop(model: MldModel, mpc_step, x0, T: int,
                omega_traj=None, price_traj=None,
                u_prev0=None, prev_plan=None) -> ClosedLoopResult:
    """Run a T-step receding-horizon simulation on the step's device.

    ``omega_traj``: (T+N, nomega) actual disturbances — the controller
    sees the next-N window at each step (perfect forecast; wrap
    ``mpc_step`` for another forecast model). ``price_traj``: (T+N, nv)
    per-step linear cost sequence. When ``mpc_step`` carries the plan
    (a B&B step of :func:`make_mpc_step` with ``shift_warm``), each step is
    seeded with the previous step's plan shifted one stage;
    ``prev_plan=(V, ok)`` seeds step 0 (a study resumed from a chunk).
    Batched scenarios: :func:`closed_loop_batch`.
    """
    dev = _device(mpc_step)
    model = model.to(dev)
    x0 = _on(dev, x0)
    u_prev0 = (x0.new_zeros((model.info.nu,)) if u_prev0 is None
               else _on(dev, u_prev0))
    plan0 = None
    if getattr(mpc_step, "carries_plan", False):
        if prev_plan is None:
            plan0 = (x0.new_zeros((mpc_step.n_dec,)),
                     torch.zeros((), dtype=torch.bool, device=dev))
        else:
            plan0 = (_on(dev, prev_plan[0]),
                     torch.as_tensor(prev_plan[1], dtype=torch.bool,
                                     device=dev))
    return _run(model, mpc_step, x0, T, _on(dev, omega_traj),
                _on(dev, price_traj), u_prev0, plan0)


def make_mpc_step_batch(model: MldModel, qp: DeviceQP, admm: BoxQP,
                        bnb_spec: Optional[BnbSpec] = None,
                        pool_slots: int = 0,
                        admm_probe: Optional[BoxQP] = None,
                        shift_warm: bool = True) -> Callable:
    """Batched control step over B scenarios through the POOLED B&B
    (solver/bnb_pooled.py): per step all B instances' nodes share one
    pool, and every wave is one K2 launch over many instances.

    ``step(xs (B,nx), Ws (B,N,nω)|None, price_seq (N,nv)|None,
    u_prevs (B,nu)|None, prev=(V (B,n), ok (B,))|None) → (v0 (B,nv), obj,
    found, nodes, V)``. ``prev`` injects each instance's previous plan,
    binaries shifted one stage, as a fully-fixed wave-1 node."""
    spec = bnb_spec or BnbSpec()
    use_shift = _uses_shift(qp, shift_warm)

    def step(xs, Ws=None, price_seq=None, u_prevs=None, prev=None):
        f, h = qp.assemble(xs, Ws, u_prevs, price_seq)
        init_node = (_shifted_node(qp, *prev)
                     if use_shift and prev is not None else None)
        res = solve_miqp_bnb_pooled(admm, qp, f, h, spec,
                                    pool_slots=pool_slots,
                                    init_node=init_node,
                                    admm_probe=admm_probe)
        v_seq = qp.full_v(res.x)                        # (B, N, nv)
        return v_seq[:, 0], res.obj, res.found, res.nodes_solved, res.x

    step.carries_plan = use_shift
    step.n_dec = qp.n
    step.device = qp.H.device
    return step


def closed_loop_batch(model: MldModel, step_batch, x0s, T: int,
                      omega_trajs=None, price_traj=None
                      ) -> ClosedLoopResult:
    """T-step receding-horizon simulation of B scenarios with the pooled
    per-step engine (:func:`make_mpc_step_batch`). x0s (B, nx);
    ``omega_trajs`` (B, T+N, nω) per-scenario disturbances (perfect
    next-N forecast); ``price_traj`` (T+N, nv) shared. Logs are stacked
    (T, B, …) and ``xs`` (T+1, B, nx); ``nodes`` is the global pooled node
    count per step."""
    dev = _device(step_batch)
    model = model.to(dev)
    x0s = _on(dev, x0s)
    B = x0s.shape[0]
    plan0 = None
    if getattr(step_batch, "carries_plan", False):
        plan0 = (x0s.new_zeros((B, step_batch.n_dec)),
                 torch.zeros((B,), dtype=torch.bool, device=dev))
    return _run(model, step_batch, x0s, T, _on(dev, omega_trajs),
                _on(dev, price_traj), x0s.new_zeros((B, model.info.nu)),
                plan0, batched=True)
