"""Pool-sharded branch-and-bound over a mesh axis (config 5).

Counterpart of ``pyhybridcontrol_tpu/parallel/sharded_bnb.py``. Each rank
owns a shard of the node pool of ONE MIQP and runs the single-card wave
loop (solver/bnb.py ``_bnb_loop``, its K2 launch a wave, or K1 on a gated
wave) with the collectives in its hooks:

  * incumbent: one all_gather of (obj, found, x) after each wave's
    incumbent update, and the first argmin over ranks;
  * load balance: the child-1 batch of every wave goes round-robin over
    the ranks with one ``all_to_all_single`` (child i of rank r to rank
    i mod P), so work spreads from the root rank; a received dead child
    lands in the dump row, as a local one does;
  * termination: OR over ranks of "any node active", and the min over
    ranks of the best open bound (the ``rel_gap`` stop reads it).

The loop is lock-step SPMD: the continue test of every wave reads only
reduced values, so every rank runs the same waves and the collectives
always match. Problem data and the optional seed are broadcast from the
axis' first rank (replicated data must be bitwise equal on every rank).
The child batch travels as one tensor of the pool's dtype: the integer
fields (depth, branching variable) and the flags are exact in it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from pyhybridcontrol_tpu_torch.ops.admm import BoxQP
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.parallel.mesh import AxisComm, replicated
from pyhybridcontrol_tpu_torch.solver.bnb import (
    BnbResult,
    BnbSpec,
    CondensedBackend,
    LoopHooks,
    _bnb_loop,
)
from pyhybridcontrol_tpu_torch.utils.select import first_arg

# the child-1 batch's fields, in packing order
_CHILD_KEYS = ("fm", "fv", "bound", "depth", "live", "bv", "bf", "xw", "zw",
               "yw")


def pool_hooks(comm: AxisComm) -> Tuple[LoopHooks, bool]:
    """The loop hooks of a pool sharded over ``comm``'s axis, and whether
    this rank's pool starts with the root (the axis' first rank)."""
    P = comm.size

    def reduce_incumbent(inc_obj, inc_x, inc_found):
        packed = torch.cat([inc_obj.reshape(1),
                            inc_found.to(inc_obj.dtype).reshape(1),
                            inc_x.to(inc_obj.dtype)])
        got = comm.all_gather(packed)                  # (P, n + 2)
        k = first_arg(got[:, 0], largest=False)
        return got[k, 0], got[k, 2:].to(inc_x.dtype), (got[:, 1] > 0).any()

    def exchange_children(c1):
        keys = [k for k in _CHILD_KEYS if k in c1]
        W = c1["bound"].shape[0]
        dt = c1["fv"].dtype
        cols = [c1[k].reshape(W, -1).to(dt) for k in keys]
        widths = [c.shape[1] for c in cols]
        packed = torch.cat(cols, dim=1)                # (W, K)
        # child i goes to rank i mod P: rows regrouped rank-major
        send = packed.reshape(W // P, P, -1).transpose(0, 1).reshape(W, -1)
        got = comm.all_to_all(send.contiguous())
        out = {}
        for k, part in zip(keys, torch.split(got, widths, dim=1)):
            ref = c1[k]
            out[k] = part.reshape(ref.shape).to(ref.dtype)
        return out

    return LoopHooks(exchange_children=exchange_children,
                     reduce_incumbent=reduce_incumbent,
                     global_any_active=comm.any,
                     reduce_min=comm.min), comm.rank == 0


def solve_miqp_bnb_sharded(admm: BoxQP, qp: DeviceQP, f, h,
                           spec: BnbSpec, mesh, axis: str = "pool",
                           init_incumbent=None,
                           admm_probe: Optional[BoxQP] = None) -> BnbResult:
    """Solve one MIQP with its B&B pool sharded over ``mesh[axis]``.
    Every rank of the axis calls it with the same arguments.
    ``spec.capacity``/``wave_size`` are per rank (P must divide
    ``wave_size``); ``init_incumbent`` (obj, V, ok) is the optional
    heuristic seed. Returns a replicated BnbResult: ``nodes_solved``
    summed over ranks, ``overflow`` ORed, ``best_open_bound`` the min;
    ``waves`` is the same on every rank."""
    comm = AxisComm(mesh, axis)
    if spec.wave_size % comm.size != 0:
        raise ValueError("wave_size must be divisible by the pool axis size")
    f, h, init_incumbent = replicated(comm, f, h, init_incumbent)
    hooks, root_here = pool_hooks(comm)
    res = _bnb_loop(CondensedBackend(admm, qp, admm_probe), f, h, spec,
                    init_incumbent=init_incumbent, hooks=hooks,
                    root_here=root_here)
    total = comm.all_reduce(torch.stack([
        res.nodes_solved.to(torch.float64),
        res.overflow.to(torch.float64)]))
    return BnbResult(x=res.x, obj=res.obj, found=res.found, waves=res.waves,
                     nodes_solved=total[0].to(res.nodes_solved.dtype),
                     overflow=total[1] > 0,
                     best_open_bound=res.best_open_bound)
