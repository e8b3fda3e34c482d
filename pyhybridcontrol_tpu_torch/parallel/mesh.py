"""Meshes and collectives on ``torch.distributed``.

Counterpart of ``pyhybridcontrol_tpu/parallel/mesh.py``. The reference
names the mesh axes of one SPMD program (``jax.shard_map``); here the
program is one process per rank, every rank running the same code in
lock-step, and a mesh is a ``torch.distributed.device_mesh.DeviceMesh``
over the first ranks of the initialized world:

  * ``scen`` — data parallelism over independent instances or scenarios:
    a rank takes its contiguous slice of the leading axis
    (``scenario_sharding``) and ``gather_rows`` returns the whole batch to
    every rank; a scenario tree's scenarios split the same way
    (``scenario_shard``), and its consensus mean crosses the ranks
    (``sharded_group_mean``);
  * ``pool`` — one MIQP's node pool over ranks (parallel/sharded_bnb.py);
  * ``hz`` — the horizon's block rows or stages over ranks.

Backend rule, from the topology alone: NCCL when every rank has a card of
its own, gloo when ranks share a card or run on the CPU
(``backend_for``). Rank r uses ``cuda:{r % device_count}``. Under gloo a
CUDA payload passes through the host: ``AxisComm`` copies it there and
back itself, so every collective here takes the same path whatever gloo's
CUDA support, and its calls, bytes and time are counted in ``STATS``.

Only the collectives gloo implements are used: ``all_gather`` (the list
form), ``all_to_all_single``, ``all_reduce`` (SUM, MIN, MAX) and
``broadcast``.
"""

from __future__ import annotations

import time
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# collective calls, payload bytes (each rank's input) and host seconds of
# this process since the last ``reset_stats``
STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}


def reset_stats():
    STATS.update(calls=0, bytes=0, seconds=0.0)


def backend_for(world_size: int, device_type: str) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if (device_type == "cuda" and torch.cuda.is_available()
            and world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def rank_device(rank: int, device_type: str) -> torch.device:
    """Rank r's device: ``cuda:{r % device_count}``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", rank % torch.cuda.device_count())
    return torch.device("cpu")


def make_mesh(axis_sizes: Sequence[Tuple[str, int]],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` over the first n = Π sizes ranks of the world, e.g.
    ``make_mesh([("pool", 4)])``. Every rank of the world calls it (the
    groups are created collectively); a rank outside the mesh gets one
    whose ``get_coordinate()`` is None. Raises if the world is smaller
    than n."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialized "
                           "(parallel.launch.spawn or init_process_group)")
    names = tuple(n for n, _ in axis_sizes)
    sizes = tuple(int(s) for _, s in axis_sizes)
    n = 1
    for s in sizes:
        n *= s
    world = dist.get_world_size()
    if world < n:
        raise ValueError(f"need {n} ranks, have {world}")
    return DeviceMesh(device_type, torch.arange(n).reshape(sizes),
                      mesh_dim_names=names)


def in_mesh(mesh) -> bool:
    return mesh.get_coordinate() is not None


def mesh_backend(mesh) -> str:
    """The backend of the mesh's groups: that of the world, which
    ``make_mesh``'s groups inherit (a rank outside the mesh has no group)."""
    if in_mesh(mesh):
        return dist.get_backend(mesh.get_group(mesh.mesh_dim_names[0]))
    return dist.get_backend()


def _split_mesh(mesh_axis, default: str):
    """``(mesh, axis)`` from a DeviceMesh or a ``(mesh, axis)`` pair (the
    reference's ``scen_mesh`` form)."""
    if isinstance(mesh_axis, tuple):
        return mesh_axis
    return mesh_axis, default


class AxisComm:
    """The collectives of one mesh axis, as this rank sees them: ``rank``
    and ``size`` along the axis; payloads staged through the host under
    gloo; every call counted in ``STATS``."""

    def __init__(self, mesh, axis: str):
        if axis not in (mesh.mesh_dim_names or ()):
            raise ValueError(f"mesh has no axis {axis!r} "
                             f"({mesh.mesh_dim_names})")
        if not in_mesh(mesh):
            raise ValueError("this rank is not in the mesh")
        self.mesh, self.axis = mesh, axis
        self.group = mesh.get_group(axis)
        self.rank = mesh.get_local_rank(axis)
        self.size = mesh.size(mesh.mesh_dim_names.index(axis))
        self.backend = dist.get_backend(self.group)
        self.root = dist.get_global_rank(self.group, 0)

    def _run(self, op, t: torch.Tensor, *extra):
        """``op(host_or_device_tensor, *extra)`` with the payload on the
        host under gloo; returns what op returns, on t's device."""
        t0 = time.perf_counter()
        staged = self.backend == "gloo" and t.is_cuda
        x = t.detach().cpu() if staged else t.detach().contiguous()
        out = op(x, *extra)
        if staged:
            out = (out.to(t.device) if isinstance(out, torch.Tensor)
                   else [o.to(t.device) for o in out])
        STATS["calls"] += 1
        STATS["bytes"] += t.numel() * t.element_size()
        STATS["seconds"] += time.perf_counter() - t0
        return out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's t, in rank order."""
        def op(x):
            parts = [torch.empty_like(x) for _ in range(self.size)]
            dist.all_gather(parts, x, group=self.group)
            return torch.stack(parts)
        return self._run(op, t)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                   ) -> torch.Tensor:
        def run(x):
            x = x.clone()
            dist.all_reduce(x, op=op, group=self.group)
            return x
        return self._run(run, t)

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Dim 0 split in ``size`` equal chunks: chunk j goes to rank j,
        and chunk i of the result came from rank i."""
        def run(x):
            out = torch.empty_like(x)
            dist.all_to_all_single(out, x, group=self.group)
            return out
        return self._run(run, t)

    def broadcast(self, t: torch.Tensor) -> torch.Tensor:
        """Axis rank 0's t on every rank (replicated data, bitwise)."""
        def run(x):
            x = x.clone()
            dist.broadcast(x, src=self.root, group=self.group)
            return x
        return self._run(run, t)

    def any(self, flag: torch.Tensor) -> torch.Tensor:
        """OR over ranks of a bool scalar."""
        v = self.all_reduce(flag.to(torch.float32).reshape(1),
                            dist.ReduceOp.MAX)
        return v[0] > 0

    def min(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x.reshape(1), dist.ReduceOp.MIN)[0]

    def gather_cat(self, tensors, dim: int):
        """Every tensor concatenated along ``dim`` over the ranks, in rank
        order, in ONE all_gather: all tensors share their shape up to
        ``dim`` (inclusive); every tensor rides as one float type
        (fp32 where every tensor is fp32 or bool, else fp64: exact for
        fp32 values, bools and integers below 2^53)."""
        d = dim % tensors[0].ndim
        lead = tensors[0].shape[:d + 1]
        wide = torch.float32
        if any(t.dtype not in (torch.float32, torch.bool) for t in tensors):
            wide = torch.float64
        flat = [t.reshape(lead + (-1,)).to(wide) for t in tensors]
        sizes = [f.shape[-1] for f in flat]
        got = self.all_gather(torch.cat(flat, dim=-1))   # (P, *lead, K)
        full = torch.cat(list(got), dim=d)
        out = []
        for t, part in zip(tensors, torch.split(full, sizes, dim=-1)):
            shape = full.shape[:d + 1] + t.shape[d + 1:]
            out.append(part.reshape(shape).to(t.dtype))
        return out


class ScenarioSharding:
    """A batch's leading axis split over ``mesh[axis]``: this rank takes
    the contiguous slice ``bounds(n)``; ``gather`` returns every rank's
    rows, in rank order, to every rank."""

    def __init__(self, mesh, axis: str = "scen"):
        self.comm = AxisComm(mesh, axis)
        self.axis = axis

    def bounds(self, n: int):
        """``(lo, hi)`` of this rank's rows of n; raises unless the axis
        size divides n."""
        P = self.comm.size
        if n % P:
            raise ValueError(f"{n} rows do not split evenly over the "
                             f"{P} ranks of axis {self.axis!r}")
        per = n // P
        return self.comm.rank * per, (self.comm.rank + 1) * per

    def local(self, x, dim: int = 0):
        lo, hi = self.bounds(x.shape[dim])
        return x.narrow(dim, lo, hi - lo)

    def gather(self, tensors, dim: int = 0):
        """The rows of every rank concatenated along ``dim`` (a tensor, a
        list of tensors, or a dict / StructDict of tensors), in one
        collective."""
        if isinstance(tensors, torch.Tensor):
            return self.comm.gather_cat([tensors], dim)[0]
        if isinstance(tensors, (list, tuple)):
            return self.comm.gather_cat(list(tensors), dim)
        keys = list(tensors)
        vals = self.comm.gather_cat([tensors[k] for k in keys], dim)
        return type(tensors)(zip(keys, vals))


def scenario_sharding(mesh, axis: str = "scen") -> ScenarioSharding:
    """Sharding of a batch of independent instances: leading axis split
    over ``mesh[axis]``, everything else replicated."""
    return ScenarioSharding(mesh, axis)


def scenario_shard(scen_mesh, S: int) -> ScenarioSharding:
    """The ``ScenarioSharding`` of a tree's S scenarios over ``scen_mesh``
    ((mesh, axis) or a mesh with a "scen" axis), checked: P divides S."""
    mesh, axis = _split_mesh(scen_mesh, "scen")
    sh = ScenarioSharding(mesh, axis)
    sh.bounds(S)
    return sh


def sharded_group_mean(sh: ScenarioSharding, M, S: int):
    """The consensus prox of a scenario tree whose S scenarios ``sh``
    splits (M: the (S, S, N) p-weighted group-mean tensor): a function of
    the rank's (…, S/P, N, n_cons) block. Σ over the rank's scenarios t of
    M[s, t]·v[t] for all s, one all_reduce(SUM), the rank's rows."""
    lo, hi = sh.bounds(S)
    M_loc = M[:, lo:hi]

    def mean(v):
        part = torch.einsum("stk,...tkj->...skj", M_loc, v)
        return sh.comm.all_reduce(part)[..., lo:hi, :, :]

    return mean


def gather_rows(mesh, x_local, axis: str = "scen"):
    """The full batch on every rank from each rank's rows (a tensor, or a
    dict / StructDict of tensors sharing the leading axis)."""
    return ScenarioSharding(mesh, axis).gather(x_local)


def replicated(comm: AxisComm, *args):
    """``args`` (tensors, None, or tuples of tensors such as an
    ``init_incumbent``) as the axis' first rank holds them, sent to every
    rank: replicated data must be bitwise equal on every rank, so it is
    sent, not recomputed. Dtypes are kept (a float64 round trip is exact
    for float32, bools and integers below 2^53)."""
    def send(a):
        if a is None:
            return None
        if isinstance(a, tuple):
            return tuple(send(t) for t in a)
        return comm.broadcast(a.to(torch.float64)).to(a.dtype)
    return tuple(send(a) for a in args)
