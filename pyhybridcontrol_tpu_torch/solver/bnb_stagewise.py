"""Long-horizon MIQP: branch-and-bound over the stagewise O(N) frame.

Counterpart of ``pyhybridcontrol_tpu/solver/bnb_stagewise.py``: the wave
loop of solver/bnb.py through the backend protocol, with node relaxations
solved by the block-tridiagonal stagewise ADMM (ops/stagewise.py: on the
card one K5 launch a relaxation or probe) instead of the condensed
kernels. Memory and work
per iteration are O(N·b²), so horizons in the hundreds stay on the card.

``StagewiseBackend`` has no ``solve_wave`` and no ``node_cert``: each wave
runs the relaxation, rounds it and runs the dive probe (the unfused
composition of solver/bnb.py), and node bounds are certified by
``node_bound`` (``stagewise_dual_bound``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from pyhybridcontrol_tpu_torch.ops.stagewise import (
    StagewiseQP,
    _with_box,
    stagewise_admm_solve,
    stagewise_dual_bound,
)
from pyhybridcontrol_tpu_torch.solver.bnb import BnbResult, BnbSpec, _bnb_loop


@dataclasses.dataclass
class StagewiseBackend:
    """Backend over the flat decision ξ ∈ R^{N·b} of the stagewise frame;
    ``h`` stacks the (l, u) row bounds.

    ``sw_probe``: optional stiff-ρ prep for the dive probes (fixed-binary
    solves converge faster at ρ·10; relaxed nodes are insensitive). Warm
    iterates pass unchanged between the two preps. ``ext_u``: the
    horizon-coupled rows' upper bounds (``assemble_stagewise_ext``), one
    vector for every node (branching moves only binary boxes); None when
    ``sw.n_ext == 0``."""

    sw: StagewiseQP
    sw_probe: Optional[StagewiseQP] = None
    ext_u: Optional[torch.Tensor] = None
    parallel_sweeps: bool = False

    @property
    def n(self):
        return self.sw.N * self.sw.b

    @property
    def lb(self):
        return self.sw.lb_xi.reshape(-1)

    @property
    def ub(self):
        return self.sw.ub_xi.reshape(-1)

    @property
    def binary_idx(self):
        """Branching coordinates. Under move blocking a blocked binary input
        branches only at block-leader stages: the blocking rows force the
        tied stages inside every relaxation. Unblocked binaries branch at
        every stage."""
        sw = self.sw
        blocked = set(sw.blk_cols)
        g = sw.blk_groups
        out = []
        for k in range(sw.N):
            leader = not g or k == 0 or g[k] != g[k - 1]
            for i in sw.binary_idx_v:
                if int(i) in blocked and not leader:
                    continue
                out.append(k * sw.b + int(i))
        return tuple(out)

    @property
    def warm_size(self):
        # z and y each carry the n_ext extra-row tail after the stage rows:
        # the B&B loop treats warm vectors as opaque flats
        return self.sw.N * self.sw.m_k + self.sw.n_ext

    def _frame(self, f, h, lb, ub):
        sw = self.sw
        batch = f.shape[:-1]
        stage = batch + (sw.N, sw.b)
        return (batch, f.reshape(stage), h[..., 0, :, :], h[..., 1, :, :],
                lb.reshape(lb.shape[:-1] + (sw.N, sw.b)),
                ub.reshape(ub.shape[:-1] + (sw.N, sw.b)))

    def solve(self, f, h, lb, ub, iters, warm=None):
        sw = self.sw
        batch, q, l, u, lb_xi, ub_xi = self._frame(f, h, lb, ub)
        m_st = sw.N * sw.m_k
        warm_ext = None
        if warm is not None:
            xw, zw, yw = warm
            if sw.n_ext:
                warm_ext = (zw[..., m_st:], yw[..., m_st:])
            warm = (xw.reshape(batch + (sw.N, sw.b)),
                    zw[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
                    yw[..., :m_st].reshape(batch + (sw.N, sw.m_k)))
        res = stagewise_admm_solve(
            sw, q, l, u, iters=iters, lb_xi=lb_xi, ub_xi=ub_xi, warm=warm,
            parallel_sweeps=self.parallel_sweeps, ext_u=self.ext_u,
            warm_ext=warm_ext)
        z_flat = res.z.reshape(batch + (m_st,))
        y_flat = res.y.reshape(batch + (m_st,))
        if sw.n_ext:
            z_flat = torch.cat([z_flat, res.z_ext], dim=-1)
            y_flat = torch.cat([y_flat, res.y_ext], dim=-1)
        return dataclasses.replace(
            res, x=res.x.reshape(batch + (self.n,)), z=z_flat, y=y_flat,
            z_ext=None, y_ext=None)

    def solve_probe(self, f, h, lb, ub, iters, warm=None):
        if self.sw_probe is None:
            return self.solve(f, h, lb, ub, iters, warm=warm)
        return StagewiseBackend(
            self.sw_probe, ext_u=self.ext_u,
            parallel_sweeps=self.parallel_sweeps).solve(f, h, lb, ub, iters,
                                                        warm=warm)

    def node_bound(self, res, f, h, lb, ub):
        sw = self.sw
        batch, q, l, u, lb_xi, ub_xi = self._frame(f, h, lb, ub)
        l, u = _with_box(sw, l, u, lb_xi, ub_xi)
        m_st = sw.N * sw.m_k
        res = dataclasses.replace(
            res, x=res.x.reshape(batch + (sw.N, sw.b)),
            y=res.y[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
            z=res.z[..., :m_st].reshape(batch + (sw.N, sw.m_k)),
            y_ext=res.y[..., m_st:] if sw.n_ext else None,
            z_ext=res.z[..., m_st:] if sw.n_ext else None)
        return stagewise_dual_bound(sw, q, l, u, res, ext_u=self.ext_u)

    def broadcast_data(self, f, h, W):
        return f.expand((W,) + f.shape), h.expand((W,) + h.shape)


def pack_stagewise_data(q, l, u):
    """(q, l, u) from ``assemble_stagewise`` → flat (f, h) for the B&B
    backend: f = q flattened, h = stacked [l; u]."""
    return q.reshape(-1), torch.stack([l, u], dim=0)


def solve_miqp_bnb_stagewise(sw: StagewiseQP, q, l, u,
                             spec: BnbSpec = BnbSpec(),
                             init_incumbent=None,
                             sw_probe: Optional[StagewiseQP] = None,
                             parallel_sweeps: bool = False,
                             ext_u=None) -> BnbResult:
    """B&B over the stagewise frame on the device of ``q``. (q, l, u) from
    ``assemble_stagewise(sw, x0, W, prices)``. Returns a BnbResult whose
    ``x`` is the flat ξ (reshape to (N, b); v_k = ξ_k[:nv]).
    ``sw_probe``: stiff-ρ prep for the dive probes. ``parallel_sweeps``:
    the log-depth sweeps (ops/stagewise._solve_K_assoc). ``ext_u``: the
    extra rows' bounds (``assemble_stagewise_ext``), required when
    ``sw.n_ext > 0``."""
    f, h = pack_stagewise_data(q, l, u)
    return _bnb_loop(StagewiseBackend(sw, sw_probe, ext_u=ext_u,
                                      parallel_sweeps=parallel_sweeps),
                     f, h, spec, init_incumbent=init_incumbent)
