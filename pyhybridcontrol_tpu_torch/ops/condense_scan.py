"""Device-side condensation and horizon-parallel operators.

Counterpart of ``pyhybridcontrol_tpu/ops/condense_scan.py``. The horizon
is the framework's sequence axis; the tools:

  * ``matrix_power_scan`` — the power table [I, A, …, A^N] in log depth;
  * ``affine_scan_rollout`` — the state response as a log-depth scan over
    the per-step affine maps (x⁺ = A x + b_k);
  * ``condense_device`` — the prediction operators (Φ, Γv, Γω, Γc in the
    x̃ and x frames) as batched torch ops on the model's device. Unlike
    the host fp64 build (ops/condense.py, the accuracy path) it takes
    model matrices with a leading batch axis, so per-instance model
    variations (parameter sweeps) condense in one call;
  * ``condense_horizon_sharded`` — the block rows of Φ and Γv over a mesh
    axis: rank d builds the rows of steps [d·N/P, (d+1)·N/P) from the
    replicated power table (the O(N²) blocks are what it splits).

Port decisions:
- The reference scans with ``lax.associative_scan``; torch has none, so
  the scans here are the doubling (Hillis–Steele) scan written out: after
  round r every element holds the composition of its 2^r predecessors,
  one batched ``torch.matmul`` a round, ⌈log₂ N⌉ rounds.
- The reference vmaps ``condense_device`` over stacked model leaves; here
  the matrices of ``model.mats`` may carry a leading batch axis (an
  ``MldModel`` whose matrices are ``torch.stack``-ed over instances).
- These are plain XLA in the reference (no Pallas), so plain torch
  matmuls are the port; TF32 stays off (ops/admm.py).

Math: Γv[k, j] = A^{k−j} Bv (j ≤ k) for X = [x_1…x_N]; the x̃ frame shifts
by one. The block-Toeplitz operators gather the power table at index
(k − j), one batched gather and matmul, no loop over the N² blocks.
"""

from __future__ import annotations

import torch

from pyhybridcontrol_tpu_torch.mld.model import MldModel


def _scan_matrices(M):
    """Prefix products along dim −3: out[k] = M[k] ⋯ M[0] (later maps on
    the left), by doubling."""
    N, d = M.shape[-3], 1
    while d < N:
        M = torch.cat([M[..., :d, :, :],
                       M[..., d:, :, :] @ M[..., :-d, :, :]], dim=-3)
        d *= 2
    return M


def matrix_power_scan(A: torch.Tensor, N: int) -> torch.Tensor:
    """(…, N+1, nx, nx) power table [I, A, …, A^N] in log depth (leading
    batch dims of A carry through)."""
    nx = A.shape[-1]
    eye = torch.eye(nx, dtype=A.dtype, device=A.device).expand(
        A.shape[:-2] + (1, nx, nx))
    As = A.unsqueeze(-3).expand(A.shape[:-2] + (N, nx, nx))
    return torch.cat([eye, _scan_matrices(As)], dim=-3)


def affine_scan_rollout(model: MldModel, x0, v_seq, omega_seq=None):
    """All states x_1..x_N in log depth: a scan over the affine maps,
    (M, c) ∘ (M', c') = (M M', M c' + c). The same trajectory as
    ``MldModel.lsim``, parallel in time — for long-horizon simulation of
    known decision sequences. ``v_seq`` (…, N, nv), ``x0`` (…, nx):
    leading batch dims broadcast. Returns (…, N, nx)."""
    info, m = model.info, model.mats
    N = v_seq.shape[-2]
    Bv = torch.cat([m.B1, m.B2, m.B3], dim=1)
    c = v_seq @ Bv.T + m.b5[:, 0]
    if omega_seq is not None and info.nomega:
        c = c + omega_seq @ m.B4.T
    M = m.A.expand((N,) + m.A.shape)
    d = 1
    while d < N:
        # new[i] = old[i] ∘ old[i−d]; both parts read the old M
        M, c = (torch.cat([M[:d], M[d:] @ M[:-d]]),
                torch.cat([c[..., :d, :],
                           torch.einsum("kij,...kj->...ki", M[d:],
                                        c[..., :-d, :]) + c[..., d:, :]],
                          dim=-2))
        d *= 2
    return torch.einsum("kij,...j->...ki", M, x0) + c


def condense_device(model: MldModel, N: int) -> dict:
    """Prediction operators on the model's device: a dict with Phi
    (…, N·nx, nx), Gv (…, N·nx, N·nv), Gw, Gc and the x̃-frame twins
    (suffix _t). The matrices of ``model.mats`` may carry one leading
    batch axis (instances condensed in one call)."""
    info, m = model.info, model.mats
    nx = info.nx
    A = m.A
    batch = A.shape[:-2]
    dev = A.device
    Bv = torch.cat([m.B1, m.B2, m.B3], dim=-1)
    pw = matrix_power_scan(A, N)                   # (…, N+1, nx, nx)

    Phi = pw[..., 1:N + 1, :, :].reshape(batch + (N * nx, nx))
    Phi_t = pw[..., 0:N, :, :].reshape(batch + (N * nx, nx))

    k = torch.arange(N, device=dev)[:, None]
    j = torch.arange(N, device=dev)[None, :]
    d = k - j                                      # power index of (k, j)

    def toeplitz(offset, B):
        # block (k, j) = A^{k−j+offset} B where k − j + offset ≥ 0
        mk = (d + offset >= 0) & (d >= (0 if offset == 0 else 1))
        dd = torch.clamp(d + offset, 0, N)
        blocks = pw[..., dd, :, :] @ B.unsqueeze(-3).unsqueeze(-3)
        blocks = torch.where(mk[:, :, None, None], blocks, 0.0)
        return blocks.transpose(-3, -2).reshape(
            batch + (N * nx, N * B.shape[-1]))

    Gv = toeplitz(0, Bv)                           # A^{k−j} Bv, j ≤ k
    Gw = toeplitz(0, m.B4)
    Gv_t = toeplitz(-1, Bv)                        # A^{k−1−j} Bv, j < k
    Gw_t = toeplitz(-1, m.B4)

    b5 = m.b5[..., :, 0]

    def offsets(mask, dd):
        # Σ_j A^{dd(k,j)} b5 over the blocks the mask keeps
        contrib = (pw[..., dd, :, :] @ b5[..., None, None, :, None])[..., 0]
        contrib = torch.where(mask[:, :, None], contrib, 0.0)
        return contrib.sum(dim=-2).reshape(batch + (N * nx,))

    Gc = offsets(d >= 0, torch.clamp(d, min=0))    # Σ_{i≤k} A^{k−i} b5
    Gc_t = offsets(d >= 1, torch.clamp(d - 1, min=0))   # Σ_{i<k} A^{k−1−i}

    return dict(Phi=Phi, Gv=Gv, Gw=Gw, Gc=Gc,
                Phi_t=Phi_t, Gv_t=Gv_t, Gw_t=Gw_t, Gc_t=Gc_t)


def condense_horizon_sharded(model: MldModel, N: int, mesh, axis: str = "hz"):
    """Γ operators with block rows sharded over ``mesh[axis]``: this rank
    builds the rows of steps [d·N/P, (d+1)·N/P) and returns its local rows
    ``(Phi (N/P·nx, nx), Gv (N/P·nx, N·nv))`` of ``condense_device``'s
    Phi and Gv, as the reference's ``shard_body`` does. Every rank builds
    the (N+1)-entry power table; no collective runs. Raises unless P
    divides N."""
    from pyhybridcontrol_tpu_torch.parallel.mesh import AxisComm

    comm = AxisComm(mesh, axis)
    P, d = comm.size, comm.rank
    if N % P:
        raise ValueError(f"N={N} must divide by mesh axis {P}")
    info, m = model.info, model.mats
    nx, Nl = info.nx, N // P
    Bv = torch.cat([m.B1, m.B2, m.B3], dim=-1)
    pw = matrix_power_scan(m.A, N)                 # (N+1, nx, nx)
    k = d * Nl + torch.arange(Nl, device=pw.device)[:, None]   # global steps
    j = torch.arange(N, device=pw.device)[None, :]
    dd = k - j
    mask = dd >= 0
    blocks = pw[torch.clamp(dd, min=0)] @ Bv
    blocks = torch.where(mask[:, :, None, None], blocks, 0.0)
    Gv_rows = blocks.transpose(1, 2).reshape(Nl * nx, N * Bv.shape[-1])
    Phi_rows = pw[1 + d * Nl:1 + (d + 1) * Nl].reshape(Nl * nx, nx)
    return Phi_rows, Gv_rows
