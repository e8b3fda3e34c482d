"""MldModel: container + validator + dynamics of an MLD system.

Counterpart of ``pyhybridcontrol_tpu/mld/model.py``. The 18
Bemporad–Morari matrices are kept as fp32 torch tensors (the reference
keeps fp32 device arrays), and ``numpy_mats`` returns their float64 host
copies for condensation — so both packages condense bit-identical data.
``lsim`` is a Python loop over torch tensors where the reference scans.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.utils.matrix_utils import atleast_2d_col
from pyhybridcontrol_tpu_torch.utils.structdict import StructDict

MATRIX_NAMES = (
    "A", "B1", "B2", "B3", "B4", "b5",
    "C", "D1", "D2", "D3", "D4", "d5",
    "E", "F1", "F2", "F3", "F4", "f5",
)

_SHAPES = {
    "A": ("nx", "nx"), "B1": ("nx", "nu"), "B2": ("nx", "ndelta"),
    "B3": ("nx", "nz"), "B4": ("nx", "nomega"), "b5": ("nx", 1),
    "C": ("ny", "nx"), "D1": ("ny", "nu"), "D2": ("ny", "ndelta"),
    "D3": ("ny", "nz"), "D4": ("ny", "nomega"), "d5": ("ny", 1),
    "E": ("ncons", "nx"), "F1": ("ncons", "nu"), "F2": ("ncons", "ndelta"),
    "F3": ("ncons", "nz"), "F4": ("ncons", "nomega"), "f5": ("ncons", 1),
}


@dataclasses.dataclass
class MldModel:
    """MLD system: ``mats`` holds the 18 matrices, ``info`` the signature."""

    mats: StructDict
    info: MldInfo

    @classmethod
    def from_matrices(cls, info: Optional[MldInfo] = None, *,
                      validate: bool = True, **mats) -> "MldModel":
        """Build from any subset of the 18 MLD matrices; missing ones are
        zeros. If ``info`` is None it is inferred from the given shapes."""
        np_mats = {k: atleast_2d_col(np.asarray(v, dtype=np.float64))
                   for k, v in mats.items() if v is not None}
        if info is None:
            info = _infer_info(np_mats)
        dims = {"nx": info.nx, "nu": info.nu, "ndelta": info.ndelta,
                "nz": info.nz, "nomega": info.nomega, "ny": info.ny,
                "ncons": info.ncons, 1: 1}
        full = StructDict()
        for name in MATRIX_NAMES:
            r, c = _SHAPES[name]
            shape = (dims[r], dims[c])
            if name in np_mats:
                m = np_mats[name]
                if m.shape != shape:
                    raise ValueError(
                        f"MLD matrix {name}: shape {m.shape} != {shape}")
                full[name] = m
            else:
                full[name] = np.zeros(shape, dtype=np.float64)
        if validate:
            info.validate_shapes(full)
        full = StructDict({k: torch.as_tensor(v, dtype=torch.float32)
                           for k, v in full.items()})
        return cls(mats=full, info=info)

    def to(self, device) -> "MldModel":
        """The same model with its matrices on ``device`` (itself where
        they already are)."""
        device = torch.device(device)
        if self.mats.A.device == device:
            return self
        return MldModel(mats=StructDict({k: v.to(device)
                                         for k, v in self.mats.items()}),
                        info=self.info)

    def numpy_mats(self) -> StructDict:
        """Host float64 copy of the matrix bundle (condensation input)."""
        return StructDict({k: v.detach().cpu().numpy().astype(np.float64)
                           for k, v in self.mats.items()})

    # -- dynamics ----------------------------------------------------------
    def step(self, x, u=None, delta=None, z=None, omega=None):
        """x⁺ = A x + B1 u + B2 δ + B3 z + B4 ω + b5 (leading batch dims
        broadcast; None inputs count as zero)."""
        m = self.mats
        xp = x @ m.A.T + m.b5[:, 0]
        for mat, val in ((m.B1, u), (m.B2, delta), (m.B3, z), (m.B4, omega)):
            if val is not None and mat.shape[1] > 0:
                xp = xp + val @ mat.T
        return xp

    def output(self, x, u=None, delta=None, z=None, omega=None):
        """y = C x + D1 u + D2 δ + D3 z + D4 ω + d5."""
        m = self.mats
        y = x @ m.C.T + m.d5[:, 0]
        for mat, val in ((m.D1, u), (m.D2, delta), (m.D3, z), (m.D4, omega)):
            if val is not None and mat.shape[1] > 0:
                y = y + val @ mat.T
        return y

    def step_v(self, x, v, omega=None):
        """One step driven by the stacked decision v = [u; δ; z]."""
        u, delta, z = self.info.split_v(v)
        return self.step(x, u, delta, z, omega)

    def lsim(self, x0, v_seq, omega_seq=None):
        """Simulate T steps under a decision sequence. v_seq: (T, nv);
        omega_seq: (T, nomega) or None. Returns (x_seq (T+1, nx),
        y_seq (T, ny))."""
        T = v_seq.shape[0]
        if omega_seq is None:
            omega_seq = v_seq.new_zeros((T, self.info.nomega))
        xs, ys = [x0], []
        x = x0
        for k in range(T):
            u, d, z = self.info.split_v(v_seq[k])
            ys.append(self.output(x, u, d, z, omega_seq[k]))
            x = self.step(x, u, d, z, omega_seq[k])
            xs.append(x)
        return torch.stack(xs), torch.stack(ys)


def _infer_info(np_mats) -> MldInfo:
    def dim(names, axis, default=0):
        for n in names:
            if n in np_mats:
                return np_mats[n].shape[axis]
        return default

    return MldInfo(
        nx=dim(("A", "B1", "B2", "B3", "B4", "b5"), 0),
        nu=dim(("B1", "D1", "F1"), 1),
        ndelta=dim(("B2", "D2", "F2"), 1),
        nz=dim(("B3", "D3", "F3"), 1),
        nomega=dim(("B4", "D4", "F4"), 1),
        ny=dim(("C", "D1", "D2", "D3", "D4", "d5"), 0),
        ncons=dim(("E", "F1", "F2", "F3", "F4", "f5"), 0))
