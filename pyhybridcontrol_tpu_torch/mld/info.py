"""MldInfo: static bookkeeping of an MLD system signature.

Functional replica of the reference's ``MldInfo`` (SURVEY.md §2a): dims
(nx, nu, ndelta, nz, nomega, ncons) plus the continuous/binary partition
of states and inputs. Counterpart of ``pyhybridcontrol_tpu/mld/info.py``:
pure Python/numpy metadata, hashable and frozen.

MLD form (Bemporad & Morari 1999, SURVEY.md §2a [LIT]):

    x(k+1) = A x(k) + B1 u(k) + B2 δ(k) + B3 z(k) + B4 ω(k) + b5
    y(k)   = C x(k) + D1 u(k) + D2 δ(k) + D3 z(k) + D4 ω(k) + d5
    E x(k) + F1 u(k) + F2 δ(k) + F3 z(k) + F4 ω(k) ≤ f5
    x ∈ ℝ^nxc × {0,1}^nxb,  u ∈ ℝ^nuc × {0,1}^nub,
    δ ∈ {0,1}^ndelta,  z ∈ ℝ^nz,  ω ∈ ℝ^nomega.

The per-step decision vector is v = [u; δ; z] (dim nv); its binary mask
``v_binary_mask`` drives the MIQP engine's branching variables.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


class VarTypes:
    CONTINUOUS = "c"
    BINARY = "b"


@dataclasses.dataclass(frozen=True)
class MldInfo:
    nx: int = 0
    nu: int = 0
    ndelta: int = 0
    nz: int = 0
    nomega: int = 0
    ny: int = 0
    ncons: int = 0
    # var-type partitions: tuples of 'c'/'b' chars, length nx / nu
    x_types: Tuple[str, ...] = ()
    u_types: Tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(
            self, "x_types",
            tuple(self.x_types) if self.x_types else ("c",) * self.nx)
        object.__setattr__(
            self, "u_types",
            tuple(self.u_types) if self.u_types else ("c",) * self.nu)
        if len(self.x_types) != self.nx:
            raise ValueError(f"x_types length {len(self.x_types)} != nx {self.nx}")
        if len(self.u_types) != self.nu:
            raise ValueError(f"u_types length {len(self.u_types)} != nu {self.nu}")
        for t in self.x_types + self.u_types:
            if t not in (VarTypes.CONTINUOUS, VarTypes.BINARY):
                raise ValueError(f"invalid var type {t!r}")

    # ---- derived dims ----
    @property
    def nxc(self) -> int:
        return self.x_types.count(VarTypes.CONTINUOUS)

    @property
    def nxb(self) -> int:
        return self.x_types.count(VarTypes.BINARY)

    @property
    def nuc(self) -> int:
        return self.u_types.count(VarTypes.CONTINUOUS)

    @property
    def nub(self) -> int:
        return self.u_types.count(VarTypes.BINARY)

    @property
    def nv(self) -> int:
        """Per-step decision vector dim: v = [u; δ; z]."""
        return self.nu + self.ndelta + self.nz

    @property
    def nv_binary(self) -> int:
        return self.nub + self.ndelta

    # ---- masks / slices over v = [u; δ; z] ----
    @property
    def v_binary_mask(self) -> np.ndarray:
        """Boolean (nv,) mask of binary entries of v (static numpy array)."""
        m = np.zeros(self.nv, dtype=bool)
        for i, t in enumerate(self.u_types):
            if t == VarTypes.BINARY:
                m[i] = True
        m[self.nu : self.nu + self.ndelta] = True
        return m

    @property
    def u_slice(self):
        return slice(0, self.nu)

    @property
    def delta_slice(self):
        return slice(self.nu, self.nu + self.ndelta)

    @property
    def z_slice(self):
        return slice(self.nu + self.ndelta, self.nv)

    def split_v(self, v):
        """Split per-step decision v (..., nv) into (u, δ, z)."""
        return (
            v[..., self.u_slice],
            v[..., self.delta_slice],
            v[..., self.z_slice],
        )

    def validate_shapes(self, mats) -> None:
        """Check that a StructDict of MLD matrices is mutually consistent
        (the reference's MldModel validation role, SURVEY.md §3.1)."""
        expect = {
            "A": (self.nx, self.nx), "B1": (self.nx, self.nu),
            "B2": (self.nx, self.ndelta), "B3": (self.nx, self.nz),
            "B4": (self.nx, self.nomega), "b5": (self.nx, 1),
            "C": (self.ny, self.nx), "D1": (self.ny, self.nu),
            "D2": (self.ny, self.ndelta), "D3": (self.ny, self.nz),
            "D4": (self.ny, self.nomega), "d5": (self.ny, 1),
            "E": (self.ncons, self.nx), "F1": (self.ncons, self.nu),
            "F2": (self.ncons, self.ndelta), "F3": (self.ncons, self.nz),
            "F4": (self.ncons, self.nomega), "f5": (self.ncons, 1),
        }
        for name, shape in expect.items():
            got = tuple(mats[name].shape)
            if got != shape:
                raise ValueError(
                    f"MLD matrix {name} has shape {got}, expected {shape} "
                    f"for {self}"
                )
