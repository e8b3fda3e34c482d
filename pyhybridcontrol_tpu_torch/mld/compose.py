"""Multi-agent MLD aggregation (SURVEY.md §3.5): stack N agent models
into one joint MLD with optional per-step coupling rows (e.g. the
micro-grid aggregate power limit  Σ_i P_i u_i ≤ P_max).

Joint variable order: x = [x_1; …; x_M], u = [u_1; …], δ = [δ_1; …],
z = [z_1; …], ω = [ω_1; …] — all matrices block-diagonal, constraint rows
stacked, coupling rows appended. The joint model is an ordinary MldModel:
condensation, the MIQP engines, and the closed loop apply unchanged
(centralized solve); decomposed solves use the per-agent models.

Counterpart of ``pyhybridcontrol_tpu/mld/compose.py``: host numpy, the
same matrices.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.utils.matrix_utils import block_diag


def aggregate_mld(models: Sequence[MldModel],
                  coupling_F1: Optional[np.ndarray] = None,
                  coupling_F2: Optional[np.ndarray] = None,
                  coupling_F3: Optional[np.ndarray] = None,
                  coupling_E: Optional[np.ndarray] = None,
                  coupling_f5: Optional[np.ndarray] = None) -> MldModel:
    """Block-diagonal aggregation + optional coupling constraint rows.

    Coupling matrices are given over the JOINT variable vectors
    (columns = Σ_i nu_i etc.); rows are per-step constraints.
    """
    mats = [m.numpy_mats() for m in models]
    infos = [m.info for m in models]

    def bd(name):
        return block_diag([mm[name] for mm in mats])

    def vstack_col(name):
        return np.vstack([mm[name] for mm in mats])

    A = bd("A"); B1 = bd("B1"); B2 = bd("B2"); B3 = bd("B3"); B4 = bd("B4")
    b5 = vstack_col("b5")
    C = bd("C"); D1 = bd("D1"); D2 = bd("D2"); D3 = bd("D3"); D4 = bd("D4")
    d5 = vstack_col("d5")
    E = bd("E"); F1 = bd("F1"); F2 = bd("F2"); F3 = bd("F3"); F4 = bd("F4")
    f5 = vstack_col("f5")

    ncpl = 0
    if coupling_f5 is not None:
        cf5 = np.atleast_1d(np.asarray(coupling_f5, np.float64))
        ncpl = len(cf5)
        nu = sum(i.nu for i in infos)
        nd = sum(i.ndelta for i in infos)
        nz = sum(i.nz for i in infos)
        nx = sum(i.nx for i in infos)
        nw = sum(i.nomega for i in infos)

        def cpl(mat, ncols):
            if mat is None:
                return np.zeros((ncpl, ncols))
            m = np.atleast_2d(np.asarray(mat, np.float64))
            if m.shape != (ncpl, ncols):
                raise ValueError(
                    f"coupling matrix shape {m.shape} != {(ncpl, ncols)}")
            return m

        E = np.vstack([E, cpl(coupling_E, nx)])
        F1 = np.vstack([F1, cpl(coupling_F1, nu)])
        F2 = np.vstack([F2, cpl(coupling_F2, nd)])
        F3 = np.vstack([F3, cpl(coupling_F3, nz)])
        F4 = np.vstack([F4, np.zeros((ncpl, nw))])
        f5 = np.vstack([f5, cf5[:, None]])

    info = MldInfo(
        nx=sum(i.nx for i in infos), nu=sum(i.nu for i in infos),
        ndelta=sum(i.ndelta for i in infos), nz=sum(i.nz for i in infos),
        nomega=sum(i.nomega for i in infos), ny=sum(i.ny for i in infos),
        ncons=E.shape[0],
        x_types=sum((i.x_types for i in infos), ()),
        u_types=sum((i.u_types for i in infos), ()),
    )
    return MldModel.from_matrices(
        info, A=A, B1=B1, B2=B2, B3=B3, B4=B4, b5=b5,
        C=C, D1=D1, D2=D2, D3=D3, D4=D4, d5=d5,
        E=E, F1=F1, F2=F2, F3=F3, F4=F4, f5=f5)


def joint_v_layout(infos: Sequence[MldInfo]):
    """Index maps from per-agent (u, δ, z) into the joint per-step v.

    Returns a list of dicts with 'u', 'delta', 'z' index arrays per agent.
    """
    nu = sum(i.nu for i in infos)
    nd = sum(i.ndelta for i in infos)
    out = []
    ou = od = oz = 0
    for i in infos:
        out.append(dict(
            u=np.arange(ou, ou + i.nu),
            delta=np.arange(nu + od, nu + od + i.ndelta),
            z=np.arange(nu + nd + oz, nu + nd + oz + i.nz),
        ))
        ou += i.nu
        od += i.ndelta
        oz += i.nz
    return out
