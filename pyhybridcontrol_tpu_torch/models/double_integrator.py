"""Switched double-integrator MLD — benchmark config 1.

Counterpart of ``pyhybridcontrol_tpu/models/double_integrator.py``: a
double integrator with a binary "gear" δ that switches the input gain
between g_lo and g_hi, with the gear–thrust product z = δ·u in big-M form:

    x⁺ = A x + B·g_lo·u + B·(g_hi − g_lo)·z
    A = [[1, Ts], [0, 1]],  B = [Ts²/2, Ts]
    z ≤ u_max δ;  z ≥ −u_max δ;  z ≤ u + u_max(1−δ);  z ≥ u − u_max(1−δ)
    |u| ≤ u_max,  |x| box.

nx=2, nu=1, nδ=1, nz=1 — at N=10 the MIQP has 2^10 binary sequences.
"""

from __future__ import annotations

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights


def switched_double_integrator(Ts: float = 0.5, u_max: float = 1.0,
                               g_lo: float = 0.5, g_hi: float = 2.0,
                               x_box: float = 10.0) -> MldModel:
    A = np.array([[1.0, Ts], [0.0, 1.0]])
    B = np.array([[0.5 * Ts * Ts], [Ts]])
    M = u_max

    # rows: E x + F1 u + F2 δ + F3 z ≤ f5
    E, F1, F2, F3, f5 = [], [], [], [], []

    def row(e=(0.0, 0.0), f1=0.0, f2=0.0, f3=0.0, rhs=0.0):
        E.append(list(e))
        F1.append([f1])
        F2.append([f2])
        F3.append([f3])
        f5.append(rhs)

    row(f1=1.0, rhs=u_max)              # u ≤ u_max
    row(f1=-1.0, rhs=u_max)             # −u ≤ u_max
    row(f2=-M, f3=1.0)                  # z ≤ M δ
    row(f2=-M, f3=-1.0)                 # −z ≤ M δ
    row(f1=-1.0, f2=M, f3=1.0, rhs=M)   # z − u ≤ M(1−δ)
    row(f1=1.0, f2=M, f3=-1.0, rhs=M)   # u − z ≤ M(1−δ)
    for j in range(2):                  # state box (keeps the MIQP bounded)
        e = [0.0, 0.0]
        e[j] = 1.0
        row(e=e, rhs=x_box)
        row(e=[-v for v in e], rhs=x_box)

    info = MldInfo(nx=2, nu=1, ndelta=1, nz=1, nomega=0, ny=2,
                   ncons=len(f5))
    return MldModel.from_matrices(
        info,
        A=A, B1=B * g_lo, B3=B * (g_hi - g_lo), C=np.eye(2),
        E=np.array(E), F1=np.array(F1), F2=np.array(F2), F3=np.array(F3),
        f5=np.array(f5),
    )


def default_weights(q_gear: float = 0.05) -> MpcWeights:
    """Regulation cost: drive x → 0, small input effort, linear gear cost."""
    return MpcWeights(
        Qx=np.array([1.0, 0.1]),
        QxN=np.array([5.0, 0.5]),
        Ru=np.array([0.1]),
        qdelta=np.array([q_gear]),
    )
