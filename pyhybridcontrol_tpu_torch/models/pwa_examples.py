"""PWA benchmark model — benchmark config 2: piecewise-affine dynamics
converted to MLD (mld/pwa.py, big-M or hull) with an on/off actuator.

Counterpart of ``pyhybridcontrol_tpu/models/pwa_examples.py`` (the same
float64 numpy code).

Plant: mass–spring–damper whose spring stiffens when compressed
(x1 < 0) — the classic 2-region PWA benchmark — driven by a continuous
force u1 gated by a binary on/off actuator u2 ∈ {0,1}. The gating
product w = u2·u1 is encoded with the standard big-M rows on top of the
converted PWA MLD (one extra continuous auxiliary z_g).
"""

from __future__ import annotations

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.mld.pwa import PwaRegion, PwaSystem, pwa_to_mld
from pyhybridcontrol_tpu_torch.ops.condense import MpcWeights


def pwa_spring_system(Ts: float = 0.1, k_soft: float = 1.0,
                      k_stiff: float = 4.0, c_damp: float = 0.4,
                      u_max: float = 2.0) -> PwaSystem:
    """2-region PWA (no actuator gating): x = [pos, vel], u = [force]."""

    def region(k):
        A = np.array([[1.0, Ts], [-k * Ts, 1.0 - c_damp * Ts]])
        B = np.array([[0.0], [Ts]])
        c = np.zeros(2)
        return A, B, c

    A1, B1, c1 = region(k_soft)
    A2, B2, c2 = region(k_stiff)
    r1 = PwaRegion(A=A1, B=B1, c=c1, S=np.array([[-1.0, 0.0]]),
                   R=np.zeros((1, 1)), T=np.array([0.0]))      # x1 ≥ 0
    r2 = PwaRegion(A=A2, B=B2, c=c2, S=np.array([[1.0, 0.0]]),
                   R=np.zeros((1, 1)), T=np.array([0.0]))      # x1 ≤ 0
    return PwaSystem(regions=[r1, r2],
                     x_lb=np.array([-5.0, -5.0]), x_ub=np.array([5.0, 5.0]),
                     u_lb=np.array([-u_max]), u_ub=np.array([u_max]))


def pwa_spring_mld(Ts: float = 0.1, u_max: float = 2.0,
                   on_off: bool = True,
                   formulation: str = "bigm") -> MldModel:
    """Config-2 model: PWA→MLD + optional on/off actuator gating.

    With gating: u = [u_force (cont), u_on (bin)], effective force
    w = u_on·u_force enters the PWA dynamics; encoded via auxiliary z_g
    with big-M = u_max.

    ``formulation`` passes through to ``pwa_to_mld`` — "hull" gives the
    locally-ideal disaggregated encoding (the gating wrapper composes
    unchanged: it transplants ALL u-dependence, which for the hull
    lives in the u-aggregation and u-box rows, onto z_g).
    """
    sys = pwa_spring_system(Ts=Ts, u_max=u_max)
    base = pwa_to_mld(sys, formulation=formulation)
    if not on_off:
        return base
    m = base.numpy_mats()
    info = base.info
    nx, nz = info.nx, info.nz

    # new layout: u = [u_force, u_on], z = [z_pwa(4), z_g]
    # dynamics/guards previously used u (force) — now use z_g instead.
    nu2 = 2
    nz2 = nz + 1
    nd = info.ndelta

    def widen_u(M1):     # (r,1) → (r,2): old u col becomes 0 (replaced)
        return np.hstack([np.zeros_like(M1), np.zeros((M1.shape[0], 1))])

    def widen_z(M3, u_col):
        # old u-dependence moves onto the z_g column
        return np.hstack([M3, u_col])

    B1 = widen_u(m.B1)
    B3 = widen_z(m.B3, m.B1)
    D1 = widen_u(m.D1)
    D3 = widen_z(m.D3, m.D1)
    F1 = widen_u(m.F1)
    F3 = widen_z(m.F3, m.F1)
    f5 = m.f5[:, 0]
    E = m.E
    F2 = m.F2

    # gating rows: z_g = u_on·u_force, |u_force| ≤ u_max
    Mg = float(np.max(np.abs([sys.u_lb[0], sys.u_ub[0]])))
    rows = []

    def add(e=None, f1=(0.0, 0.0), f2=None, f3=None, rhs=0.0):
        rows.append((np.zeros(nx) if e is None else np.asarray(e),
                     np.asarray(f1),
                     np.zeros(nd) if f2 is None else np.asarray(f2),
                     np.zeros(nz2) if f3 is None else np.asarray(f3),
                     rhs))

    zg = np.zeros(nz2); zg[-1] = 1.0
    # u_on is a binary INPUT (not δ) → gating big-M rows use F1's u_on col:
    #   z_g ≤ Mg·u_on;  −z_g ≤ Mg·u_on;
    #   z_g − u_force ≤ Mg(1−u_on);  u_force − z_g ≤ Mg(1−u_on)
    add(f1=(0.0, -Mg), f3=zg, rhs=0.0)
    add(f1=(0.0, -Mg), f3=-zg, rhs=0.0)
    add(f1=(-1.0, Mg), f3=zg, rhs=Mg)
    add(f1=(1.0, Mg), f3=-zg, rhs=Mg)
    # keep the box on u_force itself (the converter's u-box rows now
    # bound z_g — big-M validity above needs |u_force| ≤ Mg explicitly)
    add(f1=(1.0, 0.0), rhs=Mg)
    add(f1=(-1.0, 0.0), rhs=Mg)

    E2 = np.vstack([E] + [r[0][None] for r in rows])
    F12 = np.vstack([F1] + [r[1][None] for r in rows])
    F22 = np.vstack([F2] + [r[2][None] for r in rows])
    F32 = np.vstack([F3] + [r[3][None] for r in rows])
    f52 = np.concatenate([f5, [r[4] for r in rows]])

    info2 = MldInfo(nx=nx, nu=nu2, ndelta=nd, nz=nz2, nomega=0, ny=nx,
                    ncons=E2.shape[0], u_types=("c", "b"))
    return MldModel.from_matrices(
        info2, A=m.A, B1=B1, B2=m.B2, B3=B3, C=m.C, D1=D1, D2=m.D2, D3=D3,
        E=E2, F1=F12, F2=F22, F3=F32, f5=f52)


def pwa_weights() -> MpcWeights:
    return MpcWeights(
        Qx=np.array([4.0, 0.4]),
        QxN=np.array([8.0, 0.8]),
        Ru=np.array([0.1, 0.0]),
        ru=np.array([0.0, 0.05]),   # linear cost on running the actuator
    )
