"""Carry the reference's prepared state across into the port.

The JAX package prepares the same data this package prepares (the
condensed ``DeviceQP``, the Ruiz-scaled ``BoxQP`` and the kernel prep of
``prepare_pallas``). These functions turn such objects — read only
through ``numpy.asarray`` of their fields, so this module never imports
JAX — into the port's objects on a torch device, and ``to_numpy`` turns
the port's objects back into numpy, so tests can feed both packages
identical matrices and compare their outputs field by field.
``bnb_spec`` carries a reference ``BnbSpec`` across (every field), and
``to_numpy`` also takes a ``BnbResult`` or a ``PooledState`` of either
package. ``mld_model`` carries a reference ``MldModel`` across, and
``condensed`` a reference ``CondensedMpc`` as it stands after its
transforms, so both packages can be fed one frame; ``scenario_tree`` a
reference ``ScenarioTree``, so both packages can build their tree frames
from one tree. ``stagewise_qp`` and ``stagewise_tree_qp`` carry a
reference stagewise prep (``StagewiseQP``, ``StagewiseTreeQP``) across, so
the port's device half can be held against the reference on identical
data, apart from the port's own host build.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.ops.admm import BoxQP
from pyhybridcontrol_tpu_torch.ops.condense import (
    CondensedMpc,
    DeviceQP,
    MpcWeights,
)
from pyhybridcontrol_tpu_torch.ops.cuda_admm import KernelQP
from pyhybridcontrol_tpu_torch.ops.scenario_tree import ScenarioTree
from pyhybridcontrol_tpu_torch.ops.stagewise import StagewiseQP
from pyhybridcontrol_tpu_torch.ops.stagewise_tree import StagewiseTreeQP
from pyhybridcontrol_tpu_torch.solver.bnb import BnbResult, BnbSpec
from pyhybridcontrol_tpu_torch.solver.bnb_pooled import PooledState
from pyhybridcontrol_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device

BOXQP_ARRAYS = ("P", "A", "Kinv", "D", "E", "cost_scale", "rho_vec")
DEVICEQP_ARRAYS = ("H", "f0", "Fx", "Fw", "Fup", "G", "h0", "Hx", "Hw",
                   "lb", "ub", "T_full")
CONDENSED_ARRAYS = ("H", "f0", "Fx", "Fw", "Fup", "G", "h0", "Hx", "Hw",
                    "lb", "ub", "binary_mask", "T_full", "z_rows")
KERNELQP_ARRAYS = ("AGT", "M", "P", "dbox", "dbox_inv", "rhoG", "rhoG_inv",
                   "rhoB", "rhoB_inv", "EG_inv", "EB_inv", "Dc_inv")


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def box_qp(ref, device=DEFAULT_DEVICE) -> BoxQP:
    """A reference ``BoxQP`` (or anything with its fields) → port BoxQP."""
    device = resolve_device(device)
    return BoxQP(**{k: _t(getattr(ref, k), device) for k in BOXQP_ARRAYS},
                 rho=float(ref.rho), sigma=float(ref.sigma),
                 alpha=float(ref.alpha), m_ineq=int(ref.m_ineq))


def mld_info(ref) -> MldInfo:
    return MldInfo(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(MldInfo)})


def mld_model(ref) -> MldModel:
    """A reference ``MldModel`` → port MldModel (the same 18 matrices)."""
    return MldModel.from_matrices(
        mld_info(ref.info),
        **{k: np.asarray(v, np.float64) for k, v in ref.mats.items()})


def condensed(ref) -> CondensedMpc:
    """A reference ``CondensedMpc``, transforms applied → port
    CondensedMpc with the same float64 arrays (nothing is recomputed)."""
    c = CondensedMpc.__new__(CondensedMpc)
    c.model = mld_model(ref.model)
    c.info = mld_info(ref.info)
    c.N = int(ref.N)
    c.weights = MpcWeights(**{
        f.name: (None if getattr(ref.weights, f.name) is None
                 else np.asarray(getattr(ref.weights, f.name)))
        for f in dataclasses.fields(MpcWeights)})
    for k in CONDENSED_ARRAYS:
        setattr(c, k, np.array(getattr(ref, k)))
    c.n_soft = int(ref.n_soft)
    c.n_state_aux = int(ref.n_state_aux)
    return c


def scenario_tree(ref) -> ScenarioTree:
    """A reference ``ScenarioTree`` → port ScenarioTree (the same paths,
    probabilities and groups, as numpy arrays)."""
    return ScenarioTree(omega_paths=np.array(ref.omega_paths, np.float64),
                        probs=np.array(ref.probs, np.float64),
                        groups=np.array(ref.groups, int))


def stagewise_qp(ref, device=DEFAULT_DEVICE) -> StagewiseQP:
    """A reference ``StagewiseQP`` → port StagewiseQP: every array field as
    fp32 (None stays None), the static fields as they are."""
    device = resolve_device(device)
    kw = {}
    for f in dataclasses.fields(StagewiseQP):
        if f.name == "cache":
            continue
        v = getattr(ref, f.name)
        if isinstance(v, tuple):
            kw[f.name] = tuple(int(i) for i in v)
        elif v is None or isinstance(v, (bool, int, float)):
            kw[f.name] = v
        else:
            kw[f.name] = _t(v, device)
    return StagewiseQP(**kw)


def stagewise_tree_qp(ref, device=DEFAULT_DEVICE) -> StagewiseTreeQP:
    """A reference ``StagewiseTreeQP`` → port StagewiseTreeQP over the
    carried-across stagewise prep."""
    device = resolve_device(device)
    return StagewiseTreeQP(
        sw=stagewise_qp(ref.sw, device), M=_t(ref.M, device),
        probs=_t(ref.probs, device), omega=_t(ref.omega, device),
        S=int(ref.S), binary_reps=tuple(int(i) for i in ref.binary_reps),
        rep_map=tuple(int(i) for i in ref.rep_map))


def device_qp(ref, device=DEFAULT_DEVICE) -> DeviceQP:
    """A reference ``DeviceQP`` → port DeviceQP."""
    device = resolve_device(device)
    return DeviceQP(
        **{k: _t(getattr(ref, k), device) for k in DEVICEQP_ARRAYS},
        binary_idx=tuple(int(i) for i in ref.binary_idx), N=int(ref.N),
        info=mld_info(ref.info),
        binary_shift=tuple(int(i) for i in ref.binary_shift))


def kernel_qp(ref, base: BoxQP) -> KernelQP:
    """A reference ``PallasQP`` (column vectors (rows, 1)) → port
    KernelQP over the already converted ``base`` spec."""
    dev = base.device
    arrays = {k: _t(getattr(ref, k), dev) for k in KERNELQP_ARRAYS}
    for k in KERNELQP_ARRAYS[3:]:
        arrays[k] = arrays[k].reshape(-1)
    return KernelQP(base=base, **arrays,
                    cinv=(1.0 / base.cost_scale).float(),
                    n_pad=int(ref.n_pad), m_pad=int(ref.m_pad))


def bnb_spec(ref) -> BnbSpec:
    """A reference ``BnbSpec`` → port BnbSpec, every field."""
    return BnbSpec(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(BnbSpec)})


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def to_numpy(obj) -> dict:
    """The array fields of a BoxQP / DeviceQP / KernelQP of the port, or
    every field of a ``BnbResult`` / ``PooledState`` of either package
    (matched by class name), as numpy."""
    names = {BoxQP: BOXQP_ARRAYS, DeviceQP: DEVICEQP_ARRAYS,
             KernelQP: KERNELQP_ARRAYS}.get(type(obj))
    if names is None:
        ours = {c.__name__: c for c in (BnbResult, PooledState)}
        cls = ours.get(type(obj).__name__)
        if cls is None:
            raise TypeError(f"to_numpy: no rule for {type(obj).__name__}")
        names = [f.name for f in dataclasses.fields(cls)]
    return {k: _np(getattr(obj, k)) for k in names}
