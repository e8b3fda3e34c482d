"""Carry the reference's prepared state across into the port.

The JAX package prepares the same data this package prepares (the
condensed ``DeviceQP``, the Ruiz-scaled ``BoxQP`` and the kernel prep of
``prepare_pallas``). These functions turn such objects — read only
through ``numpy.asarray`` of their fields, so this module never imports
JAX — into the port's objects on a torch device, and ``to_numpy`` turns
the port's objects back into numpy, so tests can feed both packages
identical matrices and compare their outputs field by field.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.ops.admm import BoxQP
from pyhybridcontrol_tpu_torch.ops.condense import DeviceQP
from pyhybridcontrol_tpu_torch.ops.cuda_admm import KernelQP

BOXQP_ARRAYS = ("P", "A", "Kinv", "D", "E", "cost_scale", "rho_vec")
DEVICEQP_ARRAYS = ("H", "f0", "Fx", "Fw", "Fup", "G", "h0", "Hx", "Hw",
                   "lb", "ub", "T_full")
KERNELQP_ARRAYS = ("AGT", "M", "P", "dbox", "dbox_inv", "rhoG", "rhoG_inv",
                   "rhoB", "rhoB_inv", "EG_inv", "EB_inv", "Dc_inv")


def _t(a, device):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=device)


def box_qp(ref, device="cpu") -> BoxQP:
    """A reference ``BoxQP`` (or anything with its fields) → port BoxQP."""
    return BoxQP(**{k: _t(getattr(ref, k), device) for k in BOXQP_ARRAYS},
                 rho=float(ref.rho), sigma=float(ref.sigma),
                 alpha=float(ref.alpha), m_ineq=int(ref.m_ineq))


def mld_info(ref) -> MldInfo:
    return MldInfo(**{f.name: getattr(ref, f.name)
                      for f in dataclasses.fields(MldInfo)})


def device_qp(ref, device="cpu") -> DeviceQP:
    """A reference ``DeviceQP`` → port DeviceQP."""
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


def to_numpy(obj) -> dict:
    """The array fields of a port BoxQP / DeviceQP / KernelQP as numpy."""
    names = {BoxQP: BOXQP_ARRAYS, DeviceQP: DEVICEQP_ARRAYS,
             KernelQP: KERNELQP_ARRAYS}[type(obj)]
    return {k: getattr(obj, k).detach().cpu().numpy() for k in names}
