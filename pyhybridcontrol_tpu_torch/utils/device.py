"""Device resolution shared by the port's entry points, and the copy of
a result to the host.

Every entry point that takes a ``device`` defaults to the card
(``"cuda"``) and raises when there is none; nothing carries on on the CPU
unless the caller asks for ``device="cpu"``, as the CPU tests do.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEVICE = "cuda"


def to_numpy(v) -> np.ndarray:
    """A host numpy array of ``v`` (a tensor on any device, or anything
    numpy takes)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``; raises if it names a CUDA device and no
    CUDA device is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"pyhybridcontrol_tpu_torch: device {str(dev)!r} requested but "
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
