"""Selection with JAX's tie rules, identical on CPU and CUDA.

``lax.top_k`` and ``jnp.argmax``/``argmin`` take the lower index among
equal values and ``jnp.argsort`` is stable; ``torch.topk``,
``torch.argmax`` and ``torch.argmin`` promise no order among ties on
CUDA. Ties are the normal case in the B&B loops (inactive slots all rank
``BIG``, pseudo-cost scores are all equal at the root), so the search
would walk another tree on the card than on the CPU. These helpers fix
the rule.
"""

from __future__ import annotations

import torch


def first_k(values, k: int, descending: bool = False):
    """Indices of the k smallest (largest) values of a 1-D tensor in
    order, ties by lower index — the ``lax.top_k`` / stable ``argsort``
    order."""
    return torch.sort(values, descending=descending, stable=True)[1][:k]


def first_arg(values, dim: int = -1, largest: bool = True):
    """Index of the first maximum (minimum) along ``dim`` — the
    ``jnp.argmax`` (``argmin``) rule."""
    n = values.shape[dim]
    best = (values.amax(dim, keepdim=True) if largest
            else values.amin(dim, keepdim=True))
    shape = [1] * values.ndim
    shape[dim] = n
    idx = torch.arange(n, device=values.device).view(shape)
    return torch.where(values == best, idx, n).amin(dim).clamp_max(n - 1)
