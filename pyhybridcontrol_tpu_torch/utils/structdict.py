"""StructDict: a plain dict with attribute access.

Counterpart of ``pyhybridcontrol_tpu/utils/structdict.py`` without the
pytree registration: PyTorch runs eagerly, so matrix bundles and results
are ordinary dicts of tensors or numpy arrays.
"""

from __future__ import annotations


class StructDict(dict):
    """A dict whose items are also attributes."""

    __slots__ = ()

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(
                f"{type(self).__name__!s} has no attribute or key {name!r}"
            ) from None

    def __setattr__(self, name, value):
        self[name] = value

    def __delattr__(self, name):
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __repr__(self):
        items = ", ".join(f"{k}={_short(v)}" for k, v in sorted(self.items()))
        return f"{type(self).__name__}({items})"


def _short(v):
    shape = getattr(v, "shape", None)
    if shape is not None:
        return f"{type(v).__name__}{tuple(shape)}"
    return repr(v)
