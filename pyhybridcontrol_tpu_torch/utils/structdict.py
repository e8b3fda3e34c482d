"""StructDict: a plain dict with attribute access.

Counterpart of ``pyhybridcontrol_tpu/utils/structdict.py`` without the
pytree registration: PyTorch runs eagerly, so matrix bundles and results
are ordinary dicts of tensors or numpy arrays. ``named_struct_dict``
classes are therefore registered as nothing either; they keep their type
name and field order through ``copy``, ``update_new`` and ``sub_struct``.
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

    def copy(self):
        return self._of(self)

    def update_new(self, *args, **kwargs):
        """Return a copy with the given updates applied (functional update)."""
        out = self.copy()
        out.update(*args, **kwargs)
        return out

    def sub_struct(self, keys):
        """Return a StructDict of this type restricted to ``keys``."""
        return self._of({k: self[k] for k in keys})

    def _of(self, items):
        """A new dict of this type holding ``items`` as they are: built
        past ``__init__``, which a named class maps onto its fields."""
        out = type(self).__new__(type(self))
        dict.update(out, items)
        return out


def _short(v):
    shape = getattr(v, "shape", None)
    if shape is not None:
        return f"{type(v).__name__}{tuple(shape)}"
    return repr(v)


def named_struct_dict(name: str, *field_names):
    """Create a named StructDict subclass with a default field order:
    positional arguments map onto ``field_names`` in order, keywords are
    added after them, and more positional arguments than fields raise
    ``TypeError``. No pytree is registered (see the module docstring)."""
    fields = tuple(field_names)

    def __init__(self, *args, **kwargs):
        if args and len(args) > len(fields):
            raise TypeError(
                f"{name} takes at most {len(fields)} positional args"
            )
        dict.__init__(self, zip(fields, args))
        dict.update(self, kwargs)

    return type(name, (StructDict,), {"__init__": __init__, "_fields": fields,
                                      "__slots__": ()})
