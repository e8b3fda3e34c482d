"""Parameterized MLD templates: matrices materialized from parameters.

Counterpart of ``pyhybridcontrol_tpu/mld/symbolic.py``. A template is a
plain Python function ``params → {matrix_name: array}`` evaluated on the
host in float64 at materialization time:

    tmpl = MldTemplate(build_fn, required=("Ts", "C_w"))
    model = tmpl.materialize(StructDict(Ts=900.0, C_w=4.2e3, ...))

Materialized models are cached per parameter values. ``from_sympy``
builds a template from sympy expression matrices (sympy is imported
only there). The port's ``MldModel`` keeps fp32 tensors, so the
reference's ``dtype`` argument has no counterpart here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import numpy as np

from pyhybridcontrol_tpu_torch.mld.info import MldInfo
from pyhybridcontrol_tpu_torch.mld.model import MldModel


class MldTemplate:
    def __init__(self, build_fn: Callable[..., Dict],
                 required: Sequence[str] = (),
                 info: Optional[MldInfo] = None):
        self._build_fn = build_fn
        self._required = tuple(required)
        self._info = info
        self._cache: Dict = {}

    def materialize(self, params=None, **kw) -> MldModel:
        p = dict(params or {})
        p.update(kw)
        missing = [k for k in self._required if k not in p]
        if missing:
            raise ValueError(f"missing MLD template parameters: {missing}")
        key = _param_key(p)
        if key is not None and key in self._cache:
            return self._cache[key]
        model = MldModel.from_matrices(self._info, **self._build_fn(**p))
        if key is not None:
            self._cache[key] = model
        return model

    __call__ = materialize


def from_sympy(symbolic_mats, info: Optional[MldInfo] = None) -> MldTemplate:
    """An MldTemplate from sympy expression matrices: their free symbols
    are the template's parameters, lambdified to numpy.

        import sympy as sp
        Ts, tau = sp.symbols("Ts tau")
        tmpl = from_sympy({"A": sp.Matrix([[1, Ts], [0, 1 - Ts/tau]]),
                           "B1": sp.Matrix([[0], [Ts/tau]])})
        model = tmpl.materialize(Ts=0.25, tau=2.0)
    """
    import sympy as sp

    mats = {k: sp.Matrix(v) for k, v in symbolic_mats.items()}
    symbols = sorted(
        {s for m in mats.values() for s in m.free_symbols},
        key=lambda s: s.name)
    names = [s.name for s in symbols]
    fns = {k: sp.lambdify(symbols, m, modules="numpy")
           for k, m in mats.items()}

    def build_fn(**params):
        vals = [params[n] for n in names]
        return {k: np.asarray(fn(*vals), dtype=np.float64)
                for k, fn in fns.items()}

    return MldTemplate(build_fn, required=tuple(names), info=info)


def _param_key(p):
    try:
        return tuple(sorted(
            (k, float(v) if np.isscalar(v) else _arr_key(v))
            for k, v in p.items()))
    except (TypeError, ValueError):
        return None  # unhashable params → skip caching


def _arr_key(v):
    a = np.asarray(v)
    return (a.shape, a.dtype.str, a.tobytes())
