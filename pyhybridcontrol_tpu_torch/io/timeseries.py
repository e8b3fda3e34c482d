"""Time-series alignment: profiles (tariffs, draw forecasts, demand)
arrive at arbitrary rates, and controllers need them at the control period
Ts as plain arrays. These helpers go from pandas (or (t, v) arrays) to
numpy and back.

Counterpart of ``pyhybridcontrol_tpu/io/timeseries.py``: the same numpy
arithmetic; pandas is imported only where a Series comes in or goes out.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def resample_profile(series, Ts: float, T: Optional[int] = None,
                     how: str = "interp") -> np.ndarray:
    """Resample a profile to the control period.

    ``series``: pandas Series with DatetimeIndex, or (t_seconds, values)
    tuple, or plain array (assumed already at Ts — returned as-is).
    ``Ts``: control period in seconds. ``T``: number of steps (default:
    cover the input span). ``how``: "interp" (linear) | "hold"
    (zero-order hold, right for tariffs) | "mean" (energy-conserving
    averaging, right for demand profiles).
    """
    try:
        import pandas as pd

        if isinstance(series, pd.Series):
            t = ((series.index - series.index[0]).total_seconds()
                 .to_numpy())
            v = series.to_numpy(dtype=float)
        elif isinstance(series, tuple):
            t, v = (np.asarray(series[0], float),
                    np.asarray(series[1], float))
        else:
            return np.asarray(series, float)
    except ImportError:                       # pandas-free fallback
        if isinstance(series, tuple):
            t, v = (np.asarray(series[0], float),
                    np.asarray(series[1], float))
        else:
            return np.asarray(series, float)

    if T is None:
        T = int(np.floor(t[-1] / Ts)) + 1
    tq = np.arange(T) * Ts
    if how == "interp":
        return np.interp(tq, t, v)
    if how == "hold":
        idx = np.clip(np.searchsorted(t, tq, side="right") - 1, 0, None)
        return v[idx]
    if how == "mean":
        out = np.empty(T)
        edges = np.concatenate([tq, [tq[-1] + Ts]])
        for k in range(T):
            m = (t >= edges[k]) & (t < edges[k + 1])
            out[k] = v[m].mean() if m.any() else np.interp(tq[k], t, v)
        return out
    raise ValueError(f"unknown resampling mode {how!r}")


def profile_to_dataframe(values, Ts: float, start="2020-01-01",
                         name: str = "value"):
    """Array at period Ts → pandas Series with DatetimeIndex (the
    reference's log/plot-friendly form)."""
    import pandas as pd

    idx = pd.date_range(start=start, periods=len(values),
                        freq=f"{int(Ts)}s")
    return pd.Series(np.asarray(values, float), index=idx, name=name)
