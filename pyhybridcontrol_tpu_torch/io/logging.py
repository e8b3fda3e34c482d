"""Structured logs: per-step results flushed from the device to an
append-only JSONL stream on the host, with a pandas exporter; the solver
counters (cost, nodes, found) are recorded explicitly so that parity
deltas against the oracle stay auditable.

Counterpart of ``pyhybridcontrol_tpu/io/logging.py``: the same records,
field for field. pandas is imported only by the exporters.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional

from pyhybridcontrol_tpu_torch.utils.device import to_numpy


class StructuredLog:
    def __init__(self, path: Optional[str] = None, run_name: str = "run"):
        self.path = path
        self.run_name = run_name
        self.records = []
        self._fp = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._fp = open(path, "a", buffering=1)

    def log(self, step: int, **fields) -> None:
        rec: Dict[str, Any] = {"run": self.run_name, "step": int(step),
                               "t": time.time()}
        for k, v in fields.items():
            a = to_numpy(v)
            rec[k] = a.item() if a.ndim == 0 else a.tolist()
        self.records.append(rec)
        if self._fp:
            self._fp.write(json.dumps(rec) + "\n")

    def log_closed_loop(self, result, every: int = 1) -> None:
        """Flush a ClosedLoopResult's stacked tensors step by step."""
        objs = to_numpy(result.objs)
        xs = to_numpy(result.xs)
        vs = to_numpy(result.vs)
        nodes = to_numpy(result.nodes)
        found = to_numpy(result.found)
        for k in range(0, len(objs), every):
            self.log(k, x=xs[k], v=vs[k], obj=objs[k],
                     nodes=nodes[k], found=bool(found[k]))

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.records)

    def to_parquet(self, path: str) -> str:
        """Columnar export for large scenario studies (needs pandas and
        pyarrow; the JSONL stream is the always-available form).
        List-valued columns (x, v) are kept as arrow lists."""
        self.to_pandas().to_parquet(path, index=False)
        return path

    def close(self) -> None:
        if self._fp:
            self._fp.close()
            self._fp = None
