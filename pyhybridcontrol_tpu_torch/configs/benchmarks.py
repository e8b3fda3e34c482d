"""Benchmark configurations ported so far.

Counterpart of ``pyhybridcontrol_tpu/configs/benchmarks.py``. Slice 1
ports config 1, ``double_integrator`` (switched double-integrator MLD,
N=10), with its ``BnbSpec`` as it is; the other configurations need
models and condense transforms that are not ported yet. Fields the
reference's configurations carry for paths not ported here (closed-loop
length, scenario batch, move blocking, soft rows) come back with the
code that reads them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    name: str
    description: str
    N: int
    build: Callable             # () -> (model, controller_kwargs dict)
    bnb: BnbSpec = dataclasses.field(default_factory=BnbSpec)


def _build_double_integrator():
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights, switched_double_integrator)

    return switched_double_integrator(), dict(weights=default_weights())


BENCHMARK_CONFIGS: Dict[str, BenchmarkConfig] = {
    "double_integrator": BenchmarkConfig(
        name="double_integrator",
        description="switched double-integrator MLD, N=10, closed loop",
        N=10, build=_build_double_integrator,
        bnb=BnbSpec(capacity=512, wave_size=32, max_waves=64, qp_iters=400),
    ),
}


def get_config(name: str) -> BenchmarkConfig:
    if name not in BENCHMARK_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available in the port: "
            f"{sorted(BENCHMARK_CONFIGS)}")
    return BENCHMARK_CONFIGS[name]
