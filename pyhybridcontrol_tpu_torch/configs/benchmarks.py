"""Benchmark configurations ported so far.

Counterpart of ``pyhybridcontrol_tpu/configs/benchmarks.py``: config 1,
``double_integrator`` (switched double-integrator MLD, N=10), and config
4, ``scenario_batch`` (1024 batched instances of the same model through
the pooled engine), each with its ``BnbSpec`` as it is. The other
configurations need models and condense transforms that are not ported
yet. Fields the reference's configurations carry for paths not ported
here (closed-loop length, move blocking, soft rows) come back with the
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
    batch: int = 1              # instances per batched request
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
    "scenario_batch": BenchmarkConfig(
        name="scenario_batch",
        description="1024 batched MIQP instances per card (scenario MPC)",
        N=10, batch=1024, build=_build_double_integrator,
        bnb=BnbSpec(capacity=64, wave_size=16, max_waves=24, qp_iters=100),
    ),
}


def get_config(name: str) -> BenchmarkConfig:
    if name not in BENCHMARK_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available in the port: "
            f"{sorted(BENCHMARK_CONFIGS)}")
    return BENCHMARK_CONFIGS[name]
