"""The five benchmark configurations, declarative, with their builders.
Run one with ``python -m pyhybridcontrol_tpu_torch.run --config <name>``.

Counterpart of ``pyhybridcontrol_tpu/configs/benchmarks.py``:

1. double_integrator   switched double-integrator MLD, N=10, closed loop
2. pwa_actuator        PWA→MLD (hull encoding), N=20, on/off actuator
3. thermal_uc          DEWH thermal MLD, unit-commitment logic, move
                       blocking, N=24
4. scenario_batch      1024 batched MIQP instances per card
5. sharded_bnb         512 instances of the N=20 double integrator, a
                       large pool (the reference shards it with a bound
                       all-reduce)

each with its ``BnbSpec``, closed-loop length, move-blocking groups and
soft rows as the reference has them. Config 5 runs on one card as one
pooled batch (``run.py``), as the reference's ``run.py`` runs it on one
chip; its sharded pool, one MIQP's nodes over the ranks of a mesh, is
``parallel.sharded_bnb.solve_miqp_bnb_sharded`` (scripts/config5_pool4096.py
of the reference: 8 ranks × 512 slots).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec


@dataclasses.dataclass(frozen=True)
class BenchmarkConfig:
    name: str
    description: str
    N: int
    T: int                      # closed-loop steps
    build: Callable             # () -> (model, controller_kwargs dict)
    batch: int = 1              # instances per batched request
    bnb: BnbSpec = dataclasses.field(default_factory=BnbSpec)
    move_blocking: Optional[tuple] = None
    soft_rows: Optional[tuple] = None


def _build_double_integrator():
    from pyhybridcontrol_tpu_torch.models.double_integrator import (
        default_weights, switched_double_integrator)

    return switched_double_integrator(), dict(weights=default_weights())


def _build_pwa():
    from pyhybridcontrol_tpu_torch.models.pwa_examples import (
        pwa_spring_mld, pwa_weights)

    # hull (disaggregated) PWA encoding: its relaxation bounds the MIQP
    # (the big-M form's root bound is 0), so pruning and gaps engage
    model = pwa_spring_mld(on_off=True, formulation="hull")
    return model, dict(weights=pwa_weights())


def _build_thermal():
    from pyhybridcontrol_tpu_torch.models.dewh import (
        dewh_model, dewh_weights)

    return dewh_model(), dict(weights=dewh_weights())


N3 = 24
_nc_dewh = 7

BENCHMARK_CONFIGS: Dict[str, BenchmarkConfig] = {
    "double_integrator": BenchmarkConfig(
        name="double_integrator",
        description="switched double-integrator MLD, N=10, closed loop",
        N=10, T=40, build=_build_double_integrator,
        bnb=BnbSpec(capacity=512, wave_size=32, max_waves=64, qp_iters=400),
    ),
    "pwa_actuator": BenchmarkConfig(
        name="pwa_actuator",
        description="PWA→MLD spring-damper, N=20, on/off actuator",
        N=20, T=30, build=_build_pwa,
        bnb=BnbSpec(capacity=1024, wave_size=64, max_waves=64, qp_iters=400,
                    gap=1e-3),
    ),
    "thermal_uc": BenchmarkConfig(
        name="thermal_uc",
        description="DEWH thermal MLD + unit commitment + move blocking, "
                    "N=24",
        N=N3, T=48, build=_build_thermal,
        # 12 blocks of 2 steps → binary branching depth halves
        move_blocking=tuple(k // 2 for k in range(N3)),
        soft_rows=tuple(k * _nc_dewh + r for k in range(N3) for r in (0, 1)),
        bnb=BnbSpec(capacity=1024, wave_size=64, max_waves=48, qp_iters=400,
                    gap=1e-3),
    ),
    "scenario_batch": BenchmarkConfig(
        name="scenario_batch",
        description="1024 batched MIQP instances per card (scenario MPC)",
        N=10, T=1, batch=1024, build=_build_double_integrator,
        bnb=BnbSpec(capacity=64, wave_size=16, max_waves=24, qp_iters=100),
    ),
    "sharded_bnb": BenchmarkConfig(
        name="sharded_bnb",
        description="≥4096 nodes/scenarios sharded with bound all-reduce",
        N=20, T=1, batch=512, build=_build_double_integrator,
        bnb=BnbSpec(capacity=1024, wave_size=64, max_waves=64, qp_iters=300),
    ),
}


def get_config(name: str) -> BenchmarkConfig:
    if name not in BENCHMARK_CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; available: "
            f"{sorted(BENCHMARK_CONFIGS)}")
    return BENCHMARK_CONFIGS[name]
