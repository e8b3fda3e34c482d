"""pyhybridcontrol_tpu_torch: the PyTorch/CUDA port of the hybrid-MPC engine.

The JAX package ``pyhybridcontrol_tpu`` stays in the repository as the
reference; this package mirrors its module names so each counterpart is
easy to find. It imports ``torch`` and never ``jax``. The host side
(condensation, equilibration, KKT factorizations) is numpy float64, the
device side is torch fp32, and the kernels are CUDA C++ for Hopper
(``csrc/``, loaded by ``ops/_build.py``): the batched ADMM kernels of the
condensed frame and the stagewise frame's block-tridiagonal sweep.

It serves benchmark configs 1–4: MLD model → condensation (and its
transforms) → B&B MIQP on the card → first input
(``python -m pyhybridcontrol_tpu_torch.serve --config double_integrator``,
``pwa_actuator``, ``thermal_uc``, ``scenario_batch``), runs all five
configs end to end (``python -m pyhybridcontrol_tpu_torch.run --config
<name>``, with checkpoint/resume and JSONL logs; config 5 on one card as
one pooled batch), micro-grid agents (one aggregate MIQP a step, or dual
decomposition with one pooled B&B over the agents a round), the studies
of ``examples/`` (``python -m pyhybridcontrol_tpu_torch.examples.<name>``),
and stochastic MPC
over scenario trees (``MpcController.set_scenario_tree``: the dense joint
frame, batched through the pool with rep-map branching, or the consensus
tree), and long horizons on the stagewise O(N) frame
(``solver="stagewise"``, with or without a tree).

Layer map (bottom → top), as in the reference:

    utils/      StructDict, block-matrix assembly
    mld/        MldInfo, MldModel, PWA → MLD, parameterized templates
    models/     switched double integrator, PWA spring, DEWH water heater
    ops/        condensation and its transforms, root presolve, Ruiz
                scaling, ADMM (torch), CUDA kernels, scenario trees
                (dense joint frame, consensus ADMM), the stagewise frame
                and its tree
    solver/     enumeration, rollout repair, branch-and-bound, fp64 oracle
    control/    MpcController
    loop/       receding-horizon closed loop (single and pooled batch)
    agents/     Agent / MpcAgent, micro-grid coordination (aggregate and
                decentralized)
    io/         checkpoints, structured logs, profile resampling
    configs/    benchmark configurations
    run.py      benchmark-config CLI
    serve.py    stdin and TCP serving loop
    examples/   runnable studies
"""

__version__ = "0.1.0"

from pyhybridcontrol_tpu_torch.utils.structdict import (
    StructDict,
    named_struct_dict,
)
from pyhybridcontrol_tpu_torch.mld.info import MldInfo, VarTypes
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.mld.pwa import PwaRegion, PwaSystem, pwa_to_mld
from pyhybridcontrol_tpu_torch.mld.symbolic import MldTemplate
from pyhybridcontrol_tpu_torch.mld.compose import aggregate_mld
from pyhybridcontrol_tpu_torch.ops.condense import (
    CondensedMpc,
    DeviceQP,
    MpcWeights,
)
from pyhybridcontrol_tpu_torch.control.mpc import MpcController
from pyhybridcontrol_tpu_torch.agents.agent import (
    Agent,
    ControlledAgent,
    MpcAgent,
)
from pyhybridcontrol_tpu_torch.loop.closed_loop import (
    closed_loop,
    make_mpc_step,
)
from pyhybridcontrol_tpu_torch.solver.bnb import BnbSpec, solve_miqp_bnb

__all__ = [
    "StructDict", "named_struct_dict", "MldInfo", "MldModel", "VarTypes",
    "PwaRegion", "PwaSystem", "pwa_to_mld", "MldTemplate", "aggregate_mld",
    "CondensedMpc", "DeviceQP", "MpcWeights", "MpcController",
    "Agent", "ControlledAgent", "MpcAgent", "closed_loop", "make_mpc_step",
    "BnbSpec", "solve_miqp_bnb", "__version__",
]
