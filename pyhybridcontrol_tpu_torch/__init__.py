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
``pwa_actuator``, ``thermal_uc``, ``scenario_batch``), and stochastic MPC
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
    configs/    benchmark configurations
    serve.py    stdin serving loop
"""

__version__ = "0.1.0"
