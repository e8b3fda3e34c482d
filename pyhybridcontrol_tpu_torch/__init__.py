"""pyhybridcontrol_tpu_torch: the PyTorch/CUDA port of the hybrid-MPC engine.

The JAX package ``pyhybridcontrol_tpu`` stays in the repository as the
reference; this package mirrors its module names so each counterpart is
easy to find. It imports ``torch`` and never ``jax``. The host side
(condensation, equilibration, KKT factorizations) is numpy float64, the
device side is torch fp32, and the two batched ADMM kernels are CUDA C++
for Hopper (``csrc/admm.cu``, loaded by ``ops/_build.py``).

Slice 1 covers the serve path of benchmark config 1: MLD model →
condensation → B&B MIQP on the card → first input
(``python -m pyhybridcontrol_tpu_torch.serve --config double_integrator``).

Layer map (bottom → top), as in the reference:

    utils/      StructDict, block-matrix assembly
    mld/        MldInfo, MldModel
    models/     switched double integrator
    ops/        condensation, Ruiz scaling, ADMM (torch), CUDA kernels
    solver/     enumeration, rollout repair, branch-and-bound
    control/    MpcController
    loop/       receding-horizon closed loop (single and pooled batch)
    configs/    benchmark configurations
    serve.py    stdin serving loop
"""

__version__ = "0.1.0"
