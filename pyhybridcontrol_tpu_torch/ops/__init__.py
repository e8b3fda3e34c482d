from pyhybridcontrol_tpu_torch.ops.admm import (
    AdmmResult,
    BoxQP,
    admm_solve,
    prepare_admm,
    prepare_admm_mpc,
)
from pyhybridcontrol_tpu_torch.ops.condense import (
    CondensedMpc,
    DeviceQP,
    MpcWeights,
)
from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
    admm_solve_auto,
    admm_wave_auto,
    prepare_kernel_qp,
)

__all__ = [
    "AdmmResult", "BoxQP", "admm_solve", "prepare_admm", "prepare_admm_mpc",
    "CondensedMpc", "DeviceQP", "MpcWeights",
    "admm_solve_auto", "admm_wave_auto", "prepare_kernel_qp",
]
