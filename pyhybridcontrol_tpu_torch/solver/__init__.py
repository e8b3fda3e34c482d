from pyhybridcontrol_tpu_torch.solver.bnb import (
    BnbResult,
    BnbSpec,
    solve_miqp_bnb,
)
from pyhybridcontrol_tpu_torch.solver.enumerate import (
    solve_miqp_enumerate_device,
)

__all__ = ["BnbResult", "BnbSpec", "solve_miqp_bnb",
           "solve_miqp_enumerate_device"]
