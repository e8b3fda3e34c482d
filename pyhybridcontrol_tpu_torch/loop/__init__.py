from pyhybridcontrol_tpu_torch.loop.closed_loop import (
    ClosedLoopResult,
    closed_loop,
    closed_loop_batch,
    make_mpc_step,
    make_mpc_step_batch,
)

__all__ = ["ClosedLoopResult", "closed_loop", "closed_loop_batch",
           "make_mpc_step", "make_mpc_step_batch"]
