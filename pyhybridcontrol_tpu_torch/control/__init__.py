from pyhybridcontrol_tpu_torch.control.mpc import MpcController

__all__ = ["MpcController"]
