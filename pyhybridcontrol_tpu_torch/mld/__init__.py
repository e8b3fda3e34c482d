from pyhybridcontrol_tpu_torch.mld.info import MldInfo, VarTypes
from pyhybridcontrol_tpu_torch.mld.model import MldModel

__all__ = ["MldInfo", "VarTypes", "MldModel"]
