from pyhybridcontrol_tpu_torch.mld.info import MldInfo, VarTypes
from pyhybridcontrol_tpu_torch.mld.model import MldModel
from pyhybridcontrol_tpu_torch.mld.pwa import PwaRegion, PwaSystem, pwa_to_mld
from pyhybridcontrol_tpu_torch.mld.symbolic import MldTemplate, from_sympy

__all__ = ["MldInfo", "VarTypes", "MldModel", "PwaSystem", "PwaRegion",
           "pwa_to_mld", "MldTemplate", "from_sympy"]
