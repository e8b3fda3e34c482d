from pyhybridcontrol_tpu_torch.models.double_integrator import (
    default_weights as di_default_weights,
    switched_double_integrator,
)

__all__ = ["switched_double_integrator", "di_default_weights"]
