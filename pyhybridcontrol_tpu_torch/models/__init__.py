from pyhybridcontrol_tpu_torch.models.dewh import (
    DewhParams,
    dewh_energy_price_seq,
    dewh_matrices,
    dewh_model,
    dewh_weights,
    min_up_down_rows,
)
from pyhybridcontrol_tpu_torch.models.double_integrator import (
    default_weights as di_default_weights,
    switched_double_integrator,
)
from pyhybridcontrol_tpu_torch.models.pwa_examples import (
    pwa_spring_mld,
    pwa_spring_system,
    pwa_weights,
)

__all__ = ["switched_double_integrator", "di_default_weights",
           "pwa_spring_system", "pwa_spring_mld", "pwa_weights",
           "DewhParams", "dewh_matrices", "dewh_model", "dewh_weights",
           "dewh_energy_price_seq", "min_up_down_rows"]
