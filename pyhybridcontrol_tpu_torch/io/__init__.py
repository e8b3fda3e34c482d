from pyhybridcontrol_tpu_torch.io.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from pyhybridcontrol_tpu_torch.io.logging import StructuredLog
from pyhybridcontrol_tpu_torch.io.timeseries import (
    profile_to_dataframe,
    resample_profile,
)

__all__ = ["save_checkpoint", "load_checkpoint", "StructuredLog",
           "resample_profile", "profile_to_dataframe"]
