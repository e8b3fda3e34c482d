from pyhybridcontrol_tpu_torch.utils.structdict import StructDict
from pyhybridcontrol_tpu_torch.utils.matrix_utils import (
    atleast_2d_col,
    block_diag,
    block_toeplitz,
)

__all__ = ["StructDict", "atleast_2d_col", "block_diag", "block_toeplitz"]
