from pyhybridcontrol_tpu_torch.utils.structdict import (
    StructDict,
    named_struct_dict,
)
from pyhybridcontrol_tpu_torch.utils.matrix_utils import (
    atleast_2d_col,
    block_diag,
    block_toeplitz,
)

__all__ = [
    "StructDict",
    "named_struct_dict",
    "atleast_2d_col",
    "block_diag",
    "block_toeplitz",
]
