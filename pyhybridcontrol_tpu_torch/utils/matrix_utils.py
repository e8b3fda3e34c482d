"""Block-matrix assembly helpers (numpy, host float64).

Counterpart of ``pyhybridcontrol_tpu/utils/matrix_utils.py``. Condensation
runs on the host in float64, so only the numpy form is needed here.
"""

from __future__ import annotations

import numpy as np


def atleast_2d_col(a, dtype=None):
    """Coerce to a 2-D column: scalars → (1,1), 1-D (n,) → (n,1)."""
    a = np.asarray(a, dtype=dtype)
    if a.ndim == 0:
        return a.reshape(1, 1)
    if a.ndim == 1:
        return a.reshape(-1, 1)
    return a


def block_diag(blocks):
    """Dense block-diagonal of a list of 2-D arrays."""
    blocks = [np.asarray(b) for b in blocks]
    if not blocks:
        return np.zeros((0, 0))
    out = np.zeros((sum(b.shape[0] for b in blocks),
                    sum(b.shape[1] for b in blocks)), dtype=blocks[0].dtype)
    r = c = 0
    for b in blocks:
        out[r:r + b.shape[0], c:c + b.shape[1]] = b
        r += b.shape[0]
        c += b.shape[1]
    return out


def block_diag_rep(block, n):
    """Block-diagonal with ``block`` repeated ``n`` times."""
    block = np.asarray(block)
    m, k = block.shape
    out = np.einsum("ij,kl->ikjl", np.eye(n, dtype=block.dtype), block)
    return out.reshape(n * m, n * k)


def block_toeplitz(first_col_blocks, n_cols=None):
    """Lower-triangular block-Toeplitz from ``[T0, T1, …, T_{N-1}]``:

        [[T0            ]
         [T1  T0        ]
         [T2  T1  T0    ]
         [...       T0  ]]

    the input-response operator of horizon condensation.
    """
    blocks = [np.asarray(b) for b in first_col_blocks]
    n = len(blocks)
    if n_cols is None:
        n_cols = n
    m, k = blocks[0].shape
    out = np.zeros((n * m, n_cols * k), dtype=blocks[0].dtype)
    for i in range(n):
        for j in range(n_cols):
            if 0 <= i - j < n:
                out[i * m : (i + 1) * m, j * k : (j + 1) * k] = blocks[i - j]
    return out


def matrix_powers(A, n):
    """[I, A, A², …, Aⁿ] (n+1 entries)."""
    A = np.asarray(A)
    out = [np.eye(A.shape[0], dtype=A.dtype)]
    for _ in range(n):
        out.append(out[-1] @ A)
    return out
