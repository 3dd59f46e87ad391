"""Miller-loop line evaluation on precomputed G2 lines (counterpart of
``tpukzg/pairing/lines.py:42-46, 106-119``).  The line coefficients
(c0, c3, c5) of [1]_2 and [tau]_2 come from the SRS file; evaluating a
line at P = (x_P, y_P) gives the sparse Fp12 element
    c0 y_P w^0 + c3 w^3 + c5 x_P w^5.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.field.tower import FP2

X_BLS_ABS = 0xD201000000010000

MILLER_BITS = np.array([int(b) for b in bin(X_BLS_ABS)[3:]], dtype=np.int32)
N_STEPS = len(MILLER_BITS)  # 63


def line_eval(coeffs, xp, yp):
    """coeffs (..., 3, 2, L); xp, yp (..., L) -> dense (..., 2, 3, 2, L)."""
    c0 = FP2.mul_fp(coeffs[..., 0, :, :], yp)
    c3 = coeffs[..., 1, :, :]
    c5 = FP2.mul_fp(coeffs[..., 2, :, :], xp)
    c0, c3, c5 = torch.broadcast_tensors(c0, c3, c5)
    z2 = torch.zeros_like(c0)
    row0 = torch.stack([c0, z2, z2], -3)
    row1 = torch.stack([z2, c3, c5], -3)
    return torch.stack([row0, row1], -4)
