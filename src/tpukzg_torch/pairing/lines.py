"""Miller-loop lines of a fixed G2 point, and their evaluation
(counterpart of ``tpukzg/pairing/lines.py``).  The line coefficients
(c0, c3, c5) of [1]_2 and [tau]_2 are computed once per setup
(``precompute_lines``) or read from the SRS file; evaluating a line at
P = (x_P, y_P) gives the sparse Fp12 element
    c0 y_P w^0 + c3 w^3 + c5 x_P w^5,
with, for the doubling step at T = (X, Y, Z),
    c0 = 2 xi Y Z^2,   c3 = 3 X^3 - 2 Y^2 Z,   c5 = -3 X^2 Z,
and for the addition step T + Q, Q = (xq, yq) affine,
    c0 = xi (X - xq Z),   c3 = (Y - yq Z) xq - (X - xq Z) yq,
    c5 = -(Y - yq Z).
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.field.tower import FP2

X_BLS_ABS = 0xD201000000010000

MILLER_BITS = np.array([int(b) for b in bin(X_BLS_ABS)[3:]], dtype=np.int32)
N_STEPS = len(MILLER_BITS)  # 63


def _stack(parts):
    return torch.stack(torch.broadcast_tensors(*parts), -3)


def _dbl_coeffs(T):
    X, Y, Z = T
    sq = FP2.sqr(_stack([X, Y, Z]))
    X2, Y2, Z2 = sq[..., 0, :, :], sq[..., 1, :, :], sq[..., 2, :, :]
    pr = FP2.mul(_stack([Y, X2, FP2.sqr(X)]), _stack([Z2, X, Z]))
    YZ2, X3, X2Z = pr[..., 0, :, :], pr[..., 1, :, :], pr[..., 2, :, :]
    Y2Z = FP2.mul(Y2, Z)
    c0 = FP2.mul_by_nonresidue(FP2.double(YZ2))
    c3 = FP2.sub(FP2.mul_small(X3, 3), FP2.double(Y2Z))
    c5 = FP2.neg(FP2.mul_small(X2Z, 3))
    return c0, c3, c5


def _add_coeffs(T, q_aff):
    X, Y, Z = T
    xq, yq = q_aff
    pr = FP2.mul(_stack([yq, xq]), _stack([Z, Z]))
    theta = FP2.sub(Y, pr[..., 0, :, :])
    lam = FP2.sub(X, pr[..., 1, :, :])
    pr2 = FP2.mul(_stack([theta, lam]), _stack([xq, yq]))
    c3 = FP2.sub(pr2[..., 0, :, :], pr2[..., 1, :, :])
    return FP2.mul_by_nonresidue(lam), c3, FP2.neg(theta)


def _stack_coeffs(c0, c3, c5):
    return _stack([c0, c3, c5])                     # (..., 3, 2, L)


def precompute_lines(q_point):
    """Projective G2 point(s) (X, Y, Z) of (..., 2, L) -> (dbl_lines,
    add_lines), each (..., 63, 3, 2, L).  The rows of add_lines at steps
    with no add are computed all the same (the Miller loop skips them);
    they equal the JAX package's, so the lines compare bit for bit."""
    xq, yq, _ = G2.normalize(q_point)
    one = torch.as_tensor(FP2.one_np, device=xq.device).expand(xq.shape)
    q_proj = (xq, yq, one)
    T = q_proj
    dbl, add = [], []
    for bit in MILLER_BITS:
        dbl.append(_stack_coeffs(*_dbl_coeffs(T)))
        T = G2.double(T)
        add.append(_stack_coeffs(*_add_coeffs(T, (xq, yq))))
        if bit:
            T = G2.add(T, q_proj)
    return torch.stack(dbl, -4), torch.stack(add, -4)


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
