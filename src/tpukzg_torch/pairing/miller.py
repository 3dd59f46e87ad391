"""Miller loop over precomputed lines (counterpart of
``tpukzg/pairing/miller.py``): 63 steps of f <- f^2 * l_dbl(P), with
f <- f * l_add(P) at the 5 set bits of |x|; the result is conjugated
because x < 0.  The add step runs only where the static bit is set —
the same value as the reference's select."""

from __future__ import annotations

import torch

from tpukzg_torch.field.tower import FP12
from tpukzg_torch.pairing.lines import MILLER_BITS, N_STEPS, line_eval


def miller_loop_lines(xp, yp, dbl_lines, add_lines):
    """xp, yp (..., L) against lines (..., 63, 3, 2, L)."""
    batch = torch.broadcast_shapes(xp.shape[:-1], dbl_lines.shape[:-4])
    f = FP12.one(batch, xp.device)
    for i in range(N_STEPS):
        f = FP12.sqr(f)
        f = FP12.mul(f, line_eval(dbl_lines[..., i, :, :, :], xp, yp))
        if MILLER_BITS[i]:
            f = FP12.mul(f, line_eval(add_lines[..., i, :, :, :], xp, yp))
    return FP12.conj(f)
