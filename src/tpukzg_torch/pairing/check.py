"""The pairing and the multi-pairing product check on precomputed lines
(counterpart of ``tpukzg/pairing/check.py:16-71``).  The pairing is
cubed (final exponent 3 (p^12 - 1) / r), and a G1 input at infinity
contributes one.
"""

from __future__ import annotations

import torch

from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.field.tower import FP12
from tpukzg_torch.pairing.final_exp import final_exp
from tpukzg_torch.pairing.lines import precompute_lines
from tpukzg_torch.pairing.miller import miller_loop_lines


def miller_product(pairs_with_lines):
    """prod_i f_i(P_i) before the final exponentiation; the points'
    batch axes (...) broadcast against each pair's one set of lines."""
    pts = tuple(torch.stack(torch.broadcast_tensors(
        *[p[i] for p, _ in pairs_with_lines])) for i in range(3))
    xp, yp, is_inf = g1m.normalize(pts)                  # (k, ..., 24)
    ones = (1,) * (xp.dim() - 2)

    def lines(j):                                        # (k, 1.., 63, ...)
        t = torch.stack([ln[j] for _, ln in pairs_with_lines])
        return t.reshape(t.shape[:1] + ones + t.shape[1:])

    fs = miller_loop_lines(xp, yp, lines(0), lines(1))   # (k, ..., 2, 3, 2, L)
    fs = FP12.select(is_inf, FP12.one(is_inf.shape, fs.device), fs)
    f = fs[0]
    for i in range(1, fs.shape[0]):
        f = FP12.mul(f, fs[i])
    return f


def pairing_check(pairs_with_lines):
    """prod_i e(P_i, Q_i)^3 == 1 -> (...) bool tensor.
    pairs_with_lines: [(G1 point ((..., 24) coords), (dbl_lines,
    add_lines))]."""
    e = final_exp(miller_product(pairs_with_lines))
    return FP12.eq(e, FP12.one((), e.device))


def pairing(p_point, q_point):
    """e(P, Q)^3 -> (..., 2, 3, 2, 24) Fp12: the lines of the G2 point Q
    ((2, 24) coords), the Miller loop at the G1 point P ((..., 24)
    coords) and the final exponentiation; one where P is at infinity.
    Equal bit for bit to golden's ``pairing``."""
    return final_exp(miller_product([(p_point, precompute_lines(q_point))]))
