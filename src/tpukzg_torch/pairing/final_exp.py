"""Final exponentiation by 3 (p^12 - 1) / r (counterpart of
``tpukzg/pairing/final_exp.py:31-63``): the easy part, then the cubed
hard part f^(3h) = t3^(x^2) t3^(p^2) conj(t3) f^3 with
t3 = t2^x t2^p, t2 = t1^(x-1), t1 = f^(x-1)."""

from __future__ import annotations

from tpukzg_torch.field.tower import FP12
from tpukzg_torch.pairing.lines import X_BLS_ABS

_X_BITS = [int(b) for b in bin(X_BLS_ABS)[2:]]   # MSB first


def _pow_abs_x(g):
    """g^|x|: 63 cyclotomic squarings, a multiply at each set bit."""
    acc = g
    for bit in _X_BITS[1:]:
        acc = FP12.cyclotomic_sqr(acc)
        if bit:
            acc = FP12.mul(acc, g)
    return acc


def _exp_x_minus_1(g):
    return FP12.conj(FP12.mul(_pow_abs_x(g), g))


def final_exp(f):
    u = FP12.mul(FP12.conj(f), FP12.inv(f))
    f = FP12.mul(FP12.frobenius(u, 2), u)
    t1 = _exp_x_minus_1(f)
    t2 = _exp_x_minus_1(t1)
    t3 = FP12.mul(FP12.conj(_pow_abs_x(t2)), FP12.frobenius(t2, 1))
    a = FP12.mul(FP12.mul(_pow_abs_x(_pow_abs_x(t3)), FP12.frobenius(t3, 2)),
                 FP12.conj(t3))
    f3 = FP12.mul(FP12.sqr(f), f)
    return FP12.mul(a, f3)
