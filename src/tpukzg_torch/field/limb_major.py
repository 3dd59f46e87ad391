"""Limb-major field ops: tensors are (L, *batch), limbs on the leading axis.

Counterpart of ``tpukzg/field/limb_major.py``.  The arithmetic is the
trailing-axis code of ``field/mont.py`` on a moved view; products go to
the montmul kernel on the card with the limb-major strides, so nothing
is transposed there.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.field.mont import (FieldParams, FP, FR, FP_PLAIN,
                                     FR_PLAIN)
from tpukzg_torch.kernels import montmul as _mm


def _t(x):
    return x.movedim(0, -1)


def _lm(x):
    return x.movedim(-1, 0)


class FieldLM:
    def __init__(self, params: FieldParams):
        self.params = params
        self.L = params.L
        self.modulus = params.modulus
        self.one_np = np.asarray(params.one_mont, np.int32)[:, None]

    def add(self, a, b):
        return _lm(self.params.add(_t(a), _t(b)))

    def sub(self, a, b):
        return _lm(self.params.sub(_t(a), _t(b)))

    def neg(self, a):
        return _lm(self.params.neg(_t(a)))

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        if self.params.plain:
            return _mm.montmul_plain(a, b, self.params, limb_dim=0)
        return _mm.montmul(a, b, self.params, limb_dim=0)

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        return _lm(self.params.inv(_t(a)))

    def mul_small(self, a, k: int):
        return _lm(self.params.mul_small(_t(a), k))

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)

    def eq(self, a, b):
        return (a == b).all(0)

    def is_zero(self, a):
        return (a == 0).all(0)


FP_LM = FieldLM(FP)
FR_LM = FieldLM(FR)
FP_LM_PLAIN = FieldLM(FP_PLAIN)
FR_LM_PLAIN = FieldLM(FR_PLAIN)
