"""Limb-major field ops: tensors are (L, *batch), limbs on the leading axis.

Counterpart of ``tpukzg/field/limb_major.py``.  The arithmetic is the
trailing-axis code of ``field/mont.py`` on a moved view; products go to
the montmul kernel on the card with the limb-major strides, so nothing
is transposed there.  ``FP2_LM`` is Fp2 = Fp[u] / (u^2 + 1) in the same
layout, (48, *batch): c0's 24 limbs, then c1's (G2's coordinates).
``mul_b3`` multiplies by 3b of the BLS12-381 curve over the field: 12 on
G1 (Fp), 12 (1 + u) on G2 (Fp2).
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
        self.plain = params.plain
        self.L = params.L
        self.modulus = params.modulus
        self.one_np = np.asarray(params.one_mont, np.int32)[:, None]

    def one(self, device):
        """The Montgomery one, (L,) int32."""
        return self.params.const("one_mont", device, torch.int32)

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

    def mul_b3(self, a):
        return self.mul_small(a, 12)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(0), a, b)

    def eq(self, a, b):
        return (a == b).all(0)

    def is_zero(self, a):
        return (a == 0).all(0)


class Fp2LM:
    """Fp2 over a limb-major Fp: (2 L, *batch), c0's L limbs, then c1's.
    Linear ops run on both components at once as an Fp batch of two; a
    product is Karatsuba's three Fp products in one batched product."""

    def __init__(self, fp: FieldLM):
        self.fp = fp
        self.plain = fp.plain
        self.L = 2 * fp.L

    def one(self, device):
        one = self.fp.one(device)
        return torch.cat([one, torch.zeros_like(one)])

    def split(self, a):
        return a[:self.fp.L], a[self.fp.L:]

    def build(self, c0, c1):
        return torch.cat(torch.broadcast_tensors(c0, c1))

    def _pair(self, a):
        """(2 L, *batch) -> the Fp batch (L, 2, *batch)."""
        return a.reshape((2, self.fp.L) + tuple(a.shape[1:])).movedim(1, 0)

    def _unpair(self, x):
        return x.movedim(0, 1).reshape((self.L,) + tuple(x.shape[2:]))

    def add(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._unpair(self.fp.add(self._pair(a), self._pair(b)))

    def sub(self, a, b):
        a, b = torch.broadcast_tensors(a, b)
        return self._unpair(self.fp.sub(self._pair(a), self._pair(b)))

    def neg(self, a):
        return self._unpair(self.fp.neg(self._pair(a)))

    def mul_small(self, a, k: int):
        return self._unpair(self.fp.mul_small(self._pair(a), k))

    def mul_by_nonresidue(self, a):
        """a (1 + u) = (a0 - a1) + (a0 + a1) u."""
        a0, a1 = self.split(a)
        return self.build(self.fp.sub(a0, a1), self.fp.add(a0, a1))

    def mul_b3(self, a):
        return self.mul_small(self.mul_by_nonresidue(a), 12)

    def mul(self, a, b):
        fp = self.fp
        (a0, a1), (b0, b1) = self.split(a), self.split(b)
        lhs = torch.stack(torch.broadcast_tensors(a0, a1, fp.add(a0, a1)), 1)
        rhs = torch.stack(torch.broadcast_tensors(b0, b1, fp.add(b0, b1)), 1)
        lhs, rhs = torch.broadcast_tensors(lhs, rhs)
        t = fp.mul(lhs, rhs)
        t0, t1, t2 = t[:, 0], t[:, 1], t[:, 2]
        return self.build(fp.sub(t0, t1), fp.sub(fp.sub(t2, t0), t1))

    def sqr(self, a):
        return self.mul(a, a)

    def inv(self, a):
        fp = self.fp
        a0, a1 = self.split(a)
        t = fp.mul(torch.stack([a0, a1], 1), torch.stack([a0, a1], 1))
        d = fp.inv(fp.add(t[:, 0], t[:, 1]))
        return self.build(fp.mul(a0, d), fp.neg(fp.mul(a1, d)))

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
FP2_LM = Fp2LM(FP_LM)
FP2_LM_PLAIN = Fp2LM(FP_LM_PLAIN)
