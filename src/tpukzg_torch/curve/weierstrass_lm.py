"""Limb-major complete projective G1 group law (y^2 = x^3 + 4).

Counterpart of ``tpukzg/curve/weierstrass_lm.py`` (and of
``curve/weierstrass.py:_normalize, _scalar_mul*``).  Coordinates are
(L, *batch) int32 Montgomery limbs.  ``add`` and ``double`` go through
the ec_add and ec_double kernels on the card (``kernels/ec.py``); over a
plain field they are the tensor formulas.  ``scalar_mul`` runs the
windowed ladder on the card (a step: one ec_double launch of w
doublings, a gather of the digit's table entry, one ec_add launch) and
the 256-step ladder elsewhere.
"""

from __future__ import annotations

import torch

from tpukzg_torch.curve.weierstrass import window_digits
from tpukzg_torch.field.limb_major import FieldLM, FP_LM, FP_LM_PLAIN
from tpukzg_torch.kernels import ec as _ec
from tpukzg_torch.kernels.ec import _bmul


class CurveLM:
    def __init__(self, field: FieldLM, b3_small: int = 12):
        self.F = field
        self.b3_small = b3_small

    def inf(self, batch_shape, device):
        F = self.F
        one = F.params.const("one_mont", device, torch.int32).reshape(
            (F.L,) + (1,) * len(batch_shape)).expand((F.L,) + tuple(batch_shape))
        zero = torch.zeros((F.L,) + tuple(batch_shape), dtype=torch.int32,
                           device=device)
        return (zero, one.contiguous(), zero)

    def select(self, mask, p, q):
        return tuple(self.F.select(mask, a, b) for a, b in zip(p, q))

    def is_inf(self, p):
        return self.F.is_zero(p[2])

    def add(self, p, q):
        if self.F.params.plain:
            return _ec.ec_add_plain(p, q, self.F)
        return _ec.ec_add(p, q)

    def double(self, p):
        """RCB15 Alg. 9 (a = 0)."""
        return self.double_n(p, 1)

    def double_n(self, p, t: int):
        """[2^t] P: a run of t doublings (one ec_double launch on the
        card); t = 0 returns P."""
        if t == 0:
            return p
        if self.F.params.plain:
            return _ec.ec_double_plain(p, self.F, t)
        return _ec.ec_double(p, t)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.F.neg(Y), Z)

    def eq(self, p, q):
        F = self.F
        a, b, c, d = _bmul(F, [(p[0], q[2]), (q[0], p[2]),
                               (p[1], q[2]), (q[1], p[2])])
        same = F.eq(a, b) & F.eq(c, d)
        pi, qi = self.is_inf(p), self.is_inf(q)
        return torch.where(pi | qi, pi == qi, same)

    def is_on_curve(self, p):
        """3 Y^2 Z == 3 X^3 + 3b Z^3."""
        F = self.F
        y2, x2, z2 = _bmul(F, [(p[1], p[1]), (p[0], p[0]), (p[2], p[2])])
        y2z, x3, z3 = _bmul(F, [(y2, p[2]), (x2, p[0]), (z2, p[2])])
        lhs = F.mul_small(y2z, 3)
        rhs = F.add(F.mul_small(x3, 3), F.mul_small(z3, self.b3_small))
        return F.eq(lhs, rhs) | self.is_inf(p)

    def reduce_sum_lanes(self, pts, axis: int):
        """Tree-reduce points along batch axis `axis` (raw axis axis+1)."""
        pts = tuple(c.movedim(axis + 1, 1) for c in pts)
        n = pts[0].shape[1]
        while n > 1:
            if n % 2 == 1:
                pad = self.inf((1,) + tuple(pts[0].shape[2:]), pts[0].device)
                pts = tuple(torch.cat([c, i], 1)
                            for c, i in zip(pts, pad))
                n += 1
            half = n // 2
            pts = self.add(tuple(c[:, :half] for c in pts),
                           tuple(c[:, half:] for c in pts))
            n = half
        return tuple(c[:, 0] for c in pts)

    def _broadcast(self, p, k_limbs):
        """P's coords (L, *batch) contiguous at the batch of P and k
        together -> (P, the batch shape, k's batch shape)."""
        L, pb, kb = self.F.L, tuple(p[0].shape[1:]), tuple(k_limbs.shape[:-1])
        batch = torch.broadcast_shapes(kb, pb)
        p = tuple(c.reshape((L,) + (1,) * (len(batch) - len(pb)) + pb)
                  .expand((L,) + batch).contiguous() for c in p)
        return p, batch, kb

    def scalar_mul(self, p, k_limbs, w: int = 4):
        """[k] P: k as (..., 16) canonical Fr limbs, P as (L, ...) coords;
        the batch axes of P and k broadcast together.  The windowed
        ladder on the card, the 256-step ladder elsewhere (as
        ``curve/weierstrass.py:_scalar_mul_dispatch``)."""
        if p[0].device.type == "cuda":
            return self.scalar_mul_windowed(p, k_limbs, w)
        return self.scalar_mul_ladder(p, k_limbs)

    def scalar_mul_ladder(self, p, k_limbs):
        """The fixed 256-step MSB-first double-and-add with a branchless
        select (an add every step), as ``weierstrass.py:_scalar_mul``."""
        dev = p[0].device
        p, batch, kb = self._broadcast(p, k_limbs)
        shifts = torch.arange(16, device=dev, dtype=torch.int32)
        bits = (k_limbs.to(device=dev, dtype=torch.int32)[..., None]
                >> shifts) & 1
        bits = bits.reshape(kb + (256,)).movedim(-1, 0).reshape(
            (256,) + (1,) * (len(batch) - len(kb)) + kb)
        bits = (bits == 1).expand((256,) + batch)         # LSB-first rows
        acc = self.inf(batch, dev)
        for i in range(255, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[i], self.add(acc, p), acc)
        return acc

    def scalar_mul_windowed(self, p, k_limbs, w: int = 4):
        """[k] P by the 2^w-window ladder (``weierstrass.py:162-199``):
        the table [0..2^w-1] P from 2^w - 2 adds; then, most significant
        digit first, a run of w doublings (one launch), the digit's
        table entry (one gather) and one add.  A zero scalar gives
        infinity."""
        dev = p[0].device
        L = self.F.L
        d = window_digits(k_limbs.to(dev), w)             # kb + (S,)
        p, batch, kb = self._broadcast(p, k_limbs)
        d = d.movedim(-1, 0).reshape(
            (d.shape[-1],) + (1,) * (len(batch) - len(kb)) + kb).expand(
            (d.shape[-1],) + batch)
        tab = [self.inf(batch, dev), p]
        for _ in range(2, 1 << w):
            tab.append(self.add(tab[-1], p))
        table = torch.stack([torch.stack(t) for t in tab])  # (2^w, 3, L, ..)
        shape = (1, 3, L) + batch
        acc = self.inf(batch, dev)
        for i in range(256 // w - 1, -1, -1):
            acc = self.double_n(acc, w)
            idx = d[i].reshape((1, 1, 1) + batch).expand(shape)
            acc = self.add(acc, tuple(torch.gather(table, 0, idx)[0]))
        return acc

    def normalize(self, p):
        """-> (x, y, is_inf) affine Montgomery; infinity -> (0, 0, True)."""
        zi = self.F.inv(p[2])
        x, y = _bmul(self.F, [(p[0], zi), (p[1], zi)])
        return x, y, self.is_inf(p)


G1_LM = CurveLM(FP_LM)
G1_LM_PLAIN = CurveLM(FP_LM_PLAIN)
