"""Complete projective group law for y^2 = x^3 + b (a = 0) over a field
in the trailing layout (counterpart of ``tpukzg/curve/weierstrass.py``).

Points are (X, Y, Z) tuples of (..., *suffix) tensors, batch axes
leading; the field is any ops object with ``suffix_ndim`` trailing axes
(``Fp2Ops``: (..., 2, 24)).  The formulas are RCB15 Alg. 7 (add) and
Alg. 9 (double), parametrised by ``b3_mul`` (x -> 3 b x), with the
independent products of a step stacked into one batched field product.
Field results are canonical, so every output equals the JAX package's
bit for bit.  This is tensor code: the JAX package has no kernel for
these curves (G2); its Fp products go through the montmul kernel on the
card.  ``curve/g1.py``'s G1 routes its adds and doubling runs to the EC
kernels.

Scalar multiplication dispatches as ``_scalar_mul_dispatch``: on the
card the 2^w-window ladder (256/w steps of w doublings, a table select
and one add: ~334 EC ops at w = 4 instead of 512), on the CPU the
256-step ladder, so the CPU results keep the JAX CPU path's projective
coordinates.  Both give the same points after normalising.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.field.mont import R_MOD


def window_digits(k_limbs, w: int):
    """(..., 16) canonical 16-bit limbs -> (..., 256 // w) int64 digits of
    w bits, least significant first (``weierstrass.py:175-178``)."""
    if 16 % w:
        raise ValueError(f"window {w} does not divide the 16-bit limb")
    shifts = torch.arange(0, 16, w, device=k_limbs.device, dtype=torch.int64)
    d = (k_limbs.to(torch.int64)[..., None] >> shifts) & ((1 << w) - 1)
    return d.reshape(k_limbs.shape[:-1] + (256 // w,))


class CurveOps:
    def __init__(self, name: str, field, b3_mul, gen_affine_np):
        """field: trailing-layout field ops; b3_mul: x -> 3 b x;
        gen_affine_np: the generator's (x, y) Montgomery limb arrays."""
        self.name = name
        self.F = field
        self.b3_mul = b3_mul
        one = np.asarray(field.one_np, np.int32)
        zero = np.asarray(field.zero_np, np.int32)
        self.inf_np = (zero, one, zero)
        self.gen_np = (np.asarray(gen_affine_np[0], np.int32),
                       np.asarray(gen_affine_np[1], np.int32), one)

    # ---- constructors ----

    @staticmethod
    def _const(coords, batch_shape, device):
        return tuple(torch.as_tensor(c, device=device).expand(
            tuple(batch_shape) + c.shape) for c in coords)

    def inf(self, batch_shape, device):
        return self._const(self.inf_np, batch_shape, device)

    def gen(self, batch_shape, device):
        return self._const(self.gen_np, batch_shape, device)

    def _bmul(self, pairs):
        ax = -(self.F.suffix_ndim + 1)
        lhs = torch.stack(torch.broadcast_tensors(*[a for a, _ in pairs]), ax)
        rhs = torch.stack(torch.broadcast_tensors(*[b for _, b in pairs]), ax)
        prod = self.F.mul(lhs, rhs)
        return list(prod.unbind(ax))

    # ---- group law ----

    def add(self, p, q):
        """RCB15 Algorithm 7 (a = 0): 12 products, complete."""
        F = self.F
        X1, Y1, Z1 = p
        X2, Y2, Z2 = q
        t0, t1, t2, t3, t4, t5 = self._bmul([
            (X1, X2), (Y1, Y2), (Z1, Z2),
            (F.add(X1, Y1), F.add(X2, Y2)),
            (F.add(Y1, Z1), F.add(Y2, Z2)),
            (F.add(X1, Z1), F.add(X2, Z2)),
        ])
        t3 = F.sub(t3, F.add(t0, t1))
        t4 = F.sub(t4, F.add(t1, t2))
        t5 = F.sub(t5, F.add(t0, t2))
        t0 = F.add(F.add(t0, t0), t0)
        t2 = self.b3_mul(t2)
        z3 = F.add(t1, t2)
        t1 = F.sub(t1, t2)
        y3 = self.b3_mul(t5)
        m0, m1, m2, m3, m4, m5 = self._bmul([
            (t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4),
        ])
        return (F.sub(m1, m0), F.add(m3, m2), F.add(m5, m4))

    def double(self, p):
        """RCB15 Algorithm 9 (a = 0), complete."""
        F = self.F
        X, Y, Z = p
        t0, t1, t2, t3 = self._bmul([(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        z8 = F.add(t0, t0)
        z8 = F.add(z8, z8)
        z8 = F.add(z8, z8)
        t2 = self.b3_mul(t2)
        t6 = F.sub(t0, F.add(F.add(t2, t2), t2))
        y3t = F.add(t0, t2)
        m0, m1, m2, m3 = self._bmul([(t2, z8), (t1, z8), (t6, y3t),
                                     (t6, t3)])
        return (F.add(m3, m3), F.add(m2, m0), m1)

    def neg(self, p):
        X, Y, Z = p
        return (X, self.F.neg(Y), Z)

    def select(self, mask, p, q):
        return tuple(self.F.select(mask, a, b) for a, b in zip(p, q))

    def double_n(self, p, t: int):
        """[2^t] P: t doublings (t = 0 returns P)."""
        for _ in range(t):
            p = self.double(p)
        return p

    def _broadcast(self, p, k_limbs):
        """P's coords expanded to the batch of P and k together -> (P,
        the batch shape, k's batch shape)."""
        sfx = self.F.suffix_ndim
        pb = tuple(p[0].shape[:p[0].dim() - sfx])
        kb = tuple(k_limbs.shape[:-1])
        batch = torch.broadcast_shapes(kb, pb)
        return (tuple(c.expand(batch + tuple(c.shape[c.dim() - sfx:]))
                      for c in p), batch, kb)

    def scalar_mul(self, p, k_limbs, w: int = 4):
        """[k] P, k as (..., 16) canonical Fr limbs; batch axes of P and
        k broadcast.  The windowed ladder on the card, the 256-step
        ladder elsewhere (``weierstrass.py:150-160``)."""
        if p[0].device.type == "cuda":
            return self.scalar_mul_windowed(p, k_limbs, w)
        return self.scalar_mul_ladder(p, k_limbs)

    def scalar_mul_ladder(self, p, k_limbs):
        """The fixed 256-step MSB-first double-and-add with a branchless
        select, as the JAX package's ``_scalar_mul``."""
        dev = p[0].device
        p, batch, kb = self._broadcast(p, k_limbs)
        shifts = torch.arange(16, device=dev, dtype=torch.int32)
        bits = (k_limbs.to(device=dev, dtype=torch.int32)[..., None]
                >> shifts) & 1
        bits = (bits.reshape(kb + (256,)) == 1).expand(batch + (256,))
        acc = self.inf(batch, dev)
        for i in range(255, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[..., i], self.add(acc, p), acc)
        return acc

    def scalar_mul_windowed(self, p, k_limbs, w: int = 4):
        """[k] P by the 2^w-window ladder (``weierstrass.py:162-199``):
        the table [0..2^w-1] P from 2^w - 2 adds, then, most significant
        digit first, w doublings, the table entry of the digit (one
        gather) and one add.  A zero scalar gives infinity."""
        dev = p[0].device
        sfx = self.F.suffix_ndim
        d = window_digits(k_limbs.to(dev), w)
        p, batch, _ = self._broadcast(p, k_limbs)
        d = d.expand(batch + (256 // w,))
        tab = [self.inf(batch, dev), p]
        for _ in range(2, 1 << w):
            tab.append(self.add(tab[-1], p))
        table = torch.stack([torch.stack(t) for t in tab])  # (2^w, 3, ...)
        shape = (1, 3) + tuple(table.shape[2:])
        acc = self.inf(batch, dev)
        for i in range(256 // w - 1, -1, -1):
            acc = self.double_n(acc, w)
            idx = d[..., i].reshape((1, 1) + batch + (1,) * sfx)
            acc = self.add(acc, tuple(torch.gather(
                table, 0, idx.expand(shape))[0]))
        return acc

    def mul_int(self, p, k: int):
        """[k] P for a small Python int k (double-and-add, unrolled)."""
        acc, doubled = None, p
        while k:
            if k & 1:
                acc = doubled if acc is None else self.add(acc, doubled)
            k >>= 1
            if k:
                doubled = self.double(doubled)
        if acc is None:
            sfx = self.F.suffix_ndim
            return self.inf(tuple(p[0].shape[:p[0].dim() - sfx]),
                            p[0].device)
        return acc

    # ---- reductions / MSM ----

    def reduce_sum(self, pts, axis: int = 0):
        """Tree sum of the points along batch axis `axis`."""
        pts = tuple(c.movedim(axis, 0) for c in pts)
        n = pts[0].shape[0]
        while n > 1:
            if n % 2 == 1:
                sfx = self.F.suffix_ndim
                pad = self.inf((1,) + tuple(
                    pts[0].shape[1:pts[0].dim() - sfx]), pts[0].device)
                pts = tuple(torch.cat([c, i], 0) for c, i in zip(pts, pad))
                n += 1
            half = n // 2
            pts = self.add(tuple(c[:half] for c in pts),
                           tuple(c[half:] for c in pts))
            n = half
        return tuple(c[0] for c in pts)

    def msm_naive(self, pts, scalars):
        """sum_i [k_i] P_i: the batched scalar multiplication, then a
        tree sum (the correctness baseline of the Pippenger MSMs)."""
        return self.reduce_sum(self.scalar_mul(pts, scalars), axis=0)

    # ---- predicates / normalisation ----

    def is_inf(self, p):
        return self.F.is_zero(p[2])

    def eq(self, p, q):
        """Projective equality, cross-multiplied, infinity-aware."""
        F = self.F
        a, b, c, d = self._bmul([(p[0], q[2]), (q[0], p[2]),
                                 (p[1], q[2]), (q[1], p[2])])
        same = F.eq(a, b) & F.eq(c, d)
        pi, qi = self.is_inf(p), self.is_inf(q)
        return torch.where(pi | qi, pi == qi, same)

    def normalize(self, p):
        """-> (x, y, is_inf) affine Montgomery; infinity -> (0, 0, True)."""
        zi = self.F.inv(p[2])
        x, y = self._bmul([(p[0], zi), (p[1], zi)])
        return x, y, self.is_inf(p)

    def is_on_curve(self, p):
        """3 Y^2 Z == 3 X^3 + 3b Z^3 (infinity counts as on the curve)."""
        F = self.F
        y2, x2, z2 = self._bmul([(p[1], p[1]), (p[0], p[0]), (p[2], p[2])])
        y2z, x3, z3 = self._bmul([(y2, p[2]), (x2, p[0]), (z2, p[2])])
        lhs = F.add(F.add(y2z, y2z), y2z)
        rhs = F.add(F.add(F.add(x3, x3), x3), self.b3_mul(z3))
        return F.eq(lhs, rhs) | self.is_inf(p)

    def in_subgroup(self, p):
        """[r] P == infinity (r the order of G1 and G2), P on the curve:
        the 255-step chain of the bits of r, most significant first."""
        acc = self.inf(tuple(p[0].shape[:p[0].dim() - self.F.suffix_ndim]),
                       p[0].device)
        for bit in bin(R_MOD)[2:]:
            acc = self.double(acc)
            if bit == "1":
                acc = self.add(acc, p)
        return self.is_inf(acc) & self.is_on_curve(p)
