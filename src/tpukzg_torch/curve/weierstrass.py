"""Complete projective group law for y^2 = x^3 + b (a = 0) over a field
in the trailing layout (counterpart of ``tpukzg/curve/weierstrass.py:
26-148, 242-282``).

Points are (X, Y, Z) tuples of (..., *suffix) tensors, batch axes
leading; the field is any ops object with ``suffix_ndim`` trailing axes
(``Fp2Ops``: (..., 2, 24)).  The formulas are RCB15 Alg. 7 (add) and
Alg. 9 (double), parametrised by ``b3_mul`` (x -> 3 b x), with the
independent products of a step stacked into one batched field product.
Field results are canonical, so every output equals the JAX package's
bit for bit.  This is tensor code: the JAX package has no kernel for
these curves (G2); its Fp products go through the montmul kernel on the
card.
"""

from __future__ import annotations

import numpy as np
import torch


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

    def scalar_mul(self, p, k_limbs):
        """[k] P, k as (..., 16) canonical Fr limbs; batch axes of P and k
        broadcast.  The fixed 256-step MSB-first double-and-add with a
        branchless select, as the JAX package's ``_scalar_mul``."""
        sfx = self.F.suffix_ndim
        dev = p[0].device
        pb = tuple(p[0].shape[:p[0].dim() - sfx])
        kb = tuple(k_limbs.shape[:-1])
        batch = torch.broadcast_shapes(kb, pb)
        p = tuple(c.expand(batch + tuple(c.shape[c.dim() - sfx:]))
                  for c in p)
        shifts = torch.arange(16, device=dev, dtype=torch.int32)
        bits = (k_limbs.to(device=dev, dtype=torch.int32)[..., None]
                >> shifts) & 1
        bits = (bits.reshape(kb + (256,)) == 1).expand(batch + (256,))
        acc = self.inf(batch, dev)
        for i in range(255, -1, -1):
            acc = self.double(acc)
            acc = self.select(bits[..., i], self.add(acc, p), acc)
        return acc

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
