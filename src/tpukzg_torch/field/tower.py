"""Fp2/Fp6/Fp12 extension tower (counterpart of ``tpukzg/field/tower.py``).

    Fp2  = Fp [u] / (u^2 + 1)
    Fp6  = Fp2[v] / (v^3 - xi),  xi = 1 + u
    Fp12 = Fp6[w] / (w^2 - v)

Layouts (component axes before the limb axis, batch axes lead):
    Fp2: (..., 2, L)    Fp6: (..., 3, 2, L)    Fp12: (..., 2, 3, 2, L)

The same Karatsuba formulas as the JAX package, with the independent
products of each level stacked into one batched Fp product.  Every op
returns canonical limbs, so values match the reference bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.field.mont import FP, P_MOD, upload


def _stack(parts, dim):
    return torch.stack(torch.broadcast_tensors(*parts), dim=dim)


class Fp2Ops:
    # trailing axes of one element: (component, limb)
    suffix_ndim = 2

    def __init__(self, fp=FP):
        self.fp = fp
        L = fp.L
        self.zero_np = np.zeros((2, L), np.int32)
        self.one_np = np.stack([fp.one_mont, np.zeros(L, np.int32)])

    def c(self, a, i):
        return a[..., i, :]

    def build(self, c0, c1):
        return _stack([c0, c1], -2)

    def select(self, mask, a, b):
        return torch.where(mask[..., None, None], a, b)

    def eq(self, a, b):
        return (a == b).all(-1).all(-1)

    def is_zero(self, a):
        return (a == 0).all(-1).all(-1)

    # linear ops: the Fp op broadcasts over the component axis
    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def double(self, a):
        return self.fp.add(a, a)

    def mul_small(self, a, k: int):
        return self.fp.mul_small(a, k)

    def conj(self, a):
        return self.build(self.c(a, 0), self.fp.neg(self.c(a, 1)))

    def mul_by_nonresidue(self, a):
        """a * (1 + u) = (a0 - a1) + (a0 + a1) u."""
        a0, a1 = self.c(a, 0), self.c(a, 1)
        return self.build(self.fp.sub(a0, a1), self.fp.add(a0, a1))

    def mul(self, a, b):
        fp = self.fp
        a0, a1 = self.c(a, 0), self.c(a, 1)
        b0, b1 = self.c(b, 0), self.c(b, 1)
        lhs = _stack([a0, a1, fp.add(a0, a1)], -2)
        rhs = _stack([b0, b1, fp.add(b0, b1)], -2)
        t = fp.mul(lhs, rhs)
        t0, t1, t2 = t[..., 0, :], t[..., 1, :], t[..., 2, :]
        # (t0 - t1, t2 - t0 - t1) as two subtractions of stacked pairs
        d = fp.sub(_stack([t0, t2], -2), _stack([t1, t0], -2))
        return self.build(d[..., 0, :], fp.sub(d[..., 1, :], t1))

    def sqr(self, a):
        fp = self.fp
        a0, a1 = self.c(a, 0), self.c(a, 1)
        lhs = _stack([fp.add(a0, a1), a0], -2)
        rhs = _stack([fp.sub(a0, a1), a1], -2)
        t = fp.mul(lhs, rhs)
        return self.build(t[..., 0, :], fp.add(t[..., 1, :], t[..., 1, :]))

    def mul_fp(self, a, s):
        return self.fp.mul(a, s[..., None, :])

    def inv(self, a):
        fp = self.fp
        a0, a1 = self.c(a, 0), self.c(a, 1)
        t = fp.mul(a, a)
        norm = fp.add(t[..., 0, :], t[..., 1, :])
        d = fp.inv(norm)
        return self.build(fp.mul(a0, d), fp.neg(fp.mul(a1, d)))


class Fp6Ops:
    def __init__(self, fp2: Fp2Ops):
        self.fp2 = fp2
        self.fp = fp2.fp
        self.zero_np = np.zeros((3, 2, self.fp.L), np.int32)
        self.one_np = np.stack([fp2.one_np, fp2.zero_np, fp2.zero_np])

    def c(self, a, i):
        return a[..., i, :, :]

    def build(self, c0, c1, c2):
        return _stack([c0, c1, c2], -3)

    def add(self, a, b):
        return self.fp.add(a, b)

    def sub(self, a, b):
        return self.fp.sub(a, b)

    def neg(self, a):
        return self.fp.neg(a)

    def mul_by_v(self, a):
        """(c0, c1, c2) * v = (xi c2, c0, c1)."""
        return self.build(self.fp2.mul_by_nonresidue(self.c(a, 2)),
                          self.c(a, 0), self.c(a, 1))

    def mul(self, a, b):
        f2 = self.fp2
        a0, a1, a2 = (self.c(a, i) for i in range(3))
        b0, b1, b2 = (self.c(b, i) for i in range(3))
        # the three pair sums of each side in one addition
        sa = f2.add(_stack([a1, a0, a0], -3), _stack([a2, a1, a2], -3))
        sb = f2.add(_stack([b1, b0, b0], -3), _stack([b2, b1, b2], -3))
        v = f2.mul(torch.cat([a, sa], -3), torch.cat([b, sb], -3))
        v0, v1, v2 = v[..., 0, :, :], v[..., 1, :, :], v[..., 2, :, :]
        m12, m01, m02 = v[..., 3, :, :], v[..., 4, :, :], v[..., 5, :, :]
        # m12 - v1 - v2, m01 - v0 - v1, m02 - v0 - v2 as two stacked subs
        d = f2.sub(f2.sub(_stack([m12, m01, m02], -3),
                          _stack([v1, v0, v0], -3)),
                   _stack([v2, v1, v2], -3))
        c0 = f2.add(v0, f2.mul_by_nonresidue(d[..., 0, :, :]))
        c12 = f2.add(d[..., 1:, :, :],
                     _stack([f2.mul_by_nonresidue(v2), v1], -3))
        return torch.cat([c0.unsqueeze(-3), c12], -3)

    def inv(self, a):
        f2 = self.fp2
        a0, a1, a2 = (self.c(a, i) for i in range(3))
        sq = f2.sqr(a)
        s0, s1, s2 = sq[..., 0, :, :], sq[..., 1, :, :], sq[..., 2, :, :]
        pr = f2.mul(_stack([a1, a0, a0], -3), _stack([a2, a1, a2], -3))
        p12, p01, p02 = pr[..., 0, :, :], pr[..., 1, :, :], pr[..., 2, :, :]
        c0 = f2.sub(s0, f2.mul_by_nonresidue(p12))
        c1 = f2.sub(f2.mul_by_nonresidue(s2), p01)
        c2 = f2.sub(s1, p02)
        den_terms = f2.mul(a, _stack([c0, c2, c1], -3))
        den = f2.add(den_terms[..., 0, :, :], f2.mul_by_nonresidue(
            f2.add(den_terms[..., 1, :, :], den_terms[..., 2, :, :])))
        d = f2.inv(den)
        return f2.mul(self.build(c0, c1, c2), d[..., None, :, :])


class Fp12Ops:
    def __init__(self, fp6: Fp6Ops):
        self.fp6 = fp6
        self.fp2 = fp6.fp2
        self.fp = fp6.fp
        self.one_np = np.stack([fp6.one_np, fp6.zero_np])
        self._frob = _frobenius_tables(self.fp)
        self._consts = {}

    def _const(self, key, arr, device):
        k = (key, str(device))
        t = self._consts.get(k)
        if t is None:
            t = upload(arr, device, torch.int32)
            self._consts[k] = t
        return t

    def one(self, batch_shape, device):
        return self._const("one", self.one_np, device).expand(
            tuple(batch_shape) + self.one_np.shape)

    def c(self, a, i):
        return a[..., i, :, :, :]

    def build(self, c0, c1):
        return _stack([c0, c1], -4)

    def select(self, mask, a, b):
        return torch.where(mask[..., None, None, None, None], a, b)

    def eq(self, a, b):
        return (a == b).flatten(-4).all(-1)

    def conj(self, a):
        return self.build(self.c(a, 0), self.fp.neg(self.c(a, 1)))

    def mul(self, a, b):
        f6 = self.fp6
        a0, a1 = self.c(a, 0), self.c(a, 1)
        b0, b1 = self.c(b, 0), self.c(b, 1)
        s = f6.add(_stack([a0, b0], -4), _stack([a1, b1], -4))
        lhs = _stack([a0, a1, s[..., 0, :, :, :]], -4)
        rhs = _stack([b0, b1, s[..., 1, :, :, :]], -4)
        v = f6.mul(lhs, rhs)
        v0, v1, m = v[..., 0, :, :, :], v[..., 1, :, :, :], v[..., 2, :, :, :]
        c0 = f6.add(v0, f6.mul_by_v(v1))
        c1 = f6.sub(m, f6.add(v0, v1))
        return self.build(c0, c1)

    def sqr(self, a):
        f6 = self.fp6
        a0, a1 = self.c(a, 0), self.c(a, 1)
        s = f6.add(_stack([a0, a0], -4), _stack([a1, f6.mul_by_v(a1)], -4))
        v = f6.mul(_stack([s[..., 0, :, :, :], a0], -4),
                   _stack([s[..., 1, :, :, :], a1], -4))
        t, m = v[..., 0, :, :, :], v[..., 1, :, :, :]
        c0 = f6.sub(t, f6.add(m, f6.mul_by_v(m)))
        c1 = f6.add(m, m)
        return self.build(c0, c1)

    def inv(self, a):
        f6 = self.fp6
        sq = f6.mul(a, a)
        den = f6.sub(sq[..., 0, :, :, :], f6.mul_by_v(sq[..., 1, :, :, :]))
        d = f6.inv(den)
        num = f6.mul(self.build(self.c(a, 0), f6.neg(self.c(a, 1))),
                     d[..., None, :, :, :])
        return num

    def cyclotomic_sqr(self, a):
        """Granger-Scott squaring (valid after the easy part)."""
        f2 = self.fp2
        z = [a[..., k % 2, k // 2, :, :] for k in range(6)]
        c0s = _stack([z[0], z[1], z[2]], -3)
        c1s = _stack([z[3], z[4], z[5]], -3)
        s = f2.sqr(torch.cat([c0s, c1s, f2.add(c0s, c1s)], -3))
        s0, s1, sv = s[..., 0:3, :, :], s[..., 3:6, :, :], s[..., 6:9, :, :]
        t0 = f2.add(s0, f2.mul_by_nonresidue(s1))        # c0^2 + xi c1^2
        t1 = f2.sub(sv, f2.add(s0, s1))                  # 2 c0 c1
        tA0, tB0, tC0 = t0[..., 0, :, :], t0[..., 1, :, :], t0[..., 2, :, :]
        tA1, tB1, tC1 = t1[..., 0, :, :], t1[..., 1, :, :], t1[..., 2, :, :]
        tC1x = f2.mul_by_nonresidue(tC1)
        # outputs 3t - 2z (minus group) and 3t + 2z (plus group), batched
        tm = _stack([tA0, tB0, tC0], -3)
        zm = _stack([z[0], z[2], z[4]], -3)
        tp = _stack([tA1, tB1, tC1x], -3)
        zp = _stack([z[3], z[5], z[1]], -3)
        dm = f2.sub(tm, zm)
        dp = f2.add(tp, zp)
        d = torch.cat([dm, dp], -3)
        tt = torch.cat([tm, tp], -3)
        o = f2.add(f2.add(d, d), tt)
        o0, o2, o4 = o[..., 0, :, :], o[..., 1, :, :], o[..., 2, :, :]
        o3, o5, o1 = o[..., 3, :, :], o[..., 4, :, :], o[..., 5, :, :]
        return self.build(_stack([o0, o2, o4], -3), _stack([o1, o3, o5], -3))

    def frobenius(self, a, n: int):
        assert n in (1, 2, 3)
        f2 = self.fp2
        # component (i, j) holds the w^(i + 2j) coefficient: the (6, 2, L)
        # table reordered on the host, so no index list goes to the device
        order = [i + 2 * j for i in range(2) for j in range(3)]
        g = self._const(("frob", n), self._frob[n][order].reshape(
            2, 3, 2, self.fp.L), a.device)
        d = f2.conj(a) if n % 2 == 1 else a
        return f2.mul(d, g)


def _frobenius_tables(fp):
    """gamma[n][k] = xi^(k (p^n - 1)/6), Montgomery form, (6, 2, L)."""
    p = P_MOD

    def fp2_mul_int(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    def fp2_pow_int(a, e):
        result, base = (1, 0), a
        while e:
            if e & 1:
                result = fp2_mul_int(result, base)
            base = fp2_mul_int(base, base)
            e >>= 1
        return result

    tables = {}
    for n in (1, 2, 3):
        base = fp2_pow_int((1, 1), (p ** n - 1) // 6)
        row, acc = [], (1, 0)
        for _ in range(6):
            row.append(np.stack([fp.to_mont_host(acc[0]),
                                 fp.to_mont_host(acc[1])]))
            acc = fp2_mul_int(acc, base)
        tables[n] = np.stack(row)
    return tables


FP2 = Fp2Ops(FP)
FP6 = Fp6Ops(FP2)
FP12 = Fp12Ops(FP6)
