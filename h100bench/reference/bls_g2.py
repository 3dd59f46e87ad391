"""BLS12-381 G2 in plain Python integers: Fp2 = Fp[u] / (u^2 + 1) and the
twist y^2 = x^3 + 4 (1 + u), for the G2 MSM's answers.

Fp2 values are (c0, c1) pairs of ints mod P; points are Jacobian
(X, Y, Z) triples of them, Z == 0 is infinity (dbl-2009-l, add-2007-bl,
as bls.py's G1).  The compressed encoding is the ZCash format (96 bytes:
x's c1 then c0, flag bits in the first byte).
"""

from __future__ import annotations

import numpy as np

from h100bench.reference import kzg
from h100bench.reference.bls import P

G2_X = (0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
        0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E)
G2_Y = (0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
        0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE)
ZERO, ONE = (0, 0), (1, 0)
INF = (ONE, ONE, ZERO)
GEN = (G2_X, G2_Y, ONE)
B = (4, 4)                                   # 4 (1 + u)


def add2(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def sub2(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def mul2(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def small2(k: int, a):
    return (k * a[0] % P, k * a[1] % P)


def inv2(a):
    n = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * n % P, -a[1] * n % P)


def is_zero2(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def double(p):
    X, Y, Z = p
    if is_zero2(Z) or is_zero2(Y):
        return INF
    A = mul2(X, X)
    Bq = mul2(Y, Y)
    C = mul2(Bq, Bq)
    D = small2(2, sub2(sub2(mul2(add2(X, Bq), add2(X, Bq)), A), C))
    E = small2(3, A)
    X3 = sub2(mul2(E, E), small2(2, D))
    Y3 = sub2(mul2(E, sub2(D, X3)), small2(8, C))
    Z3 = small2(2, mul2(Y, Z))
    return (X3, Y3, Z3)


def add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if is_zero2(Z1):
        return q
    if is_zero2(Z2):
        return p
    Z1Z1 = mul2(Z1, Z1)
    Z2Z2 = mul2(Z2, Z2)
    U1 = mul2(X1, Z2Z2)
    U2 = mul2(X2, Z1Z1)
    S1 = mul2(mul2(Y1, Z2), Z2Z2)
    S2 = mul2(mul2(Y2, Z1), Z1Z1)
    if U1 == U2:
        return double(p) if S1 == S2 else INF
    H = sub2(U2, U1)
    I = small2(4, mul2(H, H))
    J = mul2(H, I)
    rr = small2(2, sub2(S2, S1))
    V = mul2(U1, I)
    X3 = sub2(sub2(mul2(rr, rr), J), small2(2, V))
    Y3 = sub2(mul2(rr, sub2(V, X3)), small2(2, mul2(S1, J)))
    Z3 = mul2(sub2(sub2(mul2(add2(Z1, Z2), add2(Z1, Z2)), Z1Z1), Z2Z2), H)
    return (X3, Y3, Z3)


def neg(p):
    return (p[0], sub2(ZERO, p[1]), p[2])


def mul(p, k: int):
    """[k] p for k >= 0: a 4-bit window, most significant digit first."""
    table = [INF, p]
    for _ in range(14):
        table.append(add(table[-1], p))
    acc = INF
    for shift in range(((k.bit_length() + 3) // 4) * 4 - 4, -4, -4):
        for _ in range(4):
            acc = double(acc)
        d = (k >> shift) & 15
        if d:
            acc = add(acc, table[d])
    return acc


_GEN_POW2 = []


def mul_gen(k: int):
    """[k] G2 from a table of [2^i] G2 (k < 2^256)."""
    if not _GEN_POW2:
        q = GEN
        for _ in range(256):
            _GEN_POW2.append(q)
            q = double(q)
    acc = INF
    for i in range(k.bit_length()):
        if (k >> i) & 1:
            acc = add(acc, _GEN_POW2[i])
    return acc


def affine(p):
    """-> ((x0, x1), (y0, y1)), or None for infinity."""
    X, Y, Z = p
    if is_zero2(Z):
        return None
    zi = inv2(Z)
    zi2 = mul2(zi, zi)
    return (mul2(X, zi2), mul2(mul2(Y, zi2), zi))


def on_curve(xy) -> bool:
    x, y = xy
    return sub2(mul2(y, y), add2(mul2(mul2(x, x), x), B)) == ZERO


def compress(p) -> bytes:
    a = affine(p)
    if a is None:
        return bytes([0xC0]) + bytes(95)
    (x0, x1), (y0, y1) = a
    large = (y1, y0) > ((P - y1) % P, (P - y0) % P) if (y0, y1) != ZERO \
        else False
    b = x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
    return bytes([b[0] | 0x80 | (0x20 if large else 0)]) + b[1:]


def from_projective_mont(X, Y, Z):
    """A homogeneous projective point (x = X/Z, y = Y/Z) whose Fp2
    coordinates are all in Montgomery form (each component times 2^384
    mod P) -> affine ((x0, x1), (y0, y1)), or None (Z = 0).  The
    Montgomery factors cancel in X/Z."""
    if is_zero2(Z):
        return None
    zi = inv2(Z)
    return (mul2(X, zi), mul2(Y, zi))


def _fp2_from_limbs(limbs48):
    c = kzg._limbs_to_ints(np.asarray(limbs48).reshape(2, 24))
    return (c[0] % P, c[1] % P)


def point_from_limbs(X48, Y48, Z48):
    """A program's output G2 point, coordinates as 48 16-bit Montgomery
    limbs each (c0's 24, then c1's; homogeneous projective) -> affine or
    None."""
    return from_projective_mont(*(_fp2_from_limbs(c) for c in
                                  (X48, Y48, Z48)))


def msm_answer(k16, s_bytes):
    """The affine point sum_i [k_i] P_i where P_i = [s_i] G2, from the
    scalars' limbs k and the discrete logs s (as kzg.limb_bytes) alone."""
    return affine(mul_gen(kzg.dot_mod_r(kzg.limb_bytes(k16), s_bytes)))
