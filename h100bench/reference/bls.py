"""BLS12-381 Fp, Fr and G1 in plain Python integers.

Points are Jacobian (X, Y, Z) triples of ints mod P; Z == 0 is infinity.
Formulas for a = 0: dbl-2009-l, add-2007-bl, madd-2007-bl.  The compressed
encoding is the ZCash format that EIP-4844 uses (48 bytes, flag bits in
the first byte).
"""

from __future__ import annotations

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
# a primitive 2^32-th root of unity of Fr: 7^((r - 1) / 2^32)
OMEGA_2_32 = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B

INF = (1, 1, 0)
GEN = (G1_X, G1_Y, 1)
_HALF = (P - 1) // 2


def fr_omega(n: int) -> int:
    """A primitive n-th root of unity of Fr (n a power of two <= 2^32)."""
    w, order = OMEGA_2_32, 1 << 32
    while order > n:
        w = w * w % R
        order >>= 1
    return w


def fp_sqrt(a: int):
    """A square root mod P (P = 3 mod 4), or None."""
    s = pow(a, (P + 1) // 4, P)
    return s if s * s % P == a % P else None


def double(p):
    X, Y, Z = p
    if Z == 0 or Y == 0:
        return INF
    A = X * X % P
    B = Y * Y % P
    C = B * B % P
    D = 2 * ((X + B) * (X + B) - A - C) % P
    E = 3 * A % P
    X3 = (E * E - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y * Z % P
    return (X3, Y3, Z3)


def add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        return double(p) if S1 == S2 else INF
    H = (U2 - U1) % P
    I = 4 * H * H % P
    J = H * I % P
    rr = 2 * (S2 - S1) % P
    V = U1 * I % P
    X3 = (rr * rr - J - 2 * V) % P
    Y3 = (rr * (V - X3) - 2 * S1 * J) % P
    Z3 = ((Z1 + Z2) * (Z1 + Z2) - Z1Z1 - Z2Z2) * H % P
    return (X3, Y3, Z3)


def neg(p):
    return (p[0], -p[1] % P, p[2])


def mul(p, k: int):
    """[k] p for k >= 0, not reduced mod r (the subgroup check multiplies
    by r itself): a 4-bit window, most significant digit first."""
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
    """[k] G1 from a table of [2^i] G1 (k < 2^256)."""
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
    """-> (x, y) ints, or None for infinity."""
    X, Y, Z = p
    if Z % P == 0:
        return None
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 * zi % P)


def on_curve(xy) -> bool:
    x, y = xy
    return (y * y - x * x * x - 4) % P == 0


def in_g1(p) -> bool:
    """On the curve and of order dividing r."""
    a = affine(p)
    return a is None or (on_curve(a) and mul(p, R)[2] % P == 0)


def compress(p) -> bytes:
    a = affine(p)
    if a is None:
        return bytes([0xC0]) + bytes(47)
    x, y = a
    b = x.to_bytes(48, "big")
    return bytes([b[0] | 0x80 | (0x20 if y > _HALF else 0)]) + b[1:]


def decompress(data: bytes):
    """48 bytes -> a Jacobian point on the curve (not checked for G1), or
    None where the bytes encode no point of the curve."""
    if len(data) != 48 or not data[0] & 0x80:
        return None
    if data[0] & 0x40:
        ok = not (data[0] & 0x3F) and not any(data[1:])
        return INF if ok else None
    x = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:], "big")
    if x >= P:
        return None
    y = fp_sqrt((x * x * x + 4) % P)
    if y is None:
        return None
    if (y > _HALF) != bool(data[0] & 0x20):
        y = P - y
    return (x, y, 1)


def from_projective_mont(X: int, Y: int, Z: int):
    """A homogeneous projective point (x = X/Z, y = Y/Z) whose coordinates
    are all in Montgomery form (times 2^384 mod P) -> affine (x, y), or
    None for infinity (Z = 0).  The Montgomery factors cancel in X/Z."""
    if Z % P == 0:
        return None
    zi = pow(Z, -1, P)
    return (X * zi % P, Y * zi % P)
