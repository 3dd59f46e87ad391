"""G2: E'(Fp2) y^2 = x^3 + 4(1 + u) — the group law, the psi subgroup
check and the 96-byte codec (counterpart of ``tpukzg/curve/g2.py``).

Points are (X, Y, Z) tuples of (..., 2, 24) int32 Montgomery tensors.
The codec follows the ZCash convention: x = x_c1 || x_c0, the sign bit
lexicographic on (c1, c0).  Decompression and the setup loader's
subgroup check are host integer code (once per setup); the group law
and ``in_subgroup_psi`` are batched tensor code on the points' device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.curve.weierstrass import CurveOps
from tpukzg_torch.field.mont import FP, P_MOD
from tpukzg_torch.field.tower import FP2

G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

X_BLS_ABS = 0xD201000000010000          # |x|; the BLS parameter is -|x|


def fp2_from_ints(c0: int, c1: int) -> np.ndarray:
    """-> (2, 24) int32 Montgomery limbs."""
    return np.stack([FP.to_mont_host(c0), FP.to_mont_host(c1)])


def fp2_to_ints(a):
    """(2, 24) Montgomery limbs (array or tensor) -> (c0, c1) ints."""
    a = FP.from_mont(torch.as_tensor(np.asarray(
        a.cpu() if torch.is_tensor(a) else a)))
    return FP.to_int(a[..., 0, :]), FP.to_int(a[..., 1, :])


def _b3_mul(x):
    """3b x with 3b = 12 (1 + u)."""
    return FP2.mul_small(FP2.mul_by_nonresidue(x), 12)


G2 = CurveOps("G2", FP2, b3_mul=_b3_mul,
              gen_affine_np=(fp2_from_ints(G2_X0, G2_X1),
                             fp2_from_ints(G2_Y0, G2_Y1)))


# ---------------------------------------------------------------------------
# psi subgroup check: psi(X : Y : Z) = (cx X^p : cy Y^p : Z^p) with
# cx = xi^-((p-1)/3), cy = xi^-((p-1)/2), xi = 1 + u; Q is in the order-r
# subgroup iff psi(Q) = [x] Q for the negative BLS parameter x.
# ---------------------------------------------------------------------------


def _fp2_int_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P_MOD,
            (a[0] * b[1] + a[1] * b[0]) % P_MOD)


def _fp2_int_pow(a, e):
    r, b = (1, 0), a
    while e:
        if e & 1:
            r = _fp2_int_mul(r, b)
        b = _fp2_int_mul(b, b)
        e >>= 1
    return r


def _fp2_int_inv(a):
    n = (a[0] * a[0] + a[1] * a[1]) % P_MOD
    ninv = pow(n, -1, P_MOD)
    return (a[0] * ninv % P_MOD, (-a[1]) * ninv % P_MOD)


PSI_CX = _fp2_int_inv(_fp2_int_pow((1, 1), (P_MOD - 1) // 3))
PSI_CY = _fp2_int_inv(_fp2_int_pow((1, 1), (P_MOD - 1) // 2))
_PSI_NP = (fp2_from_ints(*PSI_CX), fp2_from_ints(*PSI_CY))
_X_BITS_LSB = [(X_BLS_ABS >> i) & 1 for i in range(64)]


def psi(p):
    """psi on projective (X, Y, Z) coords (batched)."""
    cx, cy = (torch.as_tensor(c, device=p[0].device) for c in _PSI_NP)
    X, Y, Z = p
    return (FP2.mul(FP2.conj(X), cx), FP2.mul(FP2.conj(Y), cy),
            FP2.conj(Z))


def _mul_abs_x(p):
    """[|x|] P by the 64-step ladder (MSB first); the bits are static, so
    the add runs only where one is set (the value of the reference's
    select)."""
    acc = G2.inf(tuple(p[0].shape[:-2]), p[0].device)
    for bit in _X_BITS_LSB[::-1]:
        acc = G2.double(acc)
        if bit:
            acc = G2.add(acc, p)
    return acc


def in_subgroup_psi(p):
    """psi(P) == [x] P == -[|x|] P, and P on the curve: (...,) bool."""
    return G2.eq(psi(p), G2.neg(_mul_abs_x(p))) & G2.is_on_curve(p)


def in_subgroup_host(x0: int, x1: int, y0: int, y1: int,
                     is_inf: bool = False) -> bool:
    """The psi check in affine host integers (the setup loader's check
    of [tau]_2: microseconds a point, no device work)."""
    if is_inf:
        return True

    def add(pq, rs):
        if pq is None:
            return rs
        if rs is None:
            return pq
        (px, py), (rx, ry) = pq, rs
        if px == rx:
            if (py[0] + ry[0]) % P_MOD == 0 and (py[1] + ry[1]) % P_MOD == 0:
                return None
            num = _fp2_int_mul((3, 0), _fp2_int_mul(px, px))
            den = _fp2_int_inv(((2 * py[0]) % P_MOD, (2 * py[1]) % P_MOD))
        else:
            num = ((ry[0] - py[0]) % P_MOD, (ry[1] - py[1]) % P_MOD)
            den = _fp2_int_inv(((rx[0] - px[0]) % P_MOD,
                                (rx[1] - px[1]) % P_MOD))
        lam = _fp2_int_mul(num, den)
        x3 = _fp2_int_mul(lam, lam)
        x3 = ((x3[0] - px[0] - rx[0]) % P_MOD,
              (x3[1] - px[1] - rx[1]) % P_MOD)
        y3 = _fp2_int_mul(lam, ((px[0] - x3[0]) % P_MOD,
                                (px[1] - x3[1]) % P_MOD))
        return (x3, ((y3[0] - py[0]) % P_MOD, (y3[1] - py[1]) % P_MOD))

    pt = ((x0 % P_MOD, x1 % P_MOD), (y0 % P_MOD, y1 % P_MOD))
    lhs = _fp2_int_mul(pt[1], pt[1])
    rhs = _fp2_int_mul(_fp2_int_mul(pt[0], pt[0]), pt[0])
    if lhs != ((rhs[0] + 4) % P_MOD, (rhs[1] + 4) % P_MOD):
        return False
    acc, dbl, k = None, pt, X_BLS_ABS
    while k:
        if k & 1:
            acc = add(acc, dbl)
        k >>= 1
        if k:
            dbl = add(dbl, dbl)
    if acc is None:
        return False
    neg_acc = (acc[0], ((-acc[1][0]) % P_MOD, (-acc[1][1]) % P_MOD))
    px = _fp2_int_mul(PSI_CX, (pt[0][0], (-pt[0][1]) % P_MOD))
    py = _fp2_int_mul(PSI_CY, (pt[1][0], (-pt[1][1]) % P_MOD))
    return (px, py) == neg_acc


# ---------------------------------------------------------------------------
# integers <-> points, and the 96-byte codec
# ---------------------------------------------------------------------------


def point_from_ints(x0, x1, y0, y1, is_inf: bool = False):
    """Affine ints -> (X, Y, Z) of (2, 24) int32 Montgomery arrays."""
    if is_inf:
        return tuple(np.asarray(c) for c in G2.inf_np)
    return (fp2_from_ints(x0, x1), fp2_from_ints(y0, y1),
            np.asarray(FP2.one_np))


def point_to_ints(p):
    """One point ((2, 24) coords) -> ((x0, x1), (y0, y1), is_inf)."""
    x, y, inf = G2.normalize(tuple(torch.as_tensor(c) for c in p))
    return fp2_to_ints(x), fp2_to_ints(y), bool(inf)


def _is_large(y0: int, y1: int) -> bool:
    if (y0, y1) == (0, 0):
        return False
    return (y1, y0) > ((P_MOD - y1) % P_MOD, (P_MOD - y0) % P_MOD)


def compress(x0: int, x1: int, y0: int, y1: int, is_inf: bool) -> bytes:
    if is_inf:
        return bytes([0xC0]) + bytes(95)
    flags = 0x80 | (0x20 if _is_large(y0, y1) else 0)
    b = x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
    return bytes([b[0] | flags]) + b[1:]


def compress_point(p) -> bytes:
    (x0, x1), (y0, y1), inf = point_to_ints(p)
    return compress(x0, x1, y0, y1, inf)


def _fp_sqrt_int(a: int):
    if a == 0:
        return 0
    s = pow(a, (P_MOD + 1) // 4, P_MOD)
    return s if (s * s) % P_MOD == a % P_MOD else None


def _fp2_sqrt_ints(c0: int, c1: int):
    """A square root in Fp2 by the norm (p = 3 mod 4); None for a
    non-residue."""
    if c0 == 0 and c1 == 0:
        return 0, 0
    if c1 == 0:
        s = _fp_sqrt_int(c0)
        if s is not None:
            return s, 0
        return 0, _fp_sqrt_int((-c0) % P_MOD)
    n = (c0 * c0 + c1 * c1) % P_MOD
    s = _fp_sqrt_int(n)
    if s is None:
        return None
    inv2 = pow(2, -1, P_MOD)
    x0 = _fp_sqrt_int((c0 + s) * inv2 % P_MOD)
    if x0 is None:
        x0 = _fp_sqrt_int((c0 - s) * inv2 % P_MOD)
        if x0 is None:
            return None
    x1 = c1 * pow(2 * x0 % P_MOD, -1, P_MOD) % P_MOD
    if ((x0 * x0 - x1 * x1) % P_MOD, 2 * x0 * x1 % P_MOD) != (c0 % P_MOD,
                                                               c1 % P_MOD):
        return None
    return x0, x1


def decompress(data: bytes):
    """96 bytes -> (x0, x1, y0, y1, is_inf) ints; ValueError on an invalid
    encoding.  Subgroup membership is checked separately."""
    if len(data) != 96:
        raise ValueError("G2 compressed point must be 96 bytes")
    flags = data[0] & 0xE0
    if not (flags & 0x80):
        raise ValueError("uncompressed G2 not supported")
    if flags & 0x40:
        if (data[0] & 0x1F) or any(data[1:]) or (flags & 0x20):
            raise ValueError("invalid G2 infinity encoding")
        return 0, 0, 0, 0, True
    x1 = int.from_bytes(bytes([data[0] & 0x1F]) + data[1:48], "big")
    x0 = int.from_bytes(data[48:], "big")
    if x0 >= P_MOD or x1 >= P_MOD:
        raise ValueError("G2 x out of range")
    a0 = (x0 * x0 - x1 * x1) % P_MOD
    a1 = 2 * x0 * x1 % P_MOD
    c0 = (a0 * x0 - a1 * x1 + 4) % P_MOD
    c1 = (a0 * x1 + a1 * x0 + 4) % P_MOD
    y = _fp2_sqrt_ints(c0, c1)
    if y is None:
        raise ValueError("G2 x not on curve")
    y0, y1 = y
    if _is_large(y0, y1) != bool(flags & 0x20):
        y0, y1 = (P_MOD - y0) % P_MOD, (P_MOD - y1) % P_MOD
    return x0, x1, y0, y1, False
