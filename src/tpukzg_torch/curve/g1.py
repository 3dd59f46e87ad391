"""G1: E(Fp) y^2 = x^3 + 4 — the trailing-layout curve ``G1``, the
48-byte codec, batched decompression and the GLV subgroup check
(counterpart of ``tpukzg/curve/g1.py``).

Host work is bytes only (flags, x < p); the square root, the on-curve
and the subgroup checks run batched as tensor code on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.field.mont import FP, I32, P_MOD, upload
from tpukzg_torch.curve.weierstrass import CurveOps
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.utils.config import KzgConfig

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

GEN_NP = (FP.to_mont_host(G1_X), FP.to_mont_host(G1_Y), FP.one_mont)
INF_NP = (FP.zero, FP.one_mont, FP.zero)


def _lm(p):
    return tuple(c.movedim(-1, 0) for c in p)


def _trailing(p):
    return tuple(c.movedim(0, -1) for c in p)


class G1Ops(CurveOps):
    """G1 on (..., 24) coords (``tpukzg/curve/g1.py:21``), for the
    generic Pippenger, the butterfly and the tests.  Its adds and runs of
    doublings go through the limb-major curve: ec_add and one ec_double
    launch a run on the card, their plain versions on the CPU (the same
    formulas, so the same limbs as the tensor formulas)."""

    def add(self, p, q):
        return _trailing(G1_LM.add(_lm(p), _lm(q)))

    def double(self, p):
        return self.double_n(p, 1)

    def double_n(self, p, t: int):
        return _trailing(G1_LM.double_n(_lm(p), t))


G1 = G1Ops("G1", FP, b3_mul=lambda x: FP.mul_small(x, 12),
           gen_affine_np=GEN_NP[:2])

_SIGN_THRESHOLD = (P_MOD - 1) // 2


def compress(x_int: int, y_int: int, is_inf: bool) -> bytes:
    if is_inf:
        return bytes([0xC0]) + bytes(47)
    flags = 0x80 | (0x20 if y_int > _SIGN_THRESHOLD else 0)
    b = x_int.to_bytes(48, "big")
    return bytes([b[0] | flags]) + b[1:]


def normalize(p):
    """Trailing-layout (..., 24) point -> (x, y, is_inf) affine Montgomery."""
    x, y, inf = G1_LM.normalize(tuple(c.movedim(-1, 0) for c in p))
    return x.movedim(0, -1), y.movedim(0, -1), inf


def point_to_ints(p):
    """One point ((24,) coords) -> (x_int, y_int, is_inf)."""
    x, y, inf = normalize(tuple(c.reshape(1, -1) for c in p))
    return (FP.to_int(FP.from_mont(x)[0]), FP.to_int(FP.from_mont(y)[0]),
            bool(inf[0]))


def compress_points(p) -> list[bytes]:
    x, y, inf = normalize(p)
    x = FP.from_mont(x).cpu().numpy()
    y = FP.from_mont(y).cpu().numpy()
    inf = inf.cpu().numpy()
    return [compress(FP.to_int(x[i]), FP.to_int(y[i]), bool(inf[i]))
            for i in range(x.shape[0])]


# ---------------------------------------------------------------------------
# GLV subgroup check: phi(x, y) = (beta x, y) acts on G1 as [x^2 - 1]
# ---------------------------------------------------------------------------

BETA_GLV = 0x1A0111EA397FE699EC02408663D4DE85AA0D857D89759AD4897D29650FB85F9B409427EB4F49FFFD8BFD00000000AAAC
_X_ABS = 0xD201000000010000
_BETA_MONT = FP.to_mont_host(BETA_GLV)


def _x_addition_chain():
    """|x_BLS| as (run of doubles, then add) segments after the top bit."""
    bits = bin(_X_ABS)[2:]
    segs, run = [], 0
    for b in bits[1:]:
        run += 1
        if b == "1":
            segs.append((run, True))
            run = 0
    if run:
        segs.append((run, False))
    return tuple(segs)


_X_SEGS = _x_addition_chain()


def _mul_by_abs_x_lm(p, curve=G1_LM):
    acc = p
    for n_doubles, then_add in _X_SEGS:
        acc = curve.double_n(acc, n_doubles)
        if then_add:
            acc = curve.add(acc, p)
    return acc


def in_subgroup_fast(p, curve=G1_LM):
    """Batched membership test on trailing-layout (n, 24) coords:
    on-curve and phi(P) == [x^2 - 1]P (126 doubles + 10 adds)."""
    plm = tuple(c.movedim(-1, 0) for c in p)
    lam_p = curve.add(_mul_by_abs_x_lm(_mul_by_abs_x_lm(plm, curve), curve),
                      curve.neg(plm))
    beta = upload(_BETA_MONT, plm[0].device).reshape(
        (FP.L,) + (1,) * (plm[0].dim() - 1))
    phi = (curve.F.mul(plm[0], beta), plm[1], plm[2])
    return curve.eq(phi, lam_p) & curve.is_on_curve(plm)


# ---------------------------------------------------------------------------
# batched decompression
# ---------------------------------------------------------------------------

_B_MONT = FP.to_mont_host(4)


def _decompress_sqrt(x_can, sign, inf):
    """(n, 24) canonical x, (n,) sign and infinity flags ->
    ((X, Y, Z) Montgomery projective, ok_curve)."""
    xm = FP.to_mont(x_can)
    rhs = FP.add(FP.mul(FP.sqr(xm), xm),
                 upload(_B_MONT, xm.device))
    y = FP.pow_int(rhs, (P_MOD + 1) // 4)
    ok_curve = FP.eq(FP.sqr(y), rhs)
    flip = FP.gt_half(FP.from_mont(y)) != sign
    y = FP.select(flip, FP.neg(y), y)
    one = FP.const("one_mont", xm.device, I32).expand_as(xm)
    zero = torch.zeros_like(xm)
    X = FP.select(inf, zero, xm)
    Y = FP.select(inf, one, y)
    Z = FP.select(inf, zero, one)
    return (X, Y, Z), ok_curve


def parse_compressed(byte_list):
    """Host side of decompression: flags and range checks.  Raises
    ValueError on malformed encodings -> (x limbs (n, 24), sign, inf)."""
    n = len(byte_list)
    if any(len(b) != 48 for b in byte_list):
        raise ValueError("G1 compressed point must be 48 bytes")
    raw = np.frombuffer(b"".join(byte_list), np.uint8).reshape(n, 48)
    flags = raw[:, 0] & 0xE0
    if not np.all(flags & 0x80):
        raise ValueError("uncompressed G1 not supported")
    inf = (flags & 0x40) != 0
    sign = (flags & 0x20) != 0
    body = raw.copy()
    body[:, 0] &= 0x1F
    if np.any(inf & (sign | (body.max(axis=1) != 0))):
        raise ValueError("invalid G1 infinity encoding")
    limbs_be = (body[:, 0::2].astype(np.int32) << 8) | body[:, 1::2]
    x_l = np.ascontiguousarray(limbs_be[:, ::-1])
    p_be = np.asarray(FP.mod_limbs)[::-1]
    lt, gt = limbs_be < p_be, limbs_be > p_be
    first = np.argmax(lt | gt, axis=1)
    idx = np.arange(n)
    in_range = (lt | gt)[idx, first] & lt[idx, first]
    if not np.all(in_range | inf):
        raise ValueError("G1 x out of range")
    return x_l, sign, inf


def decompress_batch(byte_list, device):
    """48-byte encodings -> ((X, Y, Z) (n, 24) on `device`, ok (n,) bool).
    ok = on the curve and in G1 (or infinity).  With
    TPUKZG_CHECK_SUBGROUP=0 (trusted input) the subgroup check is skipped;
    the range and on-curve checks still run.  No host sync: the result
    stays on the device."""
    x_l, sign, inf = parse_compressed(byte_list)
    x_t = upload(x_l, device)
    sign_t = upload(sign, device)
    inf_t = upload(inf, device)
    pts, ok_curve = _decompress_sqrt(x_t, sign_t, inf_t)
    if not KzgConfig.from_env().check_subgroup:
        return pts, ok_curve | inf_t
    sub = in_subgroup_fast(pts)
    return pts, (ok_curve & sub) | inf_t
