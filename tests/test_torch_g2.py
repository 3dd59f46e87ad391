"""The port's G2 code (Fp2 ops, the generic curve over Fp2, psi, the
96-byte codec) and its Miller-line precompute, against the JAX package
and the golden model on the CPU.  Tolerances: Fp2 values and lines bit
for bit; points compared as affine integers (their projective limbs
depend on the order of the adds)."""

import json
import os
import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.curve import g2 as jg2
from tpukzg.field.tower import FP2 as JFP2
from tpukzg_torch.curve import g2 as tg2
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.field.mont import FR, P_MOD
from tpukzg_torch.field.tower import FP2
from tpukzg_torch.pairing.lines import precompute_lines

from torch_cases import REPO

torch.set_num_threads(1)

with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as _fh:
    KAT = json.load(_fh)


def g2_in(gp):
    a = gold.g2_affine(gp)
    if a is None:
        return tuple(torch.as_tensor(c) for c in tg2.point_from_ints(
            0, 0, 0, 0, True))
    return tuple(torch.as_tensor(c) for c in tg2.point_from_ints(
        a[0].c0, a[0].c1, a[1].c0, a[1].c1))


def g2_batch(gps):
    pts = [g2_in(gp) for gp in gps]
    return tuple(torch.stack([p[i] for p in pts]) for i in range(3))


def g2_out(p, i=None):
    """Lane i (or the single point) -> golden affine, None for infinity."""
    if i is not None:
        p = tuple(c[i] for c in p)
    (x0, x1), (y0, y1), inf = tg2.point_to_ints(p)
    return None if inf else (gold.Fp2(x0, x1), gold.Fp2(y0, y1))


def _golden_g2(seed, k):
    rng = random.Random(seed)
    return [gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
            for _ in range(k)]


def _off_subgroup(count):
    """On-curve points x = (v, 1) outside the r-subgroup (as the JAX
    package's tests build them) -> [(x0, x1, y0, y1)]."""
    outs, v = [], 5
    while len(outs) < count:
        v += 1
        c0 = (v * v * v - 3 * v + 4) % P_MOD
        c1 = (3 * v * v - 1 + 4) % P_MOD
        y = jg2._fp2_sqrt_ints(c0, c1)
        if y is None:
            continue
        if not gold.g2_in_subgroup(gold.g2_from_affine(
                (gold.Fp2(v, 1), gold.Fp2(*y)))):
            outs.append((v, 1, y[0], y[1]))
    return outs


def _fp2_values(seed, n):
    rng = random.Random(seed)
    vals = [(rng.randrange(P_MOD), rng.randrange(P_MOD)) for _ in range(n)]
    vals[:3] = [(0, 0), (P_MOD - 1, 0), (0, P_MOD - 1)]
    return np.stack([tg2.fp2_from_ints(*v) for v in vals])   # (n, 2, 24)


@pytest.mark.parametrize("op", ["select", "eq", "is_zero", "neg", "double",
                                "mul_small"])
def test_fp2_ops_vs_jax(op):
    a = _fp2_values(1, 8)
    b = np.roll(a, 1, axis=0)
    b[4] = a[4]                                  # one equal pair for eq
    mask = np.arange(8) % 3 == 0
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    got, want = {
        "select": lambda: (FP2.select(torch.from_numpy(mask), ta, tb),
                           JFP2.select(mask, ja, jb)),
        "eq": lambda: (FP2.eq(ta, tb), JFP2.eq(ja, jb)),
        "is_zero": lambda: (FP2.is_zero(ta), JFP2.is_zero(ja)),
        "neg": lambda: (FP2.neg(ta), JFP2.neg(ja)),
        "double": lambda: (FP2.double(ta), JFP2.double(ja)),
        "mul_small": lambda: (FP2.mul_small(ta, 12), JFP2.mul_small(ja, 12)),
    }[op]()
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().astype(np.int64),
                          want.astype(np.int64))


def test_g2_group_law_vs_golden():
    gps = _golden_g2(3, 2)
    inf = gold.G2_INF
    p = g2_batch([gps[0], gps[0], gps[0], inf, inf])
    q = g2_batch([gps[1], gps[0], gold.g2_neg(gps[0]), gps[1], inf])
    s = G2.add(p, q)
    want = [gold.g2_add(gps[0], gps[1]), gold.g2_double(gps[0]), inf,
            gps[1], inf]
    assert [g2_out(s, i) for i in range(5)] == [gold.g2_affine(w)
                                                for w in want]
    d = G2.double(p)
    assert [g2_out(d, i) for i in (0, 3)] == [
        gold.g2_affine(gold.g2_double(gps[0])), None]
    assert g2_out(G2.neg(p), 0) == gold.g2_affine(gold.g2_neg(gps[0]))
    assert G2.is_on_curve(q).tolist() == [True] * 5
    # eq is projective: the sum and the doubling of P agree with 2P
    assert G2.eq(tuple(c[1] for c in s), tuple(c[0] for c in d)).item()
    assert G2.eq(p, q).tolist() == [False, True, False, False, True]
    x, y, is_inf = G2.normalize(s)
    assert is_inf.tolist() == [False, False, True, False, True]
    assert torch.equal(x[2], torch.zeros_like(x[2]))


def test_g2_scalar_mul_vs_kat_and_golden():
    kat = KAT["g2_multiples"]
    keys = [int(k) for k in kat]
    gp = _golden_g2(5, 1)[0]
    extra = [gold.R - 1, (1 << 255) + 12345, gold.R - 2]
    base = g2_batch([gold.G2_GEN] * len(keys) + [gp] * len(extra))
    ks = torch.as_tensor(FR.from_int(keys + extra))
    got = G2.scalar_mul(base, ks)
    for i, k in enumerate(keys):
        assert tg2.compress_point(tuple(c[i] for c in got)) == \
            bytes.fromhex(kat[str(k)])
    for j, k in enumerate(extra):
        assert g2_out(got, len(keys) + j) == gold.g2_affine(
            gold.g2_mul(gp, k % gold.R))
    # one point against a batch of scalars broadcasts
    one = tuple(c[0] for c in g2_batch([gp]))
    b = G2.scalar_mul(one, ks[-2:])
    assert [g2_out(b, i) for i in range(2)] == [g2_out(got, len(keys) + 1),
                                                g2_out(got, len(keys) + 2)]


def test_psi_is_multiplication_by_x():
    """psi(Q) == [x] Q, x = -|x|, on the KAT multiples; not so on a
    point outside the subgroup."""
    kat = KAT["g2_multiples"]
    pts = [jg2.decompress(bytes.fromhex(v)) for v in kat.values()]
    pts += [o + (False,) for o in _off_subgroup(1)]
    batch = tuple(torch.stack([torch.as_tensor(c) for c in col]) for col in
                  zip(*[tg2.point_from_ints(*p) for p in pts]))
    lhs = tg2.psi(batch)
    rhs = G2.neg(tg2._mul_abs_x(batch))
    assert G2.eq(lhs, rhs).tolist() == [True] * len(kat) + [False]


def test_in_subgroup_psi_vs_host_and_golden():
    members = _golden_g2(7, 2)
    outs = _off_subgroup(2)
    pts = [g2_in(m) for m in members + [gold.G2_INF]]
    pts[2:2] = [tuple(torch.as_tensor(c) for c in tg2.point_from_ints(*o))
                for o in outs]
    batch = tuple(torch.stack([p[i] for p in pts]) for i in range(3))
    got = tg2.in_subgroup_psi(batch).tolist()
    assert got == [True, True, False, False, True]
    for m in members:
        a = gold.g2_affine(m)
        args = (a[0].c0, a[0].c1, a[1].c0, a[1].c1)
        assert tg2.in_subgroup_host(*args) and jg2.in_subgroup_host(*args)
    for o in outs:
        assert not tg2.in_subgroup_host(*o)
        assert not jg2.in_subgroup_host(*o)
    assert tg2.in_subgroup_host(0, 0, 0, 0, True)


def test_point_ints_round_trip_vs_jax():
    gp = _golden_g2(9, 1)[0]
    a = gold.g2_affine(gp)
    args = (a[0].c0, a[0].c1, a[1].c0, a[1].c1)
    ours, ref = tg2.point_from_ints(*args), jg2.point_from_ints(*args)
    for o, r in zip(ours, ref):
        assert np.array_equal(o, np.asarray(r).astype(np.int32))
    assert tg2.point_to_ints(tuple(torch.as_tensor(c) for c in ours)) == \
        ((args[0], args[1]), (args[2], args[3]), False)
    assert tg2.fp2_to_ints(ours[0]) == (args[0], args[1])
    inf = tg2.point_from_ints(0, 0, 0, 0, True)
    assert tg2.point_to_ints(tuple(torch.as_tensor(c) for c in inf))[2]


def _codec_cases():
    gps = _golden_g2(11, 2)
    enc = [gold.g2_compress(p) for p in gps]
    enc += [gold.g2_compress(gold.g2_neg(p)) for p in gps]   # other sign
    enc.append(bytes([0xC0]) + bytes(95))                    # infinity
    return gps, enc


def test_g2_codec_round_trip_vs_jax():
    gps, enc = _codec_cases()
    assert {e[0] & 0x20 for e in enc[:4]} == {0, 0x20}        # both signs
    for e in enc:
        got, ref = tg2.decompress(e), jg2.decompress(e)
        assert got == ref
        assert tg2.compress(*got) == jg2.compress(*ref) == e
    pts = g2_batch(gps + [gold.g2_neg(p) for p in gps] + [gold.G2_INF])
    assert [tg2.compress_point(tuple(c[i] for c in pts))
            for i in range(5)] == enc


@pytest.mark.parametrize("case", ["uncompressed", "inf_with_sign",
                                  "inf_with_bits", "x0_ge_p", "x1_ge_p",
                                  "not_on_curve", "short"])
def test_g2_decompress_rejects_like_jax(case):
    good = gold.g2_compress(_golden_g2(13, 1)[0])
    p_be = P_MOD.to_bytes(48, "big")
    x = 1                                # x = (x, 0): y^2 = x^3 + 4 + 4u
    while jg2._fp2_sqrt_ints((x ** 3 + 4) % P_MOD, 4) is not None:
        x += 1
    data = {
        "uncompressed": bytes([good[0] & 0x1F]) + good[1:],
        "inf_with_sign": bytes([0xE0]) + bytes(95),
        "inf_with_bits": bytes([0xC0]) + bytes(94) + b"\x01",
        "x0_ge_p": good[:48] + p_be,
        "x1_ge_p": bytes([p_be[0] | 0x80]) + p_be[1:] + good[48:],
        "not_on_curve": bytes([0x80]) + bytes(47) + x.to_bytes(48, "big"),
        "short": good[:95],
    }[case]
    with pytest.raises(ValueError):
        jg2.decompress(data)
    with pytest.raises(ValueError):
        tg2.decompress(data)


@pytest.mark.parametrize("c1_zero", [True, False])
def test_fp2_sqrt_vs_jax(c1_zero):
    """Residues and non-residues, with c1 = 0 (the real-subfield branch:
    one of c0 and -c0 is a square in Fp) and without."""
    rng = random.Random(17 + c1_zero)
    for _ in range(12):
        c0 = rng.randrange(P_MOD)
        c1 = 0 if c1_zero else rng.randrange(P_MOD)
        got = tg2._fp2_sqrt_ints(c0, c1)
        assert got == jg2._fp2_sqrt_ints(c0, c1)
        if got is not None:
            s = gold.Fp2(*got)
            assert s * s == gold.Fp2(c0, c1)
    assert tg2._fp2_sqrt_ints(0, 0) == (0, 0)


@pytest.mark.parametrize("srs", ["srs_8_848c3e3055a37e41",
                                 "srs_16_436c40aaaab022da"])
def test_precompute_lines_bit_exact(srs):
    """The lines of the committed [1]_2 and [tau]_2 equal the file's
    lng / lnt (the JAX package's output) bit for bit, the garbage rows
    of the add lines included."""
    with np.load(f"{REPO}/.srs_cache/{srs}.npz") as z:
        pts = tuple(torch.as_tensor(np.stack([z[f"g2g_{i}"], z[f"g2t_{i}"]])
                                    .astype(np.int32)) for i in range(3))
        want = [z[k].astype(np.int32) for k in ("lng_0", "lng_1", "lnt_0",
                                                "lnt_1")]
    d, a = precompute_lines(pts)
    assert d.shape == (2, 63, 3, 2, 24) and d.dtype == torch.int32
    for got, w in zip((d[0], a[0], d[1], a[1]), want):
        assert np.array_equal(got.numpy(), w)
