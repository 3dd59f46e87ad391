"""The port's G1 code (src/tpukzg_torch/curve) against the JAX package and
the golden model, on the CPU.  Tolerances: decompressed coordinates and
group-law outputs exact (the same formulas over canonical field values);
points from golden compared as affine integers."""

import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.curve import g1 as jg1
from tpukzg.curve.weierstrass_lm import G1_LM as JG1_LM
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.field.mont import P_MOD

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _golden_points(seed, k):
    rng = random.Random(seed)
    return [gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
            for _ in range(k)]


def _off_subgroup_bytes():
    """A point on the curve whose order is not r (cofactor part)."""
    x = 3
    while True:
        x += 1
        y = gold.fp_sqrt((x ** 3 + 4) % P_MOD)
        if y is None:
            continue
        pt = gold.g1_from_affine((x, y))
        if not gold.g1_in_subgroup(pt):
            return tg1.compress(x, y, False)


def _not_on_curve_bytes():
    x = 3
    while gold.fp_sqrt((x ** 3 + 4) % P_MOD) is not None:
        x += 1
    return tg1.compress(x, 0, False)


@pytest.fixture(scope="module")
def encodings():
    pts = _golden_points(21, 5)
    enc = [gold.g1_compress(p) for p in pts]
    enc.append(bytes([0xC0]) + bytes(47))                     # infinity
    enc.append(_off_subgroup_bytes())
    enc.append(_not_on_curve_bytes())
    return pts, enc


def test_decompress_batch_vs_jax_and_golden(encodings):
    pts, enc = encodings
    got, ok = tg1.decompress_batch(enc, "cpu")
    ref, ok_ref = jg1.decompress_batch(enc)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    assert ok.tolist() == np.asarray(ok_ref).tolist()
    assert ok.tolist() == [True] * 6 + [False, False]
    for i, p in enumerate(pts):
        x, y, inf = tg1.point_to_ints(tuple(c[i] for c in got))
        assert (x, y) == gold.g1_affine(p) and not inf
    assert tg1.point_to_ints(tuple(c[5] for c in got))[2]
    # compress(decompress(b)) == b for the valid encodings
    assert tg1.compress_points(tuple(c[:6] for c in got)) == enc[:6]


def test_in_subgroup_fast_vs_jax_and_golden(encodings):
    _, enc = encodings
    x_l, sign, inf = tg1.parse_compressed(enc[:7])
    pts, _ = tg1._decompress_sqrt(torch.from_numpy(x_l),
                                  torch.from_numpy(sign), torch.from_numpy(inf))
    got = tg1.in_subgroup_fast(pts)
    ref = jg1.in_subgroup_fast(tuple(c.numpy().astype(np.uint32)
                                     for c in pts))
    assert got.tolist() == np.asarray(ref).tolist()
    assert got.tolist() == [True] * 6 + [False]


@pytest.mark.parametrize("bad", [
    b"\x00" * 48,                                   # no compression flag
    bytes([0xC0]) + bytes(46) + b"\x01",            # infinity with a body
    bytes([0xE0]) + bytes(47),                      # infinity with sign
    bytes([0x9A, 0x01, 0x11]) + b"\xff" * 45,       # x >= p
    b"\x80" * 47,                                   # 47 bytes
], ids=["uncompressed", "inf-body", "inf-sign", "x-ge-p", "short"])
def test_malformed_encodings_raise_like_jax(bad):
    with pytest.raises(ValueError):
        tg1.decompress_batch([bad], "cpu")
    with pytest.raises(ValueError):
        jg1.decompress(bad)


def test_group_law_vs_jax_lm():
    pts = _golden_points(22, 4)
    enc = [gold.g1_compress(p) for p in pts]
    got, _ = tg1.decompress_batch(enc, "cpu")
    lm = tuple(c.T.contiguous() for c in got)               # (24, 4)
    p = tuple(c[:, :2] for c in lm)
    q = tuple(c[:, 2:] for c in lm)
    jp = tuple(c.numpy().astype(np.uint32) for c in p)
    jq = tuple(c.numpy().astype(np.uint32) for c in q)
    for got_c, ref_c in ((G1_LM.add(p, q), JG1_LM.add(jp, jq)),
                         (G1_LM.double(p), JG1_LM.double(jp))):
        for g, r in zip(got_c, ref_c):
            assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    s = G1_LM.add(p, q)
    assert G1_LM.is_on_curve(s).all()
    assert G1_LM.eq(G1_LM.add(p, q), G1_LM.add(q, p)).all()
    x, y, _ = tg1.normalize(tuple(c[:, 0:1].T for c in s))
    from tpukzg_torch.field.mont import FP
    want = gold.g1_affine(gold.g1_add(pts[0], pts[2]))
    assert (FP.to_int(FP.from_mont(x)[0]), FP.to_int(FP.from_mont(y)[0])) == want
    assert G1_LM.is_inf(G1_LM.add(p, G1_LM.neg(p))).all()
