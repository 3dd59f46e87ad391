"""The port's limb-major G2 (``FP2_LM``, ``G2_LM``) and its G2 MSM on the
CPU, against the golden model (plain Python integers) and the generic
``Pippenger(G2)``; the tensor-code decompositions of the G2 kernels
(``seg_scan_chunked``, ``window_sum_chunked``) against the plain route.
Tolerance: field values exact; points equal in affine form (projective
coordinates depend on the order of the additions).  The kernels
themselves are held against these plain versions on a card by
tests/test_torch_cuda.py."""

import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.curve.weierstrass_lm import G2_LM, G2_LM_PLAIN
from tpukzg_torch.field.limb_major import FP2_LM_PLAIN
from tpukzg_torch.field.mont import FP, ints_to_limbs
from tpukzg_torch.kernels import bucket, ec
from tpukzg_torch.msm import pippenger_lm
from tpukzg_torch.msm.pippenger import Pippenger

from torch_cases import g2_limbs, g2_points, scan_inputs

torch.set_num_threads(1)
R_INV = pow(1 << 384, -1, gold.P)


def fp2_from_limbs(a, i):
    """Column i of (48, n) Montgomery limbs -> golden Fp2."""
    a = np.asarray(a)
    return gold.Fp2(FP.to_int(a[:24, i]) * R_INV % gold.P,
                    FP.to_int(a[24:, i]) * R_INV % gold.P)


def fp2_limbs(vals):
    """Golden Fp2 values -> (48, n) Montgomery limbs."""
    return torch.as_tensor(np.stack([np.concatenate(
        [FP.to_mont_host(v.c0), FP.to_mont_host(v.c1)]) for v in vals], 1))


def affine(p, i=0):
    """Lane i of limb-major G2 coords -> golden affine (or None)."""
    X, Y, Z = (fp2_from_limbs(c.reshape(48, -1), i) for c in p)
    if Z.is_zero():
        return None
    zi = Z.inv()
    return (X * zi, Y * zi)


def lanes(p):
    return [affine(p, i) for i in range(p[0].reshape(48, -1).shape[1])]


@pytest.fixture(scope="module")
def golden_points():
    rng = random.Random(0x6201)
    return [gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
            for _ in range(8)]


def test_fp2_lm_vs_golden():
    """mul, sqr, the non-residue 1 + u, 3b, inv, add, sub, neg on 0, 1,
    p - 1 and seeded values, exact."""
    rng = random.Random(5)
    vals = [gold.Fp2(0, 0), gold.Fp2(1, 0), gold.Fp2(0, 1),
            gold.Fp2(gold.P - 1, gold.P - 1)]
    vals += [gold.Fp2(rng.randrange(gold.P), rng.randrange(gold.P))
             for _ in range(12)]
    other = vals[::-1]
    F = FP2_LM_PLAIN
    a, b = fp2_limbs(vals), fp2_limbs(other)
    xi = gold.Fp2(1, 1)
    cases = {
        "mul": (F.mul(a, b), [x * y for x, y in zip(vals, other)]),
        "sqr": (F.sqr(a), [x.sqr() for x in vals]),
        "nonresidue": (F.mul_by_nonresidue(a), [x * xi for x in vals]),
        "b3": (F.mul_b3(a), [x * gold.Fp2(12, 12) for x in vals]),
        "add": (F.add(a, b), [x + y for x, y in zip(vals, other)]),
        "sub": (F.sub(a, b), [x - y for x, y in zip(vals, other)]),
        "neg": (F.neg(a), [-x for x in vals]),
    }
    for name, (got, want) in cases.items():
        assert [fp2_from_limbs(got, i) for i in range(len(vals))] == want, \
            name
    nz = fp2_limbs(vals[1:])
    assert [fp2_from_limbs(F.inv(nz), i) for i in range(len(vals) - 1)] == \
        [x.inv() for x in vals[1:]]
    assert torch.equal(F.mul(a, F.one("cpu")[:, None]), a)


def test_g2_lm_add_double_vs_golden(golden_points):
    """G2_LM add over P + Q, P + P, P + (-P), inf + Q, P + inf and
    inf + inf; double and runs of doublings; on-curve, eq and normalize,
    all against golden in affine form."""
    P = golden_points
    inf = gold.G2_INF
    ps = [P[0], P[1], inf, P[3], inf, P[5], P[6], P[7]]
    qs = [P[0], gold.g2_neg(P[1]), P[2], inf, inf, P[4], P[7], P[6]]
    p, q = (tuple(torch.as_tensor(c) for c in g2_limbs(x)) for x in (ps, qs))
    for curve in (G2_LM, G2_LM_PLAIN):
        s = curve.add(p, q)
        assert lanes(s) == [gold.g2_affine(gold.g2_add(a, b))
                            for a, b in zip(ps, qs)]
        assert lanes(curve.double(p)) == [gold.g2_affine(gold.g2_double(a))
                                          for a in ps]
        assert lanes(curve.double_n(p, 5)) == [
            gold.g2_affine(gold.g2_mul(a, 32)) for a in ps]
        assert bool(curve.is_on_curve(s).all())
        assert bool(curve.eq(s, curve.add(q, p)).all())
    x, y, is_inf = G2_LM_PLAIN.normalize(s)
    for i, (a, b) in enumerate(zip(ps, qs)):
        want = gold.g2_affine(gold.g2_add(a, b))
        assert bool(is_inf[i]) == (want is None)
        if want is not None:
            assert (fp2_from_limbs(x, i), fp2_from_limbs(y, i)) == want
    off = (p[0], FP2_LM_PLAIN.add(p[1], FP2_LM_PLAIN.one("cpu")[:, None]),
           p[2])
    assert not bool(G2_LM_PLAIN.is_on_curve(off)[0])


@pytest.mark.parametrize("windowed", [False, True], ids=["ladder", "w4"])
def test_g2_lm_scalar_mul_vs_golden(golden_points, windowed):
    """[k] P for k = 0, 1, 2, r - 1, r and seeded k over five points
    (infinity among them), by the 256-step ladder and the 2^4-window
    ladder, against golden."""
    rng = random.Random(9)
    ks = [0, 1, 2, gold.R - 1, gold.R] + [rng.randrange(1 << 255)
                                          for _ in range(3)]
    base = golden_points[:4] + [gold.G2_INF] + golden_points[4:7]
    p = tuple(torch.as_tensor(c) for c in g2_limbs(base))
    k = torch.as_tensor(ints_to_limbs(ks, 16))
    mul = G2_LM.scalar_mul_windowed if windowed else G2_LM.scalar_mul_ladder
    got = mul(p, k)
    assert lanes(got) == [gold.g2_affine(gold.g2_mul(b, kk))
                          for b, kk in zip(base, ks)]


def _msm_case(n):
    """n points from a pool of 32 (so points repeat; from two points on,
    a zero scalar and the point at infinity among them), seeded scalars,
    and golden's direct sum of [k_i] P_i in affine form."""
    rng = random.Random(n)
    pool = g2_points()
    idx = [rng.randrange(32) for _ in range(n)]
    pts = [tuple(pool[j][:, i] for j in range(3)) for i in idx]
    ks = [rng.randrange(gold.R) for _ in range(n)]
    if n > 2:
        ks[1] = 0
        pts[2] = tuple(c[:, 0].numpy() for c in G2_LM_PLAIN.inf((1,), "cpu"))
    points = tuple(torch.as_tensor(np.stack([p[j] for p in pts]))
                   for j in range(3))                       # (n, 48)
    acc = gold.G2_INF
    for p, kk in zip(pts, ks):
        a = affine(tuple(torch.as_tensor(c)[:, None] for c in p))
        acc = gold.g2_add(acc, gold.g2_mul(gold.g2_from_affine(a), kk))
    return points, torch.as_tensor(ints_to_limbs(ks, 16)), gold.g2_affine(acc)


@pytest.mark.parametrize("n,c", [(1, 4), (37, 3)])
def test_g2_msm_vs_golden_and_pippenger(n, c):
    """The public msm over G2_LM at n = 1 and 37 points with small
    windows, so buckets collide (37 points into 7 buckets a window):
    against golden's direct sum and against Pippenger(G2).msm.  (A G2
    MSM costs ~0.3 s a point here, in the plain Fp products: larger n
    run on the card.)"""
    points, k, want = _msm_case(n)
    assert affine(pippenger_lm.msm(points, k, c=c, curve=G2_LM)) == want
    trailing = tuple(x.reshape(n, 2, 24) for x in points)
    gen = Pippenger(G2).msm(trailing, k, c=c)
    assert affine(tuple(x.reshape(48) for x in gen)) == want


def test_g2_msm_in_chunks_vs_golden():
    """The public msm over 37 G2 points in chunks of 16 points (three
    chunks whose buckets add up by window, the last padded), against
    golden."""
    points, k, want = _msm_case(37)
    got = pippenger_lm.msm(points, k, c=4, point_chunk=16, curve=G2_LM)
    assert affine(got) == want


def test_g2_msm_batch_vs_msm():
    """msm_batch over G2: two MSMs over one list of 8 points, each equal
    to the public msm of its row."""
    rng = random.Random(21)
    points = tuple(torch.as_tensor(c[:, :8].T.copy()) for c in g2_points())
    k = torch.as_tensor(np.stack([ints_to_limbs(
        [rng.randrange(gold.R) for _ in range(8)], 16) for _ in range(2)]))
    got = pippenger_lm.msm_batch(points, k, c=6, curve=G2_LM)
    for r in range(2):
        want = pippenger_lm.msm(points, k[r], c=6, curve=G2_LM)
        assert affine(tuple(c[r] for c in got)) == affine(want)


@pytest.mark.parametrize("sizes", [(3,), (8,), (16, 4)],
                         ids=["c3", "c8", "c16r4"])
def test_g2_seg_scan_chunked_vs_plain(sizes):
    """The bucket scan's three passes in tensor code over G2 coords
    (chunks of 3 and 8 lanes, and chunks of 16 scanned as runs of 4)
    against the plain loop scan, affine-equal in every lane; the CPU
    wrapper takes the plain route."""
    pts, seg = scan_inputs(3, 29, 4, nkeys=6, pool=g2_points())
    tp = tuple(torch.from_numpy(c) for c in pts)
    ts = torch.from_numpy(seg)
    want = bucket.seg_scan_plain(tp, ts)
    assert all(torch.equal(a, b) for a, b in zip(bucket.seg_scan(tp, ts),
                                                  want))
    got = bucket.seg_scan_chunked(tp, ts, sizes)
    assert got[0].shape == (48, 3, 29)
    assert bool(G2_LM_PLAIN.eq(got, want).all())


def test_g2_plain_versions_pick_the_curve_by_limbs():
    """ec_add / ec_double on the CPU over (48, n) coords are the Fp2
    formulas (equal to G2_LM_PLAIN's), and another limb axis is refused
    on the card's path."""
    p, q = (tuple(torch.as_tensor(c[:, :4]) for c in g2_points()),
            tuple(torch.as_tensor(c[:, 4:8]) for c in g2_points()))
    assert all(torch.equal(a, b) for a, b in zip(
        ec.ec_add(p, q), ec.ec_add_plain(p, q, FP2_LM_PLAIN)))
    assert all(torch.equal(a, b) for a, b in zip(
        ec.ec_double(p, 3), ec.ec_double_plain(p, FP2_LM_PLAIN, 3)))
    with pytest.raises(ValueError):
        ec._limb_major("ec_add", tuple(torch.zeros((36, 2)) for _ in
                                       range(3)))
    with pytest.raises(ValueError):
        bucket.plain_curve(tuple(torch.zeros((12, 2)) for _ in range(3)))
    assert pippenger_lm._chunk(1 << 17, 144, 48) == 1
    assert pippenger_lm._chunk(1 << 17, 144, 24) == 2


def test_benchmark_reference_g2_vs_golden(golden_points):
    """The benchmark's plain G2 reference (h100bench/reference/bls_g2.py,
    which may not import golden itself) against golden: sums, doublings,
    multiples, infinity, and the decoding of a port's output point."""
    from h100bench.reference import bls_g2 as ref

    def as_ref(p):
        a = gold.g2_affine(p)
        return ref.INF if a is None else (
            (a[0].c0, a[0].c1), (a[1].c0, a[1].c1), ref.ONE)

    def as_gold_affine(a):
        return None if a is None else (gold.Fp2(*a[0]), gold.Fp2(*a[1]))

    rng = random.Random(13)
    P, Q = golden_points[0], golden_points[1]
    k = rng.randrange(gold.R)
    assert as_gold_affine(ref.affine(ref.add(as_ref(P), as_ref(Q)))) == \
        gold.g2_affine(gold.g2_add(P, Q))
    assert as_gold_affine(ref.affine(ref.double(as_ref(P)))) == \
        gold.g2_affine(gold.g2_double(P))
    assert as_gold_affine(ref.affine(ref.add(as_ref(P), as_ref(P)))) == \
        gold.g2_affine(gold.g2_double(P))
    assert as_gold_affine(ref.affine(ref.mul(as_ref(P), k))) == \
        gold.g2_affine(gold.g2_mul(P, k))
    assert as_gold_affine(ref.affine(ref.mul_gen(k))) == \
        gold.g2_affine(gold.g2_mul(gold.G2_GEN, k))
    assert ref.affine(ref.add(as_ref(P), ref.neg(as_ref(P)))) is None
    s = G2_LM_PLAIN.add(*(tuple(torch.as_tensor(c) for c in g2_limbs([x]))
                          for x in (P, Q)))
    got = ref.point_from_limbs(*(c[:, 0].numpy() for c in s))
    assert as_gold_affine(got) == gold.g2_affine(gold.g2_add(P, Q))


def test_fp_mul_n_rows_are_fp_mul_rows():
    """csrc/ec.cuh's fp_mul_n (the G2 kernels' products, K at a time)
    issues the very PTX rows of fp_mul, whose every instruction
    utils/checked.py replays from the source: the two asm blocks of each,
    literal for literal and operand for operand (fp_mul's t[j] and a[j]
    are fp_mul_n's t[k][j] and a[k][j])."""
    import os
    import re
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src", "tpukzg_torch", "csrc", "ec.cuh")
    with open(path) as fh:
        src = fh.read()

    def blocks(fn):
        start = src.index(fn)
        body = src[start:src.index("\n}\n", start)]
        return [(re.findall(r'"([^"]*)"', m.split(":", 1)[0]),
                 re.findall(r'"\+?r"\(([^)]*)\)', m))
                for m in re.findall(r"asm\((.*?)\);", body, re.S)]

    rows, rows_n = blocks("void fp_mul("), blocks("void fp_mul_n(")
    assert len(rows) == len(rows_n) == 2
    for (lits, ops), (lits_n, ops_n) in zip(rows, rows_n):
        assert lits == lits_n and len(lits) >= 27
        assert ops_n == [re.sub(r"^(t|a)\[", r"\1[k][", o) for o in ops]
