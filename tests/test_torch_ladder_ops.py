"""The port's small-int multiple, tree sum, naive MSM and subgroup
check of the trailing-layout curves (``curve/weierstrass.py``:
`mul_int`, `reduce_sum`, `msm_naive`, `in_subgroup`; ``curve/g1.py``'s
G1 and G2) on the CPU, against the JAX package's ``CurveOps`` and the
golden model.  Tolerances: the tree sum equals the JAX package's bit for
bit (the same adds in the same order); every comparison with golden in
affine form (the compressed bytes); subgroup verdicts equal."""

import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.curve.g1 import G1 as JG1

from tpukzg_torch.curve import g1 as g1m, g2 as g2m
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.field.mont import FP, FR, P_MOD

from test_torch_ladder import g1_bytes, g2_bytes, want_g1, want_g2

torch.set_num_threads(1)


@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_mul_int_vs_golden(curve):
    ks = [0, 1, 2, 3, 5, 12, 255]
    cv = G1 if curve == "G1" else G2
    base = cv.gen((), "cpu")
    got = [(g1_bytes if curve == "G1" else g2_bytes)(tuple(
        c[None] if curve == "G1" else c for c in cv.mul_int(base, k)))[0]
        for k in ks]
    assert got == (want_g1 if curve == "G1" else want_g2)(ks)


def test_reduce_sum_vs_jax_and_golden():
    """Five points along axis 0 (an odd count: infinity pads), equal to
    the JAX `reduce_sum` limb for limb, and a (2, 3) batch along axis
    1."""
    rng = random.Random(31)
    ks = [rng.randrange(gold.R) for _ in range(6)]
    pts = g1m.decompress_batch([gold.g1_compress(gold.g1_mul(
        gold.G1_GEN, k)) for k in ks], "cpu")[0]
    five = G1.reduce_sum(tuple(c[:5] for c in pts), axis=0)
    jfive = JG1.reduce_sum(tuple(np.asarray(c[:5]).astype(np.uint32)
                                 for c in pts), axis=0)
    for a, b in zip(five, jfive):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    grid = G1.reduce_sum(tuple(c.reshape(2, 3, 24) for c in pts), axis=1)
    assert g1_bytes(tuple(c[None] for c in five)) == want_g1([sum(ks[:5])])
    assert g1_bytes(grid) == want_g1([sum(ks[:3]), sum(ks[3:])])


@pytest.mark.parametrize("curve", ["G1", "G2"])
def test_msm_naive_vs_golden(curve):
    rng = random.Random(37)
    n = 5
    logs = [rng.randrange(1, gold.R) for _ in range(n)]
    ks = [rng.randrange(gold.R) for _ in range(n)]
    if curve == "G1":
        cv, pts = G1, g1m.decompress_batch([gold.g1_compress(gold.g1_mul(
            gold.G1_GEN, k)) for k in logs], "cpu")[0]
    else:
        cv, pts = G2, [g2m.point_from_ints(a[0].c0, a[0].c1, a[1].c0,
                                           a[1].c1) for a in (gold.g2_affine(
                                               gold.g2_mul(gold.G2_GEN, k))
                                               for k in logs)]
        pts = tuple(torch.stack([torch.as_tensor(p[i]) for p in pts])
                    for i in range(3))
    out = cv.msm_naive(pts, torch.as_tensor(FR.from_int(ks)))
    total = sum(a * b for a, b in zip(logs, ks))
    if curve == "G1":
        assert g1_bytes(tuple(c[None] for c in out)) == want_g1([total])
    else:
        assert g2_bytes(out) == want_g2([total])


def _g2_outside_subgroup():
    """A G2 point on the curve outside the order-r subgroup: x = (v, 1)
    for the first v > 5 whose y exists and fails the host check."""
    v = 5
    while True:
        v += 1
        y = g2m._fp2_sqrt_ints((v ** 3 - 3 * v + 4) % P_MOD,
                               (3 * v * v - 1 + 4) % P_MOD)
        if y is not None and not g2m.in_subgroup_host(v, 1, *y):
            return (v, 1), y


def test_in_subgroup():
    """[r] P == infinity: the generators of G1 and G2 pass; a G2 point on
    the curve but outside the subgroup fails (as golden's check), and so
    does a G1 point outside G1."""
    x, y = _g2_outside_subgroup()
    gp = (gold.Fp2(*x), gold.Fp2(*y), gold.Fp2.one())
    assert gold.g2_is_on_curve(gp) and not gold.g2_in_subgroup(gp)
    bad = tuple(torch.as_tensor(c) for c in g2m.point_from_ints(*x, *y))
    g2s = tuple(torch.stack([a, b]) for a, b in zip(G2.gen((), "cpu"), bad))
    assert bool(G2.is_on_curve(g2s).all())
    assert G2.in_subgroup(g2s).tolist() == [True, False]
    xg = 3
    while True:                            # on the curve, outside G1
        xg += 1
        rhs = (xg ** 3 + 4) % P_MOD
        yg = pow(rhs, (P_MOD + 1) // 4, P_MOD)
        if yg * yg % P_MOD == rhs and not gold.g1_in_subgroup(
                (gold._FpW(xg), gold._FpW(yg), gold._FpW(1))):
            break
    outside = (FP.to_mont_host(xg), FP.to_mont_host(yg), FP.one_mont)
    g1s = tuple(torch.as_tensor(np.stack([g, o]))
                for g, o in zip(g1m.GEN_NP, outside))
    assert G1.in_subgroup(g1s).tolist() == [True, False]
