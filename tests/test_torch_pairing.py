"""The port's full pairing (``pairing/check.py:pairing``: the lines of a
G2 point, the Miller loop and the final exponentiation) on the CPU,
against the golden model.  Tolerance: the Fp12 value bit for bit."""

import random

import torch

import golden.model as gold

import torch_dist_cases as cases
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.field.mont import FP
from tpukzg_torch.pairing.check import pairing


def g2_affine_ints(p):
    a = gold.g2_affine(p)
    return ((a[0].c0, a[0].c1), (a[1].c0, a[1].c1))


def _fp12_ints(e):
    """(2, 3, 2, 24) Montgomery Fp12 -> golden's Fp12."""
    v = FP.to_int(FP.from_mont(e.reshape(-1, 24)))
    fp2 = [gold.Fp2(v[2 * j], v[2 * j + 1]) for j in range(6)]
    return gold.Fp12(gold.Fp6(*fp2[:3]), gold.Fp6(*fp2[3:]))


def test_pairing_vs_golden():
    """e(P, Q)^3 equal to golden's pairing; P at infinity gives one."""
    rng = random.Random(0x93)
    P = gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
    Q = gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
    pts = cases.g1_points([gold.g1_affine(P)], "cpu")
    inf = tuple(torch.as_tensor(c)[None] for c in G1.inf_np)
    both = tuple(torch.cat([a, b]) for a, b in zip(pts, inf))
    q = tuple(c[0] for c in cases.g2_points([g2_affine_ints(Q)], "cpu"))
    e = pairing(both, q)
    assert e.shape == (2, 2, 3, 2, 24)
    assert _fp12_ints(e[0]) == gold.pairing(P, Q)
    assert _fp12_ints(e[1]) == gold.Fp12.one()


def test_pairing_bilinear():
    """e([a] P, Q) == e(P, [a] Q), two points on one batch axis."""
    rng = random.Random(0x94)
    a = rng.randrange(1, gold.R)
    P = gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
    Q = gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
    lhs = pairing(cases.g1_points([gold.g1_affine(gold.g1_mul(P, a))], "cpu"),
                  tuple(c[0] for c in cases.g2_points([g2_affine_ints(Q)],
                                                      "cpu")))
    rhs = pairing(cases.g1_points([gold.g1_affine(P)], "cpu"),
                  tuple(c[0] for c in cases.g2_points(
                      [g2_affine_ints(gold.g2_mul(Q, a))], "cpu")))
    assert torch.equal(lhs, rhs)
