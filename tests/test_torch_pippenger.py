"""The port's generic Pippenger (``msm/pippenger.py``) over G1 and G2 on
the CPU, against the JAX package's ``Pippenger(G1)`` and the golden
model; the shared-point batch MSM (``pippenger_lm.msm_batch``) against
one ``msm`` a row.  Tolerance: points equal in affine form (the MSMs add
in another order than the JAX one and than each other).  The full
pairing's tests are in test_torch_pairing.py."""

import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.curve import g1 as jg1
from tpukzg.curve.g1 import G1 as JG1
from tpukzg.field.mont import FR as JFR
from tpukzg.msm.pippenger import Pippenger as JPippenger

import torch_dist_cases as cases
from tpukzg_torch.curve import g1 as g1m, g2 as g2m
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.msm import pippenger_lm
from tpukzg_torch.msm.pippenger import Pippenger

N = 32


def g2_affine_ints(p):
    a = gold.g2_affine(p)
    return None if a is None else ((a[0].c0, a[0].c1), (a[1].c0, a[1].c1))


@pytest.fixture(scope="module")
def case():
    rng = random.Random(0x91)
    ks = [rng.randrange(gold.R) for _ in range(N)]
    ks[:3] = [0, 1, gold.R - 1]
    p1 = [gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
          for _ in range(N)]
    p2 = [gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
          for _ in range(N)]
    return ks, p1, p2


def test_pippenger_g1_vs_jax_and_golden(case):
    ks, p1, _ = case
    aff = [gold.g1_affine(p) for p in p1]
    want = gold.g1_affine(gold.g1_msm(p1, ks))
    got = Pippenger(G1).msm(cases.g1_points(aff, "cpu"),
                            cases.scalars(ks, "cpu"), c=4)
    assert g1m.point_to_ints(got) == want + (False,)
    jp = jg1.points_from_ints([a[0] for a in aff], [a[1] for a in aff],
                              [False] * N)
    x, y, inf = jg1.point_to_ints(JPippenger(JG1).msm(
        jp, np.asarray(JFR.from_int(ks)), c=4))
    assert (x, y) == want and not bool(inf)


@pytest.mark.parametrize("c", [4, 5])
def test_pippenger_g2_vs_golden(case, c):
    """Over G2 (tensor code), 16 points; c = 5 leaves a ragged last
    window."""
    ks, _, p2 = case
    ks, p2 = ks[:16], p2[:16]
    want = gold.G2_INF
    for p, k in zip(p2, ks):
        want = gold.g2_add(want, gold.g2_mul(p, k))
    pts = cases.g2_points([g2_affine_ints(p) for p in p2], "cpu")
    got = Pippenger(G2).msm(pts, cases.scalars(ks, "cpu"), c=c)
    x, y, inf = g2m.point_to_ints(got)
    assert (x, y) == g2_affine_ints(want) and not inf


def test_pippenger_grouped_and_empty(case):
    """`_msm_grouped` is one MSM a slice; no points give infinity."""
    ks, p1, _ = case
    ks, p1 = ks[3:19], p1[3:19]
    pts = cases.g1_points([gold.g1_affine(p) for p in p1], "cpu")
    sc = cases.scalars(ks, "cpu")
    pip = Pippenger(G1, window_chunk=24)
    a, b = pip._msm_grouped(pts, sc, groups=(6, 10), c=4)
    assert g1m.point_to_ints(a)[:2] == gold.g1_affine(gold.g1_msm(
        p1[:6], ks[:6]))
    assert g1m.point_to_ints(b)[:2] == gold.g1_affine(gold.g1_msm(
        p1[6:], ks[6:]))
    empty = pip.msm(tuple(c[:0] for c in pts), sc[:0], c=4)
    assert g1m.point_to_ints(empty)[2]


def test_msm_batch_vs_msm(case):
    """k = 3 scalar rows over one list of 16 points (a zero row among
    them) against one `msm` a row, and golden."""
    ks, p1, _ = case
    n = 16
    ks, p1 = ks[:n], p1[:n]
    rng = random.Random(0x92)
    rows = [ks, [rng.randrange(gold.R) for _ in range(n)], [0] * n]
    pts = cases.g1_points([gold.g1_affine(p) for p in p1], "cpu")
    sc = torch.stack([cases.scalars(r, "cpu") for r in rows])
    out = pippenger_lm.msm_batch(pts, sc, c=4)
    assert out[0].shape == (3, 24)
    for i, r in enumerate(rows):
        got = g1m.point_to_ints(tuple(c[i] for c in out))
        assert got == g1m.point_to_ints(pippenger_lm.msm(pts, sc[i], c=4))
        want = gold.g1_affine(gold.g1_msm(p1, r))
        assert got == ((0, 0, True) if want is None else want + (False,))
    assert pippenger_lm.msm_batch(pts, sc[:0])[0].shape == (0, 24)
