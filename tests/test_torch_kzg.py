"""The port's grouped MSM and pairing check against the JAX package and
the golden model, on the CPU.  Tolerances: MSM results affine-equal
(projective coordinates depend on the order of additions); pairing
verdicts equal."""

import functools
import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.field.mont import FR
from tpukzg_torch.kzg.setup import Setup
from tpukzg_torch.msm.pippenger_lm import default_window, msm_grouped
from tpukzg_torch.pairing.check import pairing_check

TAU = 0xDEADBEEF

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _affine(pt):
    return tg1.point_to_ints(pt)


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random(31)
    gpts = [gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
            for _ in range(7)]
    scal = [rng.randrange(gold.R) for _ in range(7)]
    scal[3] = 0                                          # an inert term
    pts, ok = tg1.decompress_batch([gold.g1_compress(p) for p in gpts],
                                   "cpu")
    assert bool(ok.all())
    return gpts, scal, pts, torch.from_numpy(FR.from_int(scal))


def test_grouped_msm_vs_jax_and_golden(msm_case):
    import jax
    from tpukzg.msm.pippenger_lm import PippengerLM
    gpts, scal, pts, s = msm_case
    groups = (3, 4)
    c = default_window(7)
    got = msm_grouped(pts, s, groups=groups, c=c)
    want = [gold.g1_affine(gold.g1_msm(gpts[:3], scal[:3])),
            gold.g1_affine(gold.g1_msm(gpts[3:], scal[3:]))]
    pip = PippengerLM()
    ref = jax.jit(functools.partial(pip._msm_grouped, groups=groups, c=c))(
        tuple(x.numpy().astype(np.uint32) for x in pts),
        s.numpy().astype(np.uint32))
    for i in range(2):
        x, y, inf = _affine(got[i])
        assert (x, y) == want[i] and not inf
        r = tuple(torch.from_numpy(np.asarray(v).astype(np.int32))
                  for v in ref[i])
        assert _affine(r)[:2] == want[i]


def test_grouped_msm_zero_scalars_give_infinity(msm_case):
    _, _, pts, s = msm_case
    got = msm_grouped(pts, torch.zeros_like(s), groups=(3, 4), c=4)
    assert all(_affine(p)[2] for p in got)


@pytest.fixture(scope="module")
def setup16():
    return Setup.generate_insecure(TAU, 16, device="cpu")


def _pt(gp):
    pts, _ = tg1.decompress_batch([gold.g1_compress(gp)], "cpu")
    return tuple(c[0] for c in pts)


@pytest.mark.parametrize("delta", [0, 1], ids=["bilinear", "off-by-one"])
def test_pairing_check_bilinearity_vs_golden(setup16, delta):
    """e([tau s] G1, [1]_2) * e(-[s + delta] G1, [tau]_2) == 1 iff delta = 0."""
    s = 0x1234567
    a = gold.g1_mul(gold.G1_GEN, TAU * s % gold.R)
    b = gold.g1_neg(gold.g1_mul(gold.G1_GEN, s + delta))
    got = pairing_check([(_pt(a), setup16.lines_gen),
                         (_pt(b), setup16.lines_tau)])
    want = gold.pairing_check([(a, gold.G2_GEN),
                               (b, gold.g2_mul(gold.G2_GEN, TAU))])
    assert bool(got) == want == (delta == 0)


def test_pairing_check_infinity_is_one(setup16):
    inf = tuple(torch.from_numpy(c) for c in tg1.INF_NP)
    assert bool(pairing_check([(inf, setup16.lines_gen),
                               (inf, setup16.lines_tau)]))
