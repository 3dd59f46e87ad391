"""The port's scalar multiplications on the CPU: the windowed ladder and
the 256-step ladder of the trailing-layout curves of
``curve/weierstrass.py`` (``curve/g1.py``'s G1, and G2) and the
limb-major windowed ladder of ``curve/weierstrass_lm.py``, against the
JAX package's ``CurveOps`` and the golden model, on the KAT scalars (0,
1, 2, 3, 7, 0xdeadbeef, r - 1) and more (r - 2, r itself, a top bit
set).  `mul_int`, `reduce_sum`, `msm_naive` and `in_subgroup` are in
test_torch_ladder_ops.py.

Tolerances: the 256-step ladder equals the JAX package's bit for bit
(the same adds in the same order); the windowed ladder and every
comparison with golden or the KAT in affine form (the compressed
bytes)."""

import json
import os
import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.curve.g1 import G1 as JG1
from tpukzg.curve.g2 import G2 as JG2

from torch_cases import REPO
from tpukzg_torch.curve import g1 as g1m, g2 as g2m
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.field.mont import FP, FR, P_MOD, ints_to_limbs

torch.set_num_threads(1)

with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as _fh:
    KAT = json.load(_fh)
KEYS = [int(k) for k in KAT["g1_multiples"]]
EXTRA = [gold.R - 2, gold.R, (1 << 255) + 0x1234567, (1 << 254) | 1]
# scalars as raw 16-bit limbs: r itself is not reduced (its multiple is
# infinity by the group law, as 0's)
KS = torch.as_tensor(ints_to_limbs(KEYS + EXTRA, 16))


def g1_bytes(p):
    return g1m.compress_points(p)


def g2_bytes(p):
    lead = p[0].shape[:-2]
    flat = tuple(c.reshape((-1, 2, 24)) for c in p)
    return [g2m.compress_point(tuple(c[i] for c in flat))
            for i in range(flat[0].shape[0])] if lead else \
        [g2m.compress_point(p)]


def want_g1(ks, base=gold.G1_GEN):
    return [gold.g1_compress(gold.g1_mul(base, k % gold.R)) for k in ks]


def want_g2(ks, base=gold.G2_GEN):
    return [gold.g2_compress(gold.g2_mul(base, k % gold.R)) for k in ks]


def test_g1_windowed_vs_ladder_jax_and_kat():
    """G1: the windowed ladder equals the KAT's multiples and golden's in
    affine form; the 256-step ladder (what `scalar_mul` runs on the CPU)
    equals the JAX ladder limb for limb."""
    n = len(KEYS) + len(EXTRA)
    gen = G1.gen((n,), "cpu")
    win = g1_bytes(G1.scalar_mul_windowed(gen, KS))
    assert win[:len(KEYS)] == [bytes.fromhex(KAT["g1_multiples"][str(k)])
                               for k in KEYS]
    assert win == want_g1(KEYS + EXTRA)
    ladder = G1.scalar_mul(gen, KS)
    jl = JG1.scalar_mul_ladder(JG1.gen((n,)), KS.numpy().astype(np.uint32))
    for a, b in zip(ladder, jl):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))
    assert all(torch.equal(a, b) for a, b in zip(
        G1.scalar_mul_ladder(tuple(c[:2] for c in gen), KS[:2]),
        tuple(c[:2] for c in ladder)))


def test_g1_lm_windowed_vs_ladder_and_kat():
    """The limb-major windowed ladder (the card's G1 path) against the
    limb-major ladder and the KAT, on a broadcast: one point, n
    scalars."""
    gen = tuple(torch.as_tensor(c)[:, None] for c in g1m.GEN_NP)
    win = G1_LM.scalar_mul_windowed(gen, KS)
    assert win[0].shape == (24, len(KS))
    assert bool(G1_LM.eq(win, G1_LM.scalar_mul_ladder(gen, KS)).all())
    assert g1_bytes(tuple(c.movedim(0, -1) for c in win)) == \
        want_g1(KEYS + EXTRA)


def test_g2_windowed_vs_ladder_jax_and_kat():
    """G2 on the KAT's scalars and r: as G1's test."""
    kat = KAT["g2_multiples"]
    keys = [int(k) for k in kat] + [gold.R]
    ks = torch.as_tensor(ints_to_limbs(keys, 16))
    gen = G2.gen((len(keys),), "cpu")
    win = g2_bytes(G2.scalar_mul_windowed(gen, ks))
    assert win[:-1] == [bytes.fromhex(v) for v in kat.values()]
    assert win == want_g2(keys)
    ladder = G2.scalar_mul(gen, ks)
    jl = JG2.scalar_mul_ladder(JG2.gen((len(keys),)),
                               ks.numpy().astype(np.uint32))
    for a, b in zip(ladder, jl):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int32))


@pytest.mark.parametrize("w", [1, 2, 8])
def test_windowed_other_windows(w):
    """Other windows (16 % w == 0) and a broadcast of points (3,) against
    scalars (2, 1)."""
    rng = random.Random(w)
    ps = [gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R))
          for _ in range(3)]
    pts = g1m.decompress_batch([gold.g1_compress(p) for p in ps], "cpu")[0]
    ks = [rng.randrange(gold.R), gold.R - 1]
    out = G1.scalar_mul_windowed(pts, torch.as_tensor(
        FR.from_int(ks)).reshape(2, 1, 16), w)
    assert out[0].shape == (2, 3, 24)
    assert g1_bytes(tuple(c.reshape(6, 24) for c in out)) == [
        gold.g1_compress(gold.g1_mul(p, k)) for k in ks for p in ps]
    with pytest.raises(ValueError):
        G1.scalar_mul_windowed(pts, torch.as_tensor(FR.from_int(ks)), 3)
