"""The public msm's route on the CPU: the point chunks' bucket totals add
up by window (`pippenger_lm._fold`) before one window sum over the W
windows.  Held against the route it replaced (one window sum a chunk's
rows, the chunks' partial results added) over G1 and against golden's
direct sum over G2, at one chunk, three and eight (the last padded).
Tolerance: points equal in affine form (projective coordinates depend on
the order of the additions)."""

import random

import pytest
import torch

import golden.model as gold
from tpukzg_torch.curve.weierstrass_lm import (G1_LM, G1_LM_PLAIN, G2_LM,
                                               G2_LM_PLAIN)
from tpukzg_torch.field.mont import FR
from tpukzg_torch.kernels import bucket, ec
from tpukzg_torch.msm import pippenger_lm

from torch_cases import g2_limbs, srs_points

torch.set_num_threads(1)

N = 37                           # points: a padded last chunk at 16 and 5
CHUNKS = [64, 16, 5]             # one chunk, three, eight


def _case(n, pool, seed):
    """n points drawn from the (L, m) pool with repeats and seeded scalars
    (one zero) -> (points (n, L) coords, scalars (n, 16), pool indices,
    the scalars as integers)."""
    rng = random.Random(seed)
    idx = [rng.randrange(pool[0].shape[1]) for _ in range(n)]
    ks = [rng.randrange(FR.modulus) for _ in range(n)]
    ks[4] = 0
    pts = tuple(torch.as_tensor(c[:, idx].T.copy()) for c in pool)
    return pts, torch.as_tensor(FR.from_int(ks)), idx, ks


def _grouped_route(points, scalars, chunk, c, curve):
    """The route `msm` took before the fold: the chunks as the groups of
    one grouped MSM (a window sum over each chunk's rows), then one add a
    chunk."""
    n = scalars.shape[0]
    m = min(n, chunk)
    pad = -(-n // m) * m - n
    pts = tuple(torch.nn.functional.pad(p, (0, 0, 0, pad)) for p in points)
    ks = torch.nn.functional.pad(scalars, (0, 0, 0, pad))
    parts = pippenger_lm.msm_grouped(pts, ks, (m,) * (-(-n // m)), c, curve)
    acc = parts[0]
    for part in parts[1:]:
        acc = curve.add(acc, part)
    return acc


def _same(curve, a, b) -> bool:
    return bool(curve.eq(tuple(c[:, None] for c in a),
                         tuple(c[:, None] for c in b)).all())


@pytest.mark.parametrize("chunk", CHUNKS)
def test_msm_fold_g1_vs_grouped_route(chunk):
    """G1: msm over 37 points (a zero scalar, repeated points) at c = 4
    equals the grouped route over the same chunks in affine form."""
    pts, k, _, _ = _case(N, srs_points(), chunk)
    got = pippenger_lm.msm(pts, k, c=4, point_chunk=chunk)
    want = _grouped_route(pts, k, chunk, 4, G1_LM)
    assert _same(G1_LM_PLAIN, got, want)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_msm_fold_g2_vs_golden(chunk):
    """G2: msm over 37 points drawn from 6 golden points [s_j] G2 (a zero
    scalar) at c = 4 equals golden's sum_j [sum of k_i at P_j] P_j."""
    rng = random.Random(0xF01D)
    base = [gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
            for _ in range(6)]
    pts, k, idx, ks = _case(N, g2_limbs(base), chunk)
    want = gold.G2_INF
    for j, p in enumerate(base):
        want = gold.g2_add(want, gold.g2_mul(
            p, sum(kk for i, kk in zip(idx, ks) if i == j) % gold.R))
    got = pippenger_lm.msm(pts, k, c=4, point_chunk=chunk, curve=G2_LM)
    want = tuple(torch.as_tensor(c)[:, 0] for c in g2_limbs([want]))
    assert _same(G2_LM_PLAIN, got, want)


@pytest.mark.parametrize("n,chunk", [(11, 16), (11, 4), (20, 5)])
def test_msm_one_window_sum_a_call(monkeypatch, n, chunk):
    """One msm call runs one window sum, on its W rows of 2^c - 1
    buckets, and the fold adds G - 1 rows into each window (G chunks):
    none at one chunk."""
    c = 4
    W, G = -(-256 // c), -(-n // min(n, chunk))
    sums, adds = [], []
    real_ws, real_add = bucket.window_sum, ec.ec_add

    def window_sum(b):
        sums.append(tuple(b[0].shape))
        return real_ws(b)

    def ec_add(p, q, counted_as="ec_add"):
        if counted_as == "bucket_fold":
            adds.append(p[0].shape[1])
        return real_add(p, q, counted_as)

    monkeypatch.setattr(bucket, "window_sum", window_sum)
    monkeypatch.setattr(ec, "ec_add", ec_add)
    pts, k, _, _ = _case(n, srs_points(), n + chunk)
    got = pippenger_lm.msm(pts, k, c=c, point_chunk=chunk)
    assert sums == [(24, W, (1 << c) - 1)]
    assert sum(adds) == W * (G - 1)
    want = _grouped_route(pts, k, chunk, c, G1_LM)
    assert _same(G1_LM_PLAIN, got, want)
