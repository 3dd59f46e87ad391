"""The MSMs' one core on the CPU (`pippenger_lm._msm_rows`): each pass's
bucket totals add into their slots (`pippenger_lm._fold`) before one
window sum a call.  The public msm over G1 is held against the generic
trailing-layout `Pippenger(G1)` and golden's direct sum, and over G2
against golden's sum, at one chunk, three and eight (the last padded);
every entry point (msm, msm_grouped, msm_batch, msm_fixed) runs one
window sum on its slots' buckets and gives golden's sums, and
passes of three rows that end inside the slots' list (and, for msm,
inside a slot) give golden's sums.  Tolerance: points equal in affine
form (projective coordinates depend on the order of the additions)."""

import functools
import random

import pytest
import torch

import golden.model as gold
from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN, G2_LM, G2_LM_PLAIN
from tpukzg_torch.field.mont import FP, FR
from tpukzg_torch.kernels import bucket, ec
from tpukzg_torch.msm import pippenger_lm
from tpukzg_torch.msm.pippenger import Pippenger

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


@functools.lru_cache(maxsize=1)
def _gold_pool():
    """srs_points() as golden G1 points."""
    x, y, _ = g1m.normalize(tuple(torch.as_tensor(c.T.copy())
                                  for c in srs_points()))
    return [gold.g1_from_affine(xy) for xy in zip(
        FP.to_int(FP.from_mont(x)), FP.to_int(FP.from_mont(y)))]


def _golden(idx, ks):
    """golden's direct sum sum_i [k_i] P_idx[i] over srs_points() ->
    coords (24,) (Z = 1; (0, 1, 0) for infinity)."""
    xy = gold.g1_affine(gold.g1_msm([_gold_pool()[i] for i in idx], ks))
    return tuple(torch.as_tensor(FP.to_mont_host(v))
                 for v in ((0, 1, 0) if xy is None else (*xy, 1)))


def _same(curve, a, b) -> bool:
    return bool(curve.eq(tuple(c[:, None] for c in a),
                         tuple(c[:, None] for c in b)).all())


@pytest.mark.parametrize("chunk", CHUNKS)
def test_msm_fold_g1_vs_grouped_route(chunk):
    """G1: msm over 37 points (a zero scalar, repeated points) at c = 4
    equals the generic Pippenger(G1) over the same points (its own
    trailing-layout scan and window sums) and golden's direct sum, in
    affine form."""
    pts, k, idx, ks = _case(N, srs_points(), chunk)
    got = pippenger_lm.msm(pts, k, c=4, point_chunk=chunk)
    assert _same(G1_LM_PLAIN, got, Pippenger(G1).msm(pts, k, c=4))
    assert _same(G1_LM_PLAIN, got, _golden(idx, ks))


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


def _entry(entry, pts, k, chunk, c):
    """One entry point of pippenger_lm on the case: (its results, the
    slots of its window sum, G, the scalar rows (n, 16) of its MSMs, the
    point slices (start, end) they run over)."""
    n, W = k.shape[0], -(-256 // c)
    rows = torch.stack([k, k.roll(1, 0), k.flip(0)])     # msm_batch, fixed
    if entry == "msm":
        G = -(-n // min(n, chunk))
        return ([pippenger_lm.msm(pts, k, c=c, point_chunk=chunk)], W, G,
                [k], [(0, n)])
    if entry == "grouped":
        got = pippenger_lm.msm_grouped(pts, k, (4, 7), c)
        return got, 2 * W, 1, [k[:4], k[4:]], [(0, 4), (4, n)]
    if entry == "batch":
        out = pippenger_lm.msm_batch(pts, rows, c)
    else:
        out = pippenger_lm.msm_fixed(pippenger_lm.build_fixed_table(pts, c),
                                     rows, c)
    return ([tuple(x[i] for x in out) for i in range(3)],
            3 * W if entry == "batch" else 3, 1, list(rows), [(0, n)] * 3)


@pytest.mark.parametrize("entry,n,chunk", [
    pytest.param("msm", 11, 16, id="11-16"),
    pytest.param("msm", 11, 4, id="11-4"),
    pytest.param("msm", 20, 5, id="20-5"),
    pytest.param("grouped", 11, None, id="grouped"),
    pytest.param("batch", 11, None, id="batch"),
    pytest.param("fixed", 11, None, id="fixed")])
def test_msm_one_window_sum_a_call(monkeypatch, entry, n, chunk):
    """Each entry point runs one window sum a call, on its slots' 2^c - 1
    buckets (msm: a slot a window; msm_grouped and msm_batch: a window
    of an MSM; msm_fixed: an MSM), and the fold adds G - 1 rows into each
    slot: W (G - 1) rows for msm over G chunks, none for the others.
    Each result equals golden's direct sum in affine form."""
    c = 4
    sums, adds = [], []
    real_ws, real_add = bucket.window_sum, ec.ec_add

    def window_sum(b):
        sums.append(tuple(b[0].shape))
        return real_ws(b)

    def ec_add(p, q, counted_as="ec_add"):
        if counted_as == "bucket_fold":
            adds.append(p[0][0].numel() // p[0].shape[-1])
        return real_add(p, q, counted_as)

    monkeypatch.setattr(bucket, "window_sum", window_sum)
    monkeypatch.setattr(ec, "ec_add", ec_add)
    pts, k, idx, _ = _case(n, srs_points(), n + (chunk or 0))
    got, slots, G, rows, spans = _entry(entry, pts, k, chunk, c)
    assert sums == [(24, slots, (1 << c) - 1)]
    assert sum(adds) == (slots * (G - 1) if entry == "msm" else 0)
    for p, ks, (s, e) in zip(got, rows, spans):
        assert _same(G1_LM_PLAIN, p, _golden(idx[s:e], FR.to_int(ks)))


def test_msm_passes_end_inside_slots(monkeypatch):
    """TPUKZG_MSM_WINDOW_CHUNK=3: passes of three rows end inside the
    slots' list (msm_batch's 3 W rows, a window's three MSMs cut across
    passes; msm_fixed's 4 rows, a pass of 3 then one of 1) and inside
    msm's slots of G = 4 chunks (a slot's rows split over two passes,
    whole slots in others); each result equals golden's direct sum in
    affine form."""
    monkeypatch.setenv("TPUKZG_MSM_WINDOW_CHUNK", "3")
    c, n = 4, 11
    passes = []
    real_scan = bucket.seg_scan

    def seg_scan(pts, seg):
        passes.append(seg.shape[0])
        return real_scan(pts, seg)

    monkeypatch.setattr(bucket, "seg_scan", seg_scan)
    pts, k, idx, _ = _case(n, srs_points(), 0x5117)
    rows = torch.stack([k, k.roll(1, 0), k.flip(0), k.roll(5, 0)])
    ints = [FR.to_int(r) for r in rows]
    batch = pippenger_lm.msm_batch(pts, rows[:3], c)
    fixed = pippenger_lm.msm_fixed(pippenger_lm.build_fixed_table(pts, c),
                                   rows, c)
    one = pippenger_lm.msm(pts, k, c=c, point_chunk=3)
    W = -(-256 // c)
    assert passes == ([3] * W + [3, 1] + [3] * (4 * W // 3) + [1])
    for out, m in ((batch, 3), (fixed, 4)):
        for i in range(m):
            assert _same(G1_LM_PLAIN, tuple(x[i] for x in out),
                         _golden(idx, ints[i]))
    assert _same(G1_LM_PLAIN, one, _golden(idx, ints[0]))
