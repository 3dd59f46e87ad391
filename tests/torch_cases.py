"""Inputs shared by the port's kernel tests on the CPU
(test_torch_kernels.py) and on a card (test_torch_cuda.py).  Imports
neither JAX nor the JAX package, so the card tests can run without them.
G2 inputs come from the golden model (plain Python integers)."""

import functools
import os
import random

import numpy as np
import torch

from tpukzg_torch.field.mont import FP, FR

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRS16 = os.path.join(REPO, ".srs_cache", "srs_16_436c40aaaab022da.npz")


def srs_points():
    """The 32 G1 points of the n=16 SRS, limb-major (24, 32) int32."""
    with np.load(SRS16) as z:
        return tuple(np.concatenate([z[f"lag_{i}"], z[f"mono_{i}"]]).T
                     .astype(np.int32).copy() for i in range(3))


def g2_limbs(points):
    """Golden G2 points (Jacobian) -> limb-major (48, n) int32 Montgomery
    coords of their affine form (c0's 24 limbs, then c1's; Z = 1, or
    the point at infinity (0, 1, 0))."""
    import golden.model as gold
    cols = ([], [], [])
    for p in points:
        a = gold.g2_affine(p)
        vals = (((0, 0), (1, 0), (0, 0)) if a is None else
                ((a[0].c0, a[0].c1), (a[1].c0, a[1].c1), (1, 0)))
        for c, (v0, v1) in zip(cols, vals):
            c.append(np.concatenate([FP.to_mont_host(v0),
                                     FP.to_mont_host(v1)]))
    return tuple(np.stack(c, 1).astype(np.int32) for c in cols)


@functools.lru_cache(maxsize=1)
def _g2_pool():
    import golden.model as gold
    rng = random.Random(0x6202)
    return g2_limbs([gold.g2_mul(gold.G2_GEN, rng.randrange(1, gold.R))
                     for _ in range(32)])


def g2_points():
    """32 G2 points [s_i] G2 of seeded logs, limb-major (48, 32) int32
    (the G2 counterpart of srs_points)."""
    return tuple(c.copy() for c in _g2_pool())


def inf_limbs(L):
    """The point at infinity (0, 1, 0) in L limbs (24 G1, 48 G2)."""
    one = np.zeros(L, np.int32)
    one[:24] = FP.one_mont
    return (np.zeros(L, np.int32), one, np.zeros(L, np.int32))


def operands(F, seed, n):
    """(L, n) limb-major pairs; lanes 0-2 of `a` are R - 1 (all 0xFFFF,
    the carry-stress input), p - 1 and 0."""
    rng = random.Random(seed)
    a = np.stack([F.from_int(rng.randrange(F.modulus))
                  for _ in range(n)]).T.copy()
    b = np.roll(a, 1, axis=1).copy()
    a[:, 0] = 0xFFFF
    a[:, 1] = F.from_int(F.modulus - 1)
    a[:, 2] = 0
    return a, b


def ec_inputs(pool=None):
    """16 lanes of P + Q over SRS points (or the 32 points of `pool`, G1
    or G2), with P + P (lane 0), P + (-P) (1), inf + Q (2), P + inf (3)
    and inf + inf (4)."""
    pts = srs_points() if pool is None else pool
    L = pts[0].shape[0]
    p = [c[:, :16].copy() for c in pts]
    q = [c[:, 16:].copy() for c in pts]
    inf = inf_limbs(L)
    for c in range(3):
        q[c][:, 0] = p[c][:, 0]
        q[c][:, 1] = p[c][:, 1]
        p[c][:, 2] = inf[c]
        q[c][:, 3] = inf[c]
        p[c][:, 4] = inf[c]
        q[c][:, 4] = inf[c]
    y = torch.from_numpy(p[1][:, 1].reshape(L // 24, 24))
    q[1][:, 1] = FP.neg(y).numpy().reshape(L)
    return tuple(p), tuple(q)


def scan_inputs(g, n, seed, nkeys=5, pool=None):
    """(L, g, n) coords drawn from the SRS points (or `pool`) and (g, n)
    sorted keys."""
    pts = srs_points() if pool is None else pool
    L = pts[0].shape[0]
    nprng = np.random.default_rng(seed)
    idx = nprng.integers(0, pts[0].shape[1], size=g * n)
    coords = tuple(c[:, idx].reshape(L, g, n).copy() for c in pts)
    seg = np.sort(nprng.integers(0, nkeys, size=(g, n)), -1).astype(np.int32)
    return coords, seg


def window_inputs(g, n, seed, pool=None):
    """(L, g, n) bucket coords for the window sum: SRS points (or those
    of `pool`; drawn with repeats), about one bucket in five empty
    (infinity), the top two buckets of row 0 equal and the one below them
    empty (so the walk's R += S and A += R meet the doubling case), and,
    from two rows on, the last row all infinity."""
    pts = srs_points() if pool is None else pool
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, pts[0].shape[1], size=(g, n))
    idx[0, n - 2:] = idx[0, n - 1]
    coords = [c[:, idx].copy() for c in pts]
    empty = rng.random((g, n)) < 0.2
    empty[0, n - 2:] = False
    empty[0, max(n - 3, 0)] = n >= 3
    if g >= 2:
        empty[-1] = True
    inf = inf_limbs(pts[0].shape[0])
    for c, v in zip(coords, inf):
        c[:, empty] = v[:, None]
    return tuple(coords)


def chunk_scan_inputs(seed):
    """(24, 5, 31) coords from the SRS points under five rows of sorted
    keys that probe a chunked scan: digit-0 lanes and a segment of 20
    lanes (spanning >= 3 chunks of up to 8 lanes); segments of 4 (chunk
    edges on segment edges) and of 5 lanes (off them); all keys equal
    (the suffix scan's single segment); all keys distinct."""
    n = 31
    pts, _ = scan_inputs(5, n, seed)
    lane = np.arange(n)
    seg = np.stack([np.where(lane < 3, 0, np.where(lane < 23, 1, 2)),
                    lane // 4, lane // 5, np.zeros(n, np.int64),
                    lane]).astype(np.int32)
    return pts, seg


def ntt_inputs(k, n, seed):
    """(k, n, 16) Montgomery Fr limbs, int32; the first three elements of
    polynomial 0 are 0, 1 and r - 1."""
    rng = random.Random(seed)
    vals = [rng.randrange(FR.modulus) for _ in range(k * n)]
    vals[:3] = [0, 1, FR.modulus - 1][:len(vals)]
    return FR.to_mont_host(vals).reshape(k, n, 16)


def long_row_scan_inputs(g, n, seed, pool=None):
    """Rows shaped like the fixed-base MSM's (98,304 lanes under 2^11 - 1
    bucket keys: ~48 lanes a segment): n lanes, many 768-lane tiles, of
    SRS points (or `pool`'s) under sorted keys with ~48 lanes a key, so
    segments span tile edges."""
    return scan_inputs(g, n, seed, nkeys=max(1, n // 48), pool=pool)


def golden_triples(n, count, seed):
    """`count` random blobs of n elements with their commitments and
    proofs by the golden model (imported here: the card tests load this
    module without it) -> (blobs, commitments, proofs) as bytes."""
    import golden.model as gold
    gs = gold.GoldenSetup(0xDEADBEEF, n)
    rng = random.Random(seed)
    blobs = [b"".join(rng.randrange(gold.R).to_bytes(32, "big")
                      for _ in range(n)) for _ in range(count)]
    cs = [gold.g1_compress(gold.blob_to_kzg_commitment(
        gs, gold.blob_from_bytes(b))) for b in blobs]
    pfs = [gold.g1_compress(gold.compute_blob_kzg_proof(
        gs, gold.blob_from_bytes(b), c)[0]) for b, c in zip(blobs, cs)]
    return blobs, cs, pfs


def golden_verdict(n, blobs, cs, pfs) -> bool:
    """golden.verify_blob_kzg_proof_batch, False where it refuses an
    input while decoding (ValueError) and for a blob of the wrong length
    (which it asserts against)."""
    import golden.model as gold
    if any(len(b) != 32 * n for b in blobs):
        return False
    gs = gold.GoldenSetup(0xDEADBEEF, n)
    try:
        return gold.verify_blob_kzg_proof_batch(
            gs, [gold.blob_from_bytes(b) for b in blobs], cs, pfs)
    except ValueError:
        return False


def off_curve_encoding() -> bytes:
    """A well-formed 48-byte G1 encoding whose x has x^3 + 4 no square:
    no point of the curve has it."""
    p, x = FP.modulus, 3
    while pow((x ** 3 + 4) % p, (p - 1) // 2, p) == 1:
        x += 1
    return bytes([x.to_bytes(48, "big")[0] | 0x80]) + x.to_bytes(48, "big")[1:]


BATCH_CASES = ("valid", "tampered", "swapped", "element_ge_r", "off_curve",
               "malformed", "wrong_length", "empty")


def batch_case(case, triples, n):
    """The batch of `triples` (three blobs) for one verdict case:
    tampered — a flipped bit of proof 1 (on the curve, outside G1);
    swapped — proofs 0 and 1 exchanged (refused by the pairing);
    element_ge_r — blob 1 all 0xFF; off_curve — commitment 1 has no
    point; malformed — commitment 1 without the compression flag;
    wrong_length — blob 1 one element short; empty — no blobs."""
    blobs, cs, pfs = (list(x) for x in triples)
    if case == "tampered":
        bad = bytearray(pfs[1])
        bad[13] ^= 4
        pfs[1] = bytes(bad)
    elif case == "swapped":
        pfs[0], pfs[1] = pfs[1], pfs[0]
    elif case == "element_ge_r":
        blobs[1] = b"\xff" * (32 * n)
    elif case == "off_curve":
        cs[1] = off_curve_encoding()
    elif case == "malformed":
        cs[1] = b"\x00" * 48
    elif case == "wrong_length":
        blobs[1] = blobs[1][:-32]
    elif case == "empty":
        blobs, cs, pfs = [], [], []
    return blobs, cs, pfs
