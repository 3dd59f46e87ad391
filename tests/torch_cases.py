"""Inputs shared by the port's kernel tests on the CPU
(test_torch_kernels.py) and on a card (test_torch_cuda.py).  Imports
neither JAX nor the JAX package, so the card tests can run without them."""

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


def ec_inputs():
    """16 lanes of P + Q over SRS points, with P + P (lane 0),
    P + (-P) (1), inf + Q (2), P + inf (3) and inf + inf (4)."""
    pts = srs_points()
    p = [c[:, :16].copy() for c in pts]
    q = [c[:, 16:].copy() for c in pts]
    inf = (np.zeros(24, np.int32), FP.one_mont, np.zeros(24, np.int32))
    for c in range(3):
        q[c][:, 0] = p[c][:, 0]
        q[c][:, 1] = p[c][:, 1]
        p[c][:, 2] = inf[c]
        q[c][:, 3] = inf[c]
        p[c][:, 4] = inf[c]
        q[c][:, 4] = inf[c]
    q[1][:, 1] = FP.neg(torch.from_numpy(p[1][:, 1])).numpy()
    return tuple(p), tuple(q)


def scan_inputs(g, n, seed, nkeys=5):
    """(24, g, n) coords drawn from the SRS points and (g, n) sorted keys."""
    pts = srs_points()
    nprng = np.random.default_rng(seed)
    idx = nprng.integers(0, pts[0].shape[1], size=g * n)
    coords = tuple(c[:, idx].reshape(24, g, n).copy() for c in pts)
    seg = np.sort(nprng.integers(0, nkeys, size=(g, n)), -1).astype(np.int32)
    return coords, seg


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


def long_row_scan_inputs(g, n, seed):
    """Rows shaped like the fixed-base MSM's (98,304 lanes under 2^11 - 1
    bucket keys: ~48 lanes a segment): n lanes, many 768-lane tiles, of
    SRS points under sorted keys with ~48 lanes a key, so segments span
    tile edges."""
    return scan_inputs(g, n, seed, nkeys=max(1, n // 48))
