"""The benchmark's (blob, commitment, proof) fixtures, numpy only.

`gen_blobs` is a copy of ``bench.py::gen_blobs`` (the blobs are made
again from the seed stored in the fixture file); the commitments and
proofs come from ``bench/fixtures/triples_n{n}_d{d}.npz``.
"""

from __future__ import annotations

import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def gen_blobs(n: int, d: int, seed: int) -> list[bytes]:
    """d deterministic blobs of n 32-byte big-endian Fr elements; the top
    16-bit limb is masked to 14 bits, so every element is below r."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(d, n, 16), dtype=np.uint32)
    limbs[..., 0] &= 0x3FFF
    b = np.empty((d, n, 32), np.uint8)
    b[..., 0::2] = (limbs >> 8).astype(np.uint8)
    b[..., 1::2] = (limbs & 0xFF).astype(np.uint8)
    return [b[i].tobytes() for i in range(d)]


def fixture_path(n: int, distinct: int) -> str:
    return os.path.join(_REPO, "bench", "fixtures",
                        f"triples_n{n}_d{distinct}.npz")


def load_triples(n: int = 4096, distinct: int = 16, k: int | None = None):
    """-> (blobs, commitments, proofs), k entries cycling over the
    `distinct` fixture triples."""
    with np.load(fixture_path(n, distinct)) as z:
        seed = int(z["seed"])
        cs = [z["commitments"][i].tobytes() for i in range(distinct)]
        pfs = [z["proofs"][i].tobytes() for i in range(distinct)]
    blobs = gen_blobs(n, distinct, seed)
    k = distinct if k is None else k
    return ([blobs[i % distinct] for i in range(k)],
            [cs[i % distinct] for i in range(k)],
            [pfs[i % distinct] for i in range(k)])
