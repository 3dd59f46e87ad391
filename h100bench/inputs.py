"""Inputs made from the run's seed, the same for every run of one seed,
and the trusted setup the configurations name.

Every input belongs to a stream, a tuple of whole numbers (a kind of
input, then for inputs made anew at each step the step's index), and is
drawn from the run's seed and its stream alone.

Blobs: n elements of 32 big-endian bytes, each below 0x73 * 2^248 < r
(the first byte uniform below 0x73, the rest uniform), from one block of
raw PCG64 output (about 1 ms a megabyte).  Scalars and discrete logs on
the card: 16-bit limbs drawn by one torch.Generator of the seed and the
stream, the top limb below 0x73ED, so each value is below
0x73ED * 2^240 < r.
"""

from __future__ import annotations

import os

import numpy as np

from h100bench.reference import bls

TOP_BYTE = 0x73
TOP_LIMB = 0x73ED


def rng(seed: int, *stream: int) -> np.random.Generator:
    """The NumPy generator of one input stream of a seed."""
    return np.random.default_rng([*stream, seed])


def blobs(count: int, n: int, seed: int, *stream: int) -> list:
    """`count` blobs of n elements."""
    raw = rng(seed, *stream).bit_generator.random_raw(4 * count * n).view(
        np.uint8).reshape(count, n, 32)
    raw[:, :, 0] %= TOP_BYTE
    return [raw[i].tobytes() for i in range(count)]


def off_g1_point(seed: int, stream: int) -> bytes:
    """The compressed encoding of a point of the curve outside G1, x drawn
    from the seed."""
    g = rng(seed, stream)
    while True:
        x = int.from_bytes(g.bytes(48), "big") % bls.P
        y = bls.fp_sqrt((x * x * x + 4) % bls.P)
        if y is not None and not bls.in_g1((x, y, 1)):
            return bls.compress((x, y, 1))


def limbs16(torch, shape, device, seed: int, *stream: int):
    """(*shape, 16) int32 limbs of values below 0x73ED * 2^240, drawn on
    `device` by one generator of (seed, stream)."""
    gen = torch.Generator(device=device)
    seq = np.random.SeedSequence([*stream, seed])
    gen.manual_seed(int(seq.generate_state(1, np.uint64)[0]) >> 1)
    k = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen,
                      device=device, dtype=torch.int32)
    k[..., 15] %= TOP_LIMB
    return k


def trusted_setup(config: dict, device, root: str):
    """The program's setup of the configuration's tau and n, read from the
    checkout's committed SRS files (generated there on a miss)."""
    from tpukzg_torch.api import TrustedSetup
    from tpukzg_torch.kzg.setup import Setup
    return TrustedSetup(Setup.generate_insecure(
        int(config["setup_tau"], 16), config["field_elements_per_blob"],
        cache_dir=os.path.join(root, ".srs_cache"), device=device))
