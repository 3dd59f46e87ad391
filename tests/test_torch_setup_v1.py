"""A layout-v1 SRS file (no Miller lines) loads on the port as it does on
the JAX package (``tpukzg/kzg/setup.py:72-75, 128-138``): the lines are
computed at load.  The v1 file of tau = 0xDEADBEEF at n = 4096 must give
the points and the lines of the v2 file of the same setup, bit for bit.
Its own file: the lines of two G2 points take ~30 s on the CPU."""

import os

import numpy as np
import torch

import tpukzg_torch as tt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V1 = os.path.join(REPO, ".srs_cache", "srs_4096_022e338cb32d8587.npz")
V2 = os.path.join(REPO, ".srs_cache", "srs_4096_d12b5dcfaa8277d4.npz")

torch.set_num_threads(1)


def test_layout_v1_file_loads_with_the_v2_lines():
    with np.load(V1) as z:
        assert not any(k.startswith(("lng_", "lnt_")) for k in z.files)
    v1 = tt.load_setup_file(V1, device="cpu").setup
    v2 = tt.load_setup_file(V2, device="cpu").setup
    assert v1.n == v2.n == 4096
    for name in ("lagrange_g1", "monomial_g1", "g2_gen", "g2_tau",
                 "lines_gen", "lines_tau"):
        for a, b in zip(getattr(v1, name), getattr(v2, name)):
            assert a.dtype == b.dtype == torch.int32
            assert torch.equal(a, b), name
