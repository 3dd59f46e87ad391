"""Kzg.verify, the single verify under the public verify_kzg_proof, over
batch axes on the CPU, against the known-answer tests and the golden
model.  Tolerance: verdicts exact."""

import json
import os

import pytest
import torch

import golden.model as gold
import tpukzg_torch as tt
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.field.mont import FR

from torch_cases import REPO

N = 16
TAU = 0xDEADBEEF
with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as _fh:
    KAT = json.load(_fh)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ts16():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


def _opening(case):
    o = KAT[case]
    return (bytes.fromhex(KAT["kzg"]["commitment"]), int(o["z"], 16),
            int(o["y"], 16), bytes.fromhex(o["proof"]))


def test_kzg_verify_batch_axes_match_golden(ts16):
    """Kzg.verify over three lanes in one call: the in-domain KAT opening
    (True), a wrong y and a wrong proof (False, False), as golden."""
    c, z, y, pf = _opening("kzg_open_in_domain")
    pf2 = _opening("kzg_open")[3]
    lanes = [(z, y, pf), (z, (y + 1) % gold.R, pf), (z, y, pf2)]
    pts, ok = tg1.decompress_batch([c] + [p for _, _, p in lanes], "cpu")
    assert ok.all()
    got = ts16.kzg.verify(
        tuple(t[0] for t in pts),
        torch.as_tensor(FR.from_int([a for a, _, _ in lanes])),
        torch.as_tensor(FR.from_int([b for _, b, _ in lanes])),
        tuple(t[1:] for t in pts))
    assert got.tolist() == [True, False, False]
    gs = gold.GoldenSetup(TAU, N)
    assert [gold.verify_kzg_proof(gs, gold.g1_decompress(c), a, b,
                                  gold.g1_decompress(p))
            for a, b, p in lanes] == [True, False, False]
