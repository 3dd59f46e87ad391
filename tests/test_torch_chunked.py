"""The port's chunked batch verify on every kind of batch, on the CPU at
n=16, against the golden model's verdict.  Chunks of two blobs: a valid
batch of three takes two chunks; every bad batch here is bad in its first
chunk, so the call returns False after it.  Tolerance: verdicts equal."""

import pytest
import torch

import tpukzg_torch as tt
from tpukzg_torch.kzg.blob import BlobKzg

from torch_cases import BATCH_CASES, batch_case, golden_triples, golden_verdict

N = 16
TAU = 0xDEADBEEF

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def triples():
    return golden_triples(N, 3, 41)


@pytest.fixture(scope="module")
def ts():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


@pytest.mark.parametrize("case", BATCH_CASES)
def test_chunked_verdict_matches_golden(ts, triples, case, monkeypatch):
    batch = batch_case(case, triples, N)
    chunks = []
    real = BlobKzg.verify_blob_kzg_proof_batch

    def counted(self, blobs, *a):
        chunks.append(len(blobs))
        return real(self, blobs, *a)

    monkeypatch.setattr(BlobKzg, "verify_blob_kzg_proof_batch", counted)
    got = tt.verify_blob_kzg_proof_batch_chunked(*batch, ts, chunk=2)
    assert got is golden_verdict(N, *batch) is (case in ("valid", "empty"))
    assert chunks == {"valid": [2, 1], "empty": []}.get(case, [2])
