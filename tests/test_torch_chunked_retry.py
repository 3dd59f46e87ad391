"""The port's chunked batch verify under failures, on the CPU at n=16:
tests/test_fault.py:29-64 on the port.  A transient failure inside one
chunk is retried and the run completes; a persistent one propagates
once the retries run out (no silent False)."""

import pytest
import torch

import tpukzg_torch as tt
from tpukzg_torch.kzg.blob import BlobKzg

N = 16
TAU = 0xDEADBEEF

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def ts():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


def test_chunked_retry_recovers_from_transient_failure(ts, monkeypatch):
    # zero polynomial blobs: commitment and proofs are the point at
    # infinity
    blobs = [bytes(32 * N) for _ in range(4)]
    cs = pfs = [b"\xc0" + bytes(47)] * 4

    calls = {"n": 0}
    real = BlobKzg.verify_blob_kzg_proof_batch

    def flaky(self, *a, **k):
        calls["n"] += 1
        if calls["n"] == 2:                      # second chunk, first try
            raise RuntimeError("injected transient device failure")
        return real(self, *a, **k)

    monkeypatch.setattr(BlobKzg, "verify_blob_kzg_proof_batch", flaky)
    ok = tt.verify_blob_kzg_proof_batch_chunked(blobs, cs, pfs, ts,
                                                chunk=2, retries=1)
    assert ok
    assert calls["n"] == 3                       # 2 chunks + 1 retry

    # retries exhausted -> the failure propagates (no silent False-pass)
    calls["n"] = 0

    def always_down(self, *a, **k):
        calls["n"] += 1
        raise RuntimeError("injected persistent failure")

    monkeypatch.setattr(BlobKzg, "verify_blob_kzg_proof_batch", always_down)
    with pytest.raises(RuntimeError, match="injected persistent"):
        tt.verify_blob_kzg_proof_batch_chunked(blobs, cs, pfs, ts,
                                               chunk=2, retries=1)
    assert calls["n"] == 2                       # first chunk tried twice
