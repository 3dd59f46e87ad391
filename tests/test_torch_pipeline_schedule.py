"""The port's 3-stage pipelined batch verify in bench.py's schedule, on
the CPU at n=16.

The schedule (bench.py:220-251): dispatch batch i+1's front half, then
batch i's stage 2, then batch i-1's verdict; drain the last.  Run over
every kind of batch, each verdict must equal the golden model's.
Tolerance: verdicts equal."""

import pytest
import torch

import tpukzg_torch as tt

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


def run_schedule(batches, ts):
    """bench.py's pipelined schedule over `batches` -> their verdicts."""
    out = []
    pend = [tt.verify_blob_kzg_proof_batch_pipeline(*batches[0], ts)]
    for i in range(len(batches)):
        if i + 1 < len(batches):
            pend.append(tt.verify_blob_kzg_proof_batch_pipeline(
                *batches[i + 1], ts))
        pend[i].stage2()
        if i > 0:
            out.append(pend[i - 1].result())
    out.append(pend[-1].result())
    return out


def test_pipeline_schedule_matches_golden(ts, triples):
    """Eight batches, one of each kind, in flight three at a time."""
    batches = [batch_case(c, triples, N) for c in BATCH_CASES]
    got = run_schedule(batches, ts)
    want = [golden_verdict(N, *b) for b in batches]
    assert got == want == [c in ("valid", "empty") for c in BATCH_CASES]
    assert all(type(v) is bool for v in got)
