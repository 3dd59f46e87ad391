"""The port's batch verify through its pending batch, on the CPU at n=16:
the asynchronous entry point on every kind of batch, and the synchronous
one on a batch whose commitment has no curve point (with the
TPUKZG_TIMING marks), against the golden model's verdict.

Since the synchronous verify is the pending batch resolved at once, a
batch with a bad range or a point outside G1 runs the fold MSM and the
pairing too, and its three verdicts fold on the device.  Tolerance:
verdicts equal."""

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


@pytest.mark.parametrize("case", BATCH_CASES)
def test_async_verdict_matches_golden(ts, triples, case):
    batch = batch_case(case, triples, N)
    resolve = tt.verify_blob_kzg_proof_batch_async(*batch, ts)
    got = resolve()
    assert got is golden_verdict(N, *batch) is (case in ("valid", "empty"))


def test_sync_path_runs_whole_and_prints_the_jax_timing_labels(
        ts, triples, monkeypatch, capfd):
    """The off-curve commitment decompresses to a garbage point; the fold
    MSM and the pairing take it without raising (all four phases run),
    and the range, subgroup and pairing verdicts fold to golden's False.
    TPUKZG_TIMING=1 prints one line of the JAX package's labels."""
    batch = batch_case("off_curve", triples, N)
    monkeypatch.setenv("TPUKZG_TIMING", "1")
    monkeypatch.setattr(ts.blob, "timing", True)
    got = tt.verify_blob_kzg_proof_batch(*batch, ts)
    assert got is golden_verdict(N, *batch) is False
    assert list(ts.blob.last_phases) == ["decompress", "stage_eval",
                                         "fold_msm", "pairing"]
    lines = [ln for ln in capfd.readouterr().err.splitlines()
             if ln.startswith("[timing]")]
    assert len(lines) == 1
    labels = [part.split("=")[0] for part in lines[0].split()[1:]]
    assert labels == ["decompress_dispatch", "host_fs_z", "np_stack",
                      "device_put", "stage_eval_dispatch", "stage2_begin",
                      "y_sync", "host_fs_rho", "verify_batch_dispatch",
                      "verdict_dispatch", "verdict_sync"]


def test_count_mismatch_raises(ts, triples):
    """The port's chosen ValueError where the JAX package asserts."""
    blobs, cs, pfs = triples
    with pytest.raises(ValueError):
        tt.verify_blob_kzg_proof_batch_async(blobs, cs[:2], pfs, ts)
