"""Repo-wide pytest setup, loaded before tests/conftest.py.

It loads the per-test time limit (tests/time_limit.py) and gives tests of
the JAX reference their `slow` and `time_limit` marks by node id, so
that the reference's test files stay as they are.  The seconds beside
each entry are the test's call (or setup) on 8 CPU cores from an empty
XLA compile cache, beside five other pytest-xdist workers unless it says
"alone".
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

pytest_plugins = ("time_limit",)

# Tests whose XLA:CPU compile of a whole JAX program, or of a Pallas
# kernel's pure twin, costs minutes: `slow`, so that `pytest -m slow`
# runs them and the default selection does not.  The value is the test's
# time limit under `-m slow`, or None for the default.
SLOW = {
    # the jit of the fused EC formulas, 1,567.7 s; test_torch_kernels.py
    # checks the same functions eagerly against the port
    "tests/test_pallas.py::test_pallas_ec_add_double": 3600,
    # the jit of the bucket scan's twin, 1,052.2 s alone
    "tests/test_pallas.py::test_bucket_seg_scan_pallas_interpret": 3600,
    # the tiled twin's jit, 2,351.4 s
    "tests/test_pallas.py::test_bucket_seg_scan_pallas_tiled_interpret": 3600,
    # the jit of the NTT twin's fused stages, 296.6 s alone
    "tests/test_pallas.py::test_ntt_pallas_interpret": 900,
    # the sharded dry run's programs, 646.3 s
    "tests/test_dist.py::test_dryrun_multichip_entry": 1800,
    # the blob prover at the KAT's n, 218.2 s
    "tests/test_vectors.py::test_kzg_blob_kat": None,
    # the assoc scan inside a full limb-major MSM, 171.9 s
    "tests/test_msm.py::test_scan_impls_lm_full_msm[assoc]": None,
    # the Pallas twin's scan inside a full MSM: past 3,600 s, so it
    # fails by its limit until it is made smaller
    "tests/test_msm.py::test_scan_impls_lm_full_msm[pallas]": None,
    # the n = 4096 fixed-base commit, 163.0 s
    "tests/test_msm_production.py::test_commit_fixed_table_n4096_matches_golden":
        None,
    # the batched prover, 162.6 s
    "tests/test_kzg.py::test_batched_prove_matches_single": None,
    # the chunked batch verify at n = 8, 132.1 s
    "tests/test_fault.py::test_chunked_retry_recovers_from_transient_failure":
        None,
    # the assoc scan inside a full MSM, 124.0 s
    "tests/test_msm.py::test_scan_impls_bit_exact[assoc]": None,
}

# Tests of the default selection that need more than the default limit:
# marking them `slow` only moves their compile into the next test of
# their file, which runs the same program.
LIMITS = {
    # the batch verify's compile, 247.1 s
    "tests/test_kzg.py::test_single_and_batch_verify": 600,
    # the pairing's compile, 226.6 s
    "tests/test_pairing.py::test_pairing_matches_golden": 600,
    # its module fixture's setup, 122.5 s, which the file's tests share
    "tests/test_kzg.py::test_commitment_matches_golden": 600,
}


@pytest.hookimpl(tryfirst=True)  # before `-m` deselects by mark
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
        seconds = SLOW.get(item.nodeid) or LIMITS.get(item.nodeid)
        if seconds:
            item.add_marker(pytest.mark.time_limit(seconds))
