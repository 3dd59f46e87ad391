"""work.py's counts against shapes worked out by hand."""

from h100bench.tests import tiny  # noqa: F401
from h100bench import work


def test_msm_2p20():
    w = work.msm_work(1, 1 << 20, False)
    assert w["adds"] == (1 << 20) - 1
    assert w["ops"] == ((1 << 20) - 1) * 6 * 144 * 4
    assert w["bytes"] == (1 << 20) * 96 + (1 << 20) * 32 + 96
    # 3.62e9 operations at 67e12/s: 54 us; 134 MB at 3.35e12 B/s: 40 us
    assert w["ops"] == 3623875200
    assert work.least_seconds(w) == 3623875200 / 67e12


def test_commit_batch_of_9_over_one_basis():
    w = work.msm_work(9, 4096, True)
    assert w["adds"] == 9 * 4095
    assert w["bytes"] == 4096 * 96 + 9 * 4096 * 32 + 9 * 96
    assert work.least_seconds(w) == w["ops"] / 67e12


def test_bytes_bound_when_operations_are_few():
    w = {"ops": 0, "bytes": 3.35e12}
    assert work.least_seconds(w) == 1.0
