"""A run with the timed path broken underneath comes out not correct: for
each cell, its control and each fault its kind names (faults.py); a run
of the sound path comes out correct.  On the CPU at the tiny size of
tiny.py, the harness's look for a card skipped."""

import pytest

from h100bench.tests import faults, tiny

CASES = faults.cases()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_copy(str(tmp_path_factory.mktemp("tiny")))


@pytest.mark.parametrize("cell,args", sorted({(c, a) for c, a, _ in CASES}))
def test_sound_run_is_correct(root, cell, args):
    seed, seconds = args
    assert tiny.run(root, cell, seed=seed, seconds=seconds)["correct"] is True


@pytest.mark.parametrize("cell,args,fault", CASES)
def test_broken_path_is_not_correct(root, cell, args, fault):
    seed, seconds = args
    with faults.planted(cell, fault):
        out = tiny.run(root, cell, seed=seed, seconds=seconds)
    assert out["correct"] is False
    assert next(iter(out["checks"].values()))["value"] > 0
