"""Each cell's control (its kind's faults()["control"]) on the card at
the cell's own size, on three seeds, with a window of the benchmark's
run_seconds at the cell's own load (so that it compares as many answers
as a run does, and the verify window reaches a batch with the forged
triple that only the range check refuses): every run must come out not
correct.  The cells are those of BENCHMARK.json and h100bench/deferred/,
run in a copy whose BENCHMARK.json has the deferred ones added.  Without
a card these skip; the same controls run at the tiny CPU size in
test_h100bench_faults.py.

    python -m pytest -s h100bench/tests/test_h100bench_control.py
"""

import json
import os
import sys
import time

import pytest

from h100bench.tests import faults, tiny

CELLS = [w["name"] for w in tiny.workloads()]
SEEDS = (2147483659, 3000000019, 4000000007)
with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as fh:
    SECONDS = float(json.load(fh)["run_seconds"])


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cells_size(cell, seed, tmp_path):
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control at the cell's own size")
    from h100bench import harness
    root = tiny.make_copy(str(tmp_path / "copy"), cut=False)
    with faults.planted(cell, "control"):
        out = harness.run_cell(root, cell, seed, SECONDS, False,
                               "cuda:0", time.perf_counter(),
                               lambda *a: print(*a, file=sys.stderr))
    print("CONTROL", cell, seed, json.dumps(out["checks"]),
          out["attempted"], flush=True)
    assert out["correct"] is False
