"""The statistics and trace reductions on synthetic timings, and the
result line of a run."""

import json
import os

import pytest

from h100bench.tests import tiny
from h100bench import harness, stats, trace


def test_p95_over_every_batch():
    walls = [0.1] * 95 + [0.5] * 5
    assert stats.percentile(walls, 95) == 0.1
    assert stats.percentile(walls + [0.9], 95) == 0.5
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile(list(range(1, 21)), 95) == 19


def test_idle_share_gaps_and_ops():
    ev = [("a", 0.0, 1.0), ("b", 0.5, 2.0), ("a", 3.0, 4.0)]
    assert trace.busy_seconds(ev, 0.0, 5.0) == pytest.approx(3.0)
    assert trace.idle_share(ev, 0.0, 5.0) == pytest.approx(40.0)
    assert trace.busy_seconds(ev, 1.5, 3.5) == pytest.approx(1.0)
    spans = [("stage2", 1.8, 3.2), ("result", 3.9, 5.0)]
    assert trace.idle_gaps(ev, spans, 0.0, 5.0) == [
        ["stage2", pytest.approx(1.0)], ["result", pytest.approx(1.0)]]
    assert trace.top_ops(ev, 0.0, 5.0) == [
        ["a", pytest.approx(2.0)], ["b", pytest.approx(1.5)]]
    assert trace.busy_in_spans(ev, spans, "stage2") == pytest.approx(0.4)
    assert trace.busy_in_spans(ev, spans, "none") is None


def test_readers_read_nothing_without_a_trace():
    r = harness.Readings(None, [], {}, {})
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as fh:
        cells = [w["name"] for w in json.load(fh)["workloads"]]
    for name in cells:
        cell = harness.Cell(tiny.REPO, name)
        assert all(read(r) is None for read in cell.readers.values())


def test_result_line_keys(tmp_path):
    root = tiny.make_copy(str(tmp_path / "copy"))
    out = tiny.run(root, "msm-2p20-commit", seed=3 << 31)
    line = json.loads(json.dumps(out))
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["metrics"]) == {"msm_points_per_s", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert line["checks"] == {"msm_wrong": {"value": 0, "limit": 0}}
