"""BENCHMARK.json, the files it names, and a cell added by files alone."""

import hashlib
import json
import os
import re
import shutil

from h100bench.tests import tiny  # noqa: F401  (puts the repo on sys.path)
from h100bench import harness

REPO = tiny.REPO
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as fh:
        return json.load(fh)


def test_keys_names_units_and_bounds():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "h100bench/run.py"]
    assert b["paths"] == ["h100bench"] and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for w in b["workloads"]:
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert c["file"].startswith("h100bench/") and c["reduced"] == []


def test_every_cell_resolves_and_reports_what_it_must(tmp_path):
    """Every cell of BENCHMARK.json and of h100bench/deferred/."""
    root = tiny.make_copy(str(tmp_path / "copy"), cut=False)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for w in b["workloads"]:
        cell = harness.Cell(root, w["name"])
        assert cell.config["name"] == w["config"]
        assert hasattr(cell.kind, "Kind")
        got = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in got and len(got) >= 2
        assert cell.per_layer and set(cell.readers) == {
            m["name"] for m in cell.per_layer}
        for m in cell.per_layer:
            assert m["moves"] in got and e2e[m["moves"]]
    assert {c["name"] for c in b["configs"]} == {
        w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        with open(os.path.join(root, c["file"])) as fh:
            assert json.load(fh)["name"] == c["name"]


def _digests(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "h100bench")):
        for f in files:
            if "__pycache__" not in d:
                p = os.path.join(d, f)
                with open(p, "rb") as fh:
                    out[os.path.relpath(p, root)] = hashlib.sha256(
                        fh.read()).hexdigest()
    return out


def test_a_cell_is_added_by_new_files_and_entries_alone(tmp_path):
    """The deferred verify cell's entries and a new traffic file for a
    k = 9 cell, added to a copy: both resolve to their files, metrics and
    faults (among them the control), and no file that was there
    changes."""
    root = str(tmp_path)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(REPO, "h100bench"),
                    os.path.join(root, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(root)
    tiny.add_deferred(root)
    with open(os.path.join(root, "h100bench", "traffic",
                           "verify-k9.json"), "w") as fh:
        json.dump({"kind": "verify_pipeline", "k": 9, "pool": 64,
                   "tampers": ["proofs_swapped"], "batches_planned": 8,
                   "trace_skip": 1, "trace_steps": 3}, fh)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        b = json.load(fh)
    b["workloads"].append({"name": "eip4844-verify-k9",
                           "config": "eip4844-mainnet",
                           "traffic": "verify-k9", "chips": 1,
                           "why": "a block's blobs"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "eip4844-verify-k256" in m.get("workloads", []):
            m["workloads"].append("eip4844-verify-k9")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(b, fh)
    for name, k in (("eip4844-verify-k256", 256), ("eip4844-verify-k9", 9)):
        cell = harness.Cell(root, name)
        assert cell.traffic["k"] == k
        assert cell.kind.Kind.__module__.endswith("verify_pipeline")
        assert "control" in cell.kind.faults()
        assert {m["name"] for m in cell.end_to_end} == {
            "verifications_per_s", "setup_s"}
        assert set(cell.readers) == {"tensor_ops_per_batch.verify",
                                     "pairing_s_per_batch",
                                     "device_idle.verify"}
    after = _digests(root)
    assert all(after[p] == d for p, d in before.items())
