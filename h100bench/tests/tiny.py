"""A copy of the benchmark at a size the CPU runs in seconds: the same
files, each configuration and traffic file overlaid with its entry under
sizes/ (sizes/configs/<config>.json, sizes/traffic/<traffic>.json's
"traffic"), where there is one.  The program runs its plain tensor
versions there.  A cell that adds its files adds their sizes there too.
"""

from __future__ import annotations

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if REPO not in sys.path:
    sys.path.insert(0, REPO)
if os.path.join(REPO, "src") not in sys.path:
    sys.path.insert(0, os.path.join(REPO, "src"))
SIZES = os.path.join(REPO, "h100bench", "tests", "sizes")


def _load(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _sizes(kind: str, name: str) -> dict:
    path = os.path.join(SIZES, kind, name + ".json")
    return _load(path) if os.path.exists(path) else {}


def add_deferred(root: str) -> None:
    """Add the entries of every deferred cell (h100bench/deferred/) to the
    BENCHMARK.json at `root`, as the change that adds such a cell will."""
    path = os.path.join(root, "BENCHMARK.json")
    bench = _load(path)
    ddir = os.path.join(root, "h100bench", "deferred")
    for f in sorted(os.listdir(ddir)):
        for key, entries in _load(os.path.join(ddir, f)).items():
            bench[key] += entries
    with open(path, "w") as fh:
        json.dump(bench, fh)


def workloads() -> list:
    """Every cell of BENCHMARK.json and of h100bench/deferred/, as its
    workload entry."""
    out = list(_load(os.path.join(REPO, "BENCHMARK.json"))["workloads"])
    ddir = os.path.join(REPO, "h100bench", "deferred")
    for f in sorted(os.listdir(ddir)):
        out += _load(os.path.join(ddir, f)).get("workloads", [])
    return out


def kind_of(workload: dict):
    """The kind module of a workload entry."""
    from h100bench import harness
    base = os.path.join(REPO, "h100bench")
    traffic = _load(os.path.join(base, "traffic",
                                 workload["traffic"] + ".json"))
    return harness.load_kind(base, traffic["kind"])


def run_args(workload: dict) -> tuple:
    """(seed, seconds) of a tiny run of the cell: sizes/traffic/'s "seed"
    and "seconds", else 7 and 0.01 (one step)."""
    got = _sizes("traffic", workload["traffic"])
    return got.get("seed", 7), got.get("seconds", 0.01)


def _patch(path: str, changes: dict) -> None:
    d = _load(path)
    d.update(changes)
    with open(path, "w") as fh:
        json.dump(d, fh)


def make_copy(dest: str, cut: bool = True) -> str:
    """A checkout-shaped directory at `dest` holding BENCHMARK.json with
    the deferred cells added, a copy of the benchmark (cut to tiny sizes
    unless `cut` is False), and links to the program's sources and
    committed SRS files."""
    os.makedirs(dest, exist_ok=True)
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), dest)
    shutil.copytree(os.path.join(REPO, "h100bench"),
                    os.path.join(dest, "h100bench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("src", ".srs_cache"):
        os.symlink(os.path.join(REPO, name), os.path.join(dest, name))
    add_deferred(dest)
    if not cut:
        return dest
    base = os.path.join(dest, "h100bench")
    for w in _load(os.path.join(dest, "BENCHMARK.json"))["workloads"]:
        _patch(os.path.join(base, "configs", w["config"] + ".json"),
               _sizes("configs", w["config"]))
        _patch(os.path.join(base, "traffic", w["traffic"] + ".json"),
               _sizes("traffic", w["traffic"]).get("traffic", {}))
    return dest


def run(root: str, cell: str, seed: int = 7, seconds: float = 0.01,
        traced: bool = False) -> dict:
    """One run of `cell` in the copy at `root` on the CPU (the harness's
    look for a card skipped)."""
    from h100bench import harness
    return harness.run_cell(root, cell, seed, seconds, traced, "cpu", 0.0,
                            lambda *a: print(*a, file=sys.stderr))
