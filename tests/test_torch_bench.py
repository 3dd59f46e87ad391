"""The port's benchmark (``tpukzg_torch/bench.py``, ``python -m
tpukzg_torch.cli bench``) against the root ``bench.py``: both run
against one recording stub of the API (``torch_bench_stub.py``), each in
a child process, and must make the same calls in the same order (the
port adds the swapped-proofs check) and report the same metric, with
value = k / (wall / batches).  Also the CLI's arguments, the refusals
(no card, a wrong verdict) and the line on SIGTERM."""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

import tpukzg_torch
from tpukzg_torch import bench, cli as tcli
from tpukzg import cli as jcli

from torch_bench_stub import Clock, Stub, read_log

TESTS = os.path.dirname(os.path.abspath(__file__))
STUB = os.path.join(TESTS, "torch_bench_stub.py")


def _child(side, n, k, reps, log, tmp_path, *extra):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               TPUKZG_BENCH_TPU_PROBE_S="1",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jax_cache"),
               TPUKZG_CACHE_DIR=str(tmp_path / "srs_cache"))
    return subprocess.Popen(
        [sys.executable, STUB, side, str(n), str(k), str(reps), str(log),
         *map(str, extra)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=env)


def _line(out: str) -> dict:
    lines = [x for x in out.splitlines() if x.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("n, k, reps", [(4096, 32, 3), (16, 2, 2)],
                         ids=["fixture", "generated"])
def test_schedule_matches_jax_bench(tmp_path, n, k, reps):
    """The same calls in the same order as bench.py's main (fixtures from
    the file, or made by the prover where none exists), the same metric,
    and the same value k / (wall / batches) on the stub's clock."""
    procs = {side: _child(side, n, k, reps, tmp_path / f"{side}.log",
                          tmp_path) for side in ("jax", "torch")}
    got = {}
    for side, p in procs.items():
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
        calls, batches, wall = read_log(tmp_path / f"{side}.log")
        got[side] = (calls, batches, wall, _line(out))
    jax_calls, torch_calls = got["jax"][0], got["torch"][0]
    assert torch_calls == jax_calls + [["verify", k, [0, 1]]]
    assert jax_calls[-1] == ["verify", k, [k // 2]]
    made = [c for c in jax_calls if c[0] in ("commit_batch", "proof_batch")]
    assert made == ([] if n == 4096 else [["commit_batch", k],
                                          ["proof_batch", k]])
    for side, (_, batches, wall, line) in got.items():
        assert batches == reps
        assert line["metric"] == "batched_kzg_blob_verifications_per_sec"
        assert f"k={k}, n={n}" in line["unit"]
        assert line["value"] == pytest.approx(k / (wall / batches),
                                              abs=0.005)  # bench.py rounds
    assert wall == pytest.approx(reps * 0.05)
    assert got["torch"][3]["value"] == pytest.approx(got["jax"][3]["value"],
                                                     abs=0.005)
    assert "vs_baseline" not in got["torch"][3]
    assert got["torch"][3]["unit"].endswith(", cpu)")


@pytest.mark.parametrize("argv", [[], ["--k", "256", "--reps", "10"],
                                  ["--n", "16", "--k", "2", "--reps", "1"]],
                         ids=["defaults", "bench_py_shape", "small"])
def test_cli_bench_parses_like_jax_cli(monkeypatch, argv):
    seen = {}
    for name, mod in (("jax", jcli), ("torch", tcli)):
        monkeypatch.setattr(mod, "_cmd_bench",
                            lambda a, name=name: seen.__setitem__(name, a))
        mod.main(["bench", *argv])
    j, t = seen["jax"], seen["torch"]
    assert (t.n, t.k, t.reps) == (j.n, j.k, j.reps)
    assert t.device is None


def test_bench_without_a_card_raises(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        tcli.main(["bench", "--n", "16", "--k", "2", "--reps", "1"])
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("mode, what", [
    ("accept_all", "proof 1 tampered"),
    ("accept_swapped", "proofs 0 and 1 swapped"),
    ("reject_all", "micro warm-up")])
def test_bench_refuses_a_wrong_verdict(monkeypatch, capsys, tmp_path, mode,
                                       what):
    """A stub that accepts the tampered (or the swapped) batch, or refuses
    the valid one: exit non-zero, no line, the handlers restored."""
    Stub(16, 2, str(tmp_path / "log"), mode=mode,
         step_s=0).install(tpukzg_torch, monkeypatch.setattr)
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    with pytest.raises(SystemExit) as e:
        bench.main(n=16, k=2, reps=2, device="cpu")
    assert e.value.code not in (0, None) and what in str(e.value.code)
    assert capsys.readouterr().out == ""
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == before


def test_bench_checks_past_the_budget(monkeypatch, capsys, tmp_path):
    """With the budget spent the reps stop once five steps' time has
    passed, one more batch drained (bench.py's rule: 7 batches of equal
    steps), and both checks still run; the handlers are restored."""
    log, clock = tmp_path / "log", Clock()
    Stub(16, 2, str(log), step_s=0.01, clock=clock).install(
        tpukzg_torch, monkeypatch.setattr)
    monkeypatch.setattr(bench, "time", clock)
    monkeypatch.setenv("TPUKZG_BENCH_BUDGET", "0")
    before = [signal.getsignal(s) for s in (signal.SIGTERM, signal.SIGINT)]
    vps = bench.main(n=16, k=2, reps=50, device="cpu")
    calls, batches, wall = read_log(log)
    assert batches == 7
    assert calls[-2:] == [["verify", 2, [1]], ["verify", 2, [0, 1]]]
    line = _line(capsys.readouterr().out)
    assert line["value"] == vps == pytest.approx(2 / 0.01)
    assert wall == pytest.approx(7 * 0.01)
    assert [signal.getsignal(s)
            for s in (signal.SIGTERM, signal.SIGINT)] == before


def test_sigterm_during_the_reps_prints_the_partial_line(tmp_path):
    """Killed at the second verdict of the timed reps: the line from the
    best time so far (the first verdict's), exit 0, no check run."""
    log = tmp_path / "torch.log"
    p = _child("torch", 4096, 32, 10, log, tmp_path, 2)
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err[-3000:]
    assert "killed by signal" in err
    calls, batches, wall = read_log(log)
    line = _line(out)
    assert line["metric"] == "batched_kzg_blob_verifications_per_sec"
    assert "k=32, n=4096" in line["unit"] and line["value"] > 0
    assert [c for c in calls if c[0] == "result"] == [["result", 0, True]]
    assert calls[-1] == ["stage2", 2]
    assert not [c for c in calls if c[0] == "verify" and c[2]]
