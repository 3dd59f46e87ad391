"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the program."""

import ast
import glob
import json
import os
import subprocess
import sys

from h100bench.tests import tiny

REPO = tiny.REPO


def _child(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_kinds_metrics_and_program_load_no_jax():
    mods = _child(
        "import json, sys; sys.path[:0] = ['.', 'src']\n"
        "from h100bench import harness\n"
        "b = json.load(open('BENCHMARK.json'))\n"
        "cells = [harness.Cell('.', w['name']) for w in b['workloads']]\n"
        "import tpukzg_torch, tpukzg_torch.msm.pippenger_lm\n"
        "import tpukzg_torch.curve.weierstrass_lm, tpukzg_torch.curve.g1\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & {"jax", "jaxlib", "flax", "tpukzg"}
    assert "tpukzg_torch" in mods


def test_reference_loads_nothing_of_the_program():
    mods = _child(
        "import json, sys; sys.path[:0] = ['.']\n"
        "from h100bench.reference import bls, kzg, parallel\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not set(mods) & {"tpukzg_torch", "torch", "jax", "tpukzg"}


def test_no_file_of_the_benchmark_imports_the_jax_side():
    for path in glob.glob(os.path.join(REPO, "h100bench", "**", "*.py"),
                          recursive=True):
        with open(path) as fh:
            tree = ast.parse(fh.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "tpukzg", "golden", "bench"), \
                    (path, n)
