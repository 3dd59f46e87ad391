"""A recording stub of the KZG API for the benchmark tests (numpy only).

The root ``bench.py`` (through attributes set on the ``tpukzg`` module)
and the port's ``tpukzg_torch.bench`` (through ``tpukzg_torch``) run
against the same stub, so their calls can be compared: each call is
appended to a JSON-lines log as it happens, so the log survives a kill.

Time: a ``Clock`` that only the stub moves (each stage 2 takes
``step_s``) replaces the benches' ``time``, so their walls, and so their
values, are exact.  A verify returns True unless a proof differs from
the fixture's for its position (``bench/fixtures/triples_n{n}_d{d}.npz``; where that file does
not exist, the stub's own prover's: a digest of the blob).  A call is
logged as [entry point, batch size, positions whose proof differs].

    python tests/torch_bench_stub.py jax|torch N K REPS LOG [KILL_AT]

runs one bench against the stub: the root one, with TPUKZG_BENCH_N/K/REPS
set as the JAX CLI sets them, or the port's on the CPU.  KILL_AT sends
the process SIGTERM after that many verdicts of the timed reps.  The
root bench.py is loaded from its file: ``import bench`` finds the
``bench/`` package beside it.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import os
import signal
import sys
import time

import numpy as np

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def digest(tag: bytes, blob: bytes) -> bytes:
    return hashlib.sha384(tag + blob).digest()


class Clock:
    """time.time and time.perf_counter that move only by sleep()."""

    def __init__(self):
        self.now = 1000.0

    def time(self) -> float:
        return self.now

    perf_counter = time

    def sleep(self, s: float) -> None:
        self.now += s


class Stub:
    API = ("generate_insecure_setup", "blob_to_kzg_commitment_batch",
           "compute_blob_kzg_proof_batch", "verify_blob_kzg_proof_batch",
           "verify_blob_kzg_proof_batch_pipeline")

    def __init__(self, n: int, distinct: int, log_path: str,
                 mode: str = "honest", kill_at: int | None = None,
                 step_s: float = 0.05, clock=time):
        self.log_path = log_path
        self.clock = clock
        self.mode = mode
        self.kill_at = kill_at
        self.step_s = step_s
        self.batches = self.results = 0
        path = os.path.join(REPO, "bench", "fixtures",
                            f"triples_n{n}_d{distinct}.npz")
        self.fixture = None
        if os.path.exists(path):
            with np.load(path) as z:
                self.fixture = [z["proofs"][i].tobytes()
                                for i in range(distinct)]

    def _log(self, *entry):
        with open(self.log_path, "a") as fh:
            fh.write(json.dumps(list(entry)) + "\n")

    def _bad(self, blobs, proofs):
        return [i for i, (b, p) in enumerate(zip(blobs, proofs))
                if p != (self.fixture[i % len(self.fixture)] if self.fixture
                         else digest(b"proof", b))]

    def _verdict(self, bad) -> bool:
        if self.mode == "accept_all":
            return True
        if self.mode == "accept_swapped":
            return not bad or bad == [0, 1]
        if self.mode == "reject_all":
            return False
        return not bad

    # the API
    def generate_insecure_setup(self, tau, n, device=None):
        self._log("setup", n)
        return object()

    def blob_to_kzg_commitment_batch(self, blobs, ts):
        self._log("commit_batch", len(blobs))
        return [digest(b"commitment", b) for b in blobs]

    def compute_blob_kzg_proof_batch(self, blobs, commitments, ts):
        self._log("proof_batch", len(blobs))
        return [digest(b"proof", b) for b in blobs]

    def verify_blob_kzg_proof_batch(self, blobs, commitments, proofs, ts):
        bad = self._bad(blobs, proofs)
        self._log("verify", len(blobs), bad)
        return self._verdict(bad)

    def verify_blob_kzg_proof_batch_pipeline(self, blobs, commitments,
                                             proofs, ts):
        t = self.clock.perf_counter()
        bad = self._bad(blobs, proofs)
        self._log("pipeline", len(blobs), bad, t)
        stub, idx = self, self.batches
        self.batches += 1

        class Pending:
            def stage2(self):
                stub._log("stage2", idx)
                stub.clock.sleep(stub.step_s)

            def result(self):
                stub.results += 1
                if stub.results == stub.kill_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                ok = stub._verdict(bad)
                stub._log("result", idx, ok, stub.clock.perf_counter())
                return ok

        return Pending()

    def install(self, module, setattr=setattr) -> None:
        for name in self.API:
            setattr(module, name, getattr(self, name))


def read_log(path: str):
    """-> (the calls, without their times: [entry point, batch size, bad
    positions], ["stage2", batch], ["result", batch, verdict]; the
    batches started; the wall from the first pipeline call to the last
    verdict)."""
    with open(path) as fh:
        rows = [json.loads(line) for line in fh]
    pipe = [r[-1] for r in rows if r[0] == "pipeline"]
    res = [r[-1] for r in rows if r[0] == "result"]
    calls = [r[:3] if r[0] in ("pipeline", "result") else r for r in rows]
    return calls, len(pipe), (res[-1] - pipe[0]) if pipe and res else None


if __name__ == "__main__":
    side, n, k, reps, log = sys.argv[1:6]
    kill_at = int(sys.argv[6]) if len(sys.argv) > 6 else None
    sys.path[:0] = [REPO, os.path.join(REPO, "src")]
    clock = Clock()
    stub = Stub(int(n), min(int(k), 16), log, kill_at=kill_at, clock=clock)
    if side == "jax":
        os.environ.update(TPUKZG_BENCH_N=n, TPUKZG_BENCH_K=k,
                          TPUKZG_BENCH_REPS=reps)
        import tpukzg
        stub.install(tpukzg)
        spec = importlib.util.spec_from_file_location(
            "bench", os.path.join(REPO, "bench.py"))
        bench = sys.modules["bench"] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        bench.time = clock
        bench.main()
    else:
        import tpukzg_torch
        stub.install(tpukzg_torch)
        from tpukzg_torch import bench
        bench.time = clock
        bench.main(n=int(n), k=int(k), reps=int(reps), device="cpu")
