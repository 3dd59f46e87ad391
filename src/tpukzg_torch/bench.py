"""Headline benchmark of the port: batched KZG blob-proof verifications/s
(counterpart of the root ``bench.py``).  Run it through the CLI:

    python -m tpukzg_torch.cli bench [--n 4096 --k 64 --reps 3] [--device D]

It prints ONE JSON line on stdout:

    {"metric": "batched_kzg_blob_verifications_per_sec", "value": v,
     "unit": "verifications/s (k=K, n=N, <device name>)"}

v = k / the sustained seconds a batch of bench.py's 3-stage pipelined
schedule: the wall from the first ``verify_blob_kzg_proof_batch_pipeline``
call to the last verdict, fill and drain included, over the batches.
There is no ``vs_baseline``: bench.py divides by its north star of 1e6
verifications/s, a target for a v5p-16 TPU slice (BASELINE.json), and
the port states no number taken on or for a TPU.

The steps follow bench.py's ``main``: the setup (``.srs_cache/`` holds
n = 4096), the fixture triples (``bench/fixtures/``; made with the
port's prover where the file for (n, distinct) does not exist), a micro
warm-up at min(8, k) and a warm-up at k (each sets a pessimistic best
time, and the first builds the kernels on a fresh machine), the timed
reps, then a batch with one proof tampered and one with two proofs
swapped, both of which must fail.  Unlike bench.py, the run never falls
back to the CPU (with no card and no device named it raises), and the
two checks run on every call, past the budget too.  A wrong verdict
exits non-zero with no line.  On SIGTERM or SIGINT the line is printed
from the best time so far, if there is one.

Env knobs: TPUKZG_BENCH_BUDGET (soft wall budget in s, default 480: past
it the reps stop early), TPUKZG_BENCH_DISTINCT (distinct triples,
default 16).  The log goes to stderr: the card and its power limit
first, then each step and each rep's step time.
"""

from __future__ import annotations

import gc
import json
import os
import signal
import subprocess
import sys
import time

import torch

import tpukzg_torch
from tpukzg_torch.field.mont import resolve_device
from tpukzg_torch.kernels import _build
from tpukzg_torch.kzg.fixtures import fixture_path, gen_blobs, load_triples

METRIC = "batched_kzg_blob_verifications_per_sec"
TAU = 0xDEADBEEF


class _Run:
    """One benchmark run: its log clock and what a kill reports (the best
    seconds a batch so far, at batch size k)."""

    def __init__(self, n: int, device_name: str):
        self.t0 = time.perf_counter()
        self.n = n
        self.device_name = device_name
        self.k = 0
        self.best = None
        self.phase = "init"
        self.emitted = False

    def log(self, *a):
        print(f"[bench {time.perf_counter() - self.t0:7.1f}s]", *a,
              file=sys.stderr, flush=True)

    def emit(self, value: float):
        """Print the result line (once)."""
        if self.emitted:
            return
        self.emitted = True
        print(json.dumps({
            "metric": METRIC, "value": value,
            "unit": (f"verifications/s (k={self.k}, n={self.n}, "
                     f"{self.device_name})")}), flush=True)

    def on_signal(self, signum, frame):
        if self.best:
            self.emit(self.k / self.best)
            self.log(f"killed by signal {signum} during {self.phase}; "
                     "emitted partial result")
        else:
            self.log(f"killed by signal {signum} during {self.phase}; "
                     "no result yet")
        sys.exit(0 if self.best else 1)


def _card(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        if out.returncode == 0 and out.stdout.strip():
            return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        pass
    return f"{torch.cuda.get_device_name(device)}, power limit not read"


def _expect(got, want: bool, what: str) -> None:
    if bool(got) != want:
        raise SystemExit(f"bench FAILED: {what} gave {bool(got)}, not {want}")


def main(n: int = 4096, k: int = 256, reps: int = 10, device=None) -> float:
    """Run the benchmark, print its line, return verifications/s.  The
    defaults are bench.py's shape; the CLI's are k = 64, reps = 3."""
    dev = resolve_device(device)
    if k < 1 or reps < 1:
        raise ValueError(f"bench: k = {k} and reps = {reps} must be >= 1")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)
    run = _Run(n, name)
    prev = {s: signal.signal(s, run.on_signal)
            for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        return _bench(run, n, k, reps, dev)
    finally:
        for s, h in prev.items():
            signal.signal(s, signal.SIG_DFL if h is None else h)


def _bench(run: _Run, n: int, k: int, reps: int, dev) -> float:
    budget = float(os.environ.get("TPUKZG_BENCH_BUDGET", "480"))
    distinct = min(k, int(os.environ.get("TPUKZG_BENCH_DISTINCT", "16")))
    run.log(_card(dev) if dev.type == "cuda"
            else f"{dev}: the plain tensor versions, no card")
    run.log(f"device={dev} n={n} k={k} reps={reps} distinct={distinct}")
    verify = tpukzg_torch.verify_blob_kzg_proof_batch

    run.phase = "setup-load"
    ts = tpukzg_torch.generate_insecure_setup(TAU, n, device=dev)
    run.log("setup ready")

    run.phase = "fixtures"
    fp = fixture_path(n, distinct)
    if os.path.exists(fp):
        blobs, cs, pfs = load_triples(n, distinct, k)
        run.log(f"fixtures loaded from {fp}")
    else:
        run.log(f"no fixtures at {fp}; making them with the prover")
        base = gen_blobs(n, distinct, 0x5EED)
        base_cs = tpukzg_torch.blob_to_kzg_commitment_batch(base, ts)
        base_pfs = tpukzg_torch.compute_blob_kzg_proof_batch(base, base_cs,
                                                             ts)
        blobs, cs, pfs = ([x[i % distinct] for i in range(k)]
                          for x in (base, base_cs, base_pfs))

    # the micro warm-up builds the kernels and gives a kill a result
    # before the warm-up at k
    run.phase = "micro-warmup"
    km = min(8, k)
    t0 = time.perf_counter()
    _expect(verify(blobs[:km], cs[:km], pfs[:km], ts), True,
            f"the micro warm-up (k={km})")
    micro = time.perf_counter() - t0
    run.best, run.k = micro, km
    run.log(f"micro-warmup (k={km}) in {micro:.3f}s")

    run.phase = "warmup-verify"
    t0 = time.perf_counter()
    _expect(verify(blobs, cs, pfs, ts), True, f"the warm-up (k={k})")
    warm = time.perf_counter() - t0
    run.best, run.k = warm, k
    run.log(f"warmup verify in {warm:.3f}s")

    # timed reps, bench.py's schedule (kzg/blob.py _PendingBatch): at
    # step i, batch i+1's stage 1, batch i's stage 2, batch i-1's verdict
    start = tpukzg_torch.verify_blob_kzg_proof_batch_pipeline
    gc.collect()
    _build.launches.clear()
    times = []
    t_pipe0 = time.perf_counter()
    pend = [start(blobs, cs, pfs, ts)]
    stop_at = reps
    i = 0
    while i < stop_at:
        run.phase = f"rep-{i}"
        t0 = time.perf_counter()
        if i + 1 < stop_at:
            pend.append(start(blobs, cs, pfs, ts))
        pend[i].stage2()
        if i > 0:
            _expect(pend[i - 1].result(), True, f"timed batch {i - 1}")
            run.best = (time.perf_counter() - t_pipe0) / i
        times.append(time.perf_counter() - t0)
        run.log(f"rep {i}: step {times[-1]:.3f}s, sustained "
                f"{run.best:.3f}s/rep" if i > 0 else
                f"rep {i}: step {times[-1]:.3f}s (pipeline fill)")
        # the budget is for the cold phases: a measurement window of at
        # least five steps is kept past it
        now = time.perf_counter()
        if (now - run.t0 > budget and now - t_pipe0 > 5 * max(times)
                and i + 1 < stop_at):
            run.log("budget reached; stopping reps early")
            stop_at = i + 2              # one more batch started: drain it
        i += 1
    _expect(pend[-1].result(), True, f"timed batch {len(pend) - 1}")
    run.best = (time.perf_counter() - t_pipe0) / len(pend)
    run.log(f"kernel launches in the timed reps "
            f"{json.dumps(dict(_build.launches))}")

    # soundness: both checks on every run, past the budget too
    run.phase = "tamper-check"
    bad = bytearray(pfs[k // 2])
    bad[13] ^= 0x04
    _expect(verify(blobs, cs, pfs[:k // 2] + [bytes(bad)] + pfs[k // 2 + 1:],
                   ts), False, f"the batch with proof {k // 2} tampered")
    run.log("tamper check ok")
    if distinct >= 2:
        run.phase = "swap-check"
        _expect(verify(blobs, cs, [pfs[1], pfs[0]] + pfs[2:], ts), False,
                "the batch with proofs 0 and 1 swapped")
        run.log("swap check ok")

    vps = k / run.best
    run.log(f"block_times={['%.3f' % t for t in times]} "
            f"sustained={run.best:.3f}s => {vps:.1f} verifications/s")
    run.emit(vps)
    return vps
