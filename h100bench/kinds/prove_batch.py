"""A prover's closed loop: batches of `k` blobs, each through
blob_to_kzg_commitment_batch and then compute_blob_kzg_proof_batch, one
batch after the other.  Batch j's blobs are drawn from (seed, j) just
before its call, so no blob repeats in a run.  The fixed-base tables are
built by the warm-up batches in set-up.

blobs_proved_per_s is k x batches over the seconds from the first
batch's drawing to the last bytes returned; prove_batch_p95_ms (read in
traced runs) the 95th percentile of one batch's commit-plus-proof wall,
from the call to the bytes returned.  A sample of the window's batches,
drawn from the seed, is compared byte for byte with the reference's
commitments and proofs of their blobs, drawn again after the window.
"""

from __future__ import annotations

import time

from h100bench import inputs, planted, record, stats, work
from h100bench.counters import count_dispatch
from h100bench.reference import kzg as ref
from h100bench.reference.parallel import starmap

WARMUP_BATCHES = 2
CHECK_BATCHES = 16
BLOBS, WARMUP, SAMPLE = 1, 5, 4                  # input streams


class Kind:
    def __init__(self, config, traffic, seed, device, root, log):
        self.cfg, self.tr = config, traffic
        self.seed, self.device, self.root, self.log = seed, device, root, log
        self.n = config["field_elements_per_blob"]
        self.tau = int(config["setup_tau"], 16)
        self.k = traffic["k"]

    def setup(self):
        import tpukzg_torch
        self.ts = inputs.trusted_setup(self.cfg, self.device, self.root)
        self.commit = tpukzg_torch.blob_to_kzg_commitment_batch
        self.prove = tpukzg_torch.compute_blob_kzg_proof_batch
        for b in range(WARMUP_BATCHES):
            blobs = self._blobs(WARMUP, b)
            self.prove(blobs, self.commit(blobs, self.ts), self.ts)

    def _blobs(self, *stream) -> list:
        return inputs.blobs(self.k, self.n, self.seed, *stream)

    def _one(self, blobs, rec):
        with rec.span("prove.commit"):
            cs = self.commit(blobs, self.ts)
        with rec.span("prove.proof"):
            pfs = self.prove(blobs, cs, self.ts)
        return cs, pfs

    def window(self, seconds, rec):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.out, self.walls = [], []
        j = 0
        while True:
            rec.step(j)
            blobs = self._blobs(BLOBS, j)
            a = time.perf_counter()
            self.out.append(self._one(blobs, rec))
            b = time.perf_counter()
            self.walls.append(b - a)
            j += 1
            if b >= deadline:
                break
        self.seconds = time.perf_counter() - t0
        rec.step(j, final=True)
        self.attempted = j
        w = sorted(self.walls)
        self.log("batch walls ms: min %.3f median %.3f p95 %.3f max %.3f" % (
            1e3 * w[0], 1e3 * w[len(w) // 2],
            1e3 * stats.percentile(w, 95), 1e3 * w[-1]))

    def end_to_end(self):
        return {"blobs_proved_per_s": self.k * len(self.out) / self.seconds}

    def work(self):
        """The least work of one commit span: k MSMs over the n points of
        the Lagrange basis."""
        return {"prove.commit": work.msm_work(self.k, self.n, True)}

    def counters(self):
        """Traced runs only: the p95 of the batch walls the profiler did not
        slow, and one batch under the dispatch counter."""
        lo = self.tr["trace_skip"]
        hi = lo + self.tr["trace_steps"]
        walls = [w for j, w in enumerate(self.walls) if not lo <= j < hi]
        blobs = self._blobs(BLOBS, len(self.out))
        return {"prove_batch_p95_ms": 1e3 * stats.percentile(walls, 95),
                "tensor_ops_per_batch.prove":
                count_dispatch(lambda: self._one(blobs, record.Recorder()))}

    def release(self):
        self.ts = self.commit = self.prove = None

    def check(self):
        """A seeded sample of CHECK_BATCHES batches of the window, every
        blob's commitment and proof against the reference's."""
        m = len(self.out)
        picked = sorted(int(j) for j in inputs.rng(self.seed, SAMPLE).choice(
            m, min(m, CHECK_BATCHES), replace=False))
        blobs = [b for j in picked for b in self._blobs(BLOBS, j)]
        got = [(c, p) for j in picked for c, p in zip(*self.out[j])]
        want = starmap(ref.commit_and_prove,
                       [(b, self.tau, self.n) for b in blobs])
        wrong = sum(w != tuple(g_) for w, g_ in zip(want, got)) + \
            len(blobs) - len(got)
        self.failed = wrong
        self.log(f"checked {len(blobs)} blobs of {len(picked)} batches "
                 f"(of {m})")
        return [("blobs_wrong", wrong, 0)]


def _round_blobs(blobs):
    return [b"".join(b[i:i + 16] + bytes(16) for i in range(0, len(b), 32))
            for b in blobs]


def _commit_rounded(orig):
    return lambda blobs, ts: orig(_round_blobs(blobs), ts)


def _prove_rounded(orig):
    return lambda blobs, cs, ts: orig(_round_blobs(blobs), cs, ts)


def _prove_half(orig):
    return lambda blobs, cs, ts: orig(blobs[:len(blobs) // 2],
                                      cs[:len(blobs) // 2], ts)


def _prove_flipped(orig):
    def broken(blobs, cs, ts):
        out = list(orig(blobs, cs, ts))
        out[0] = bytes([out[0][0]]) + bytes([out[0][1] ^ 1]) + out[0][2:]
        return out
    return broken


def _stale(orig):
    """Each batch answers with the previous batch's commitments."""
    last = []

    def broken(blobs, ts):
        last.append(orig(blobs, ts))
        return last[-2] if len(last) > 1 else last[-1]
    return broken


def faults() -> dict:
    """{name: () -> context manager}: the control (the blob elements
    rounded to their top 128 bits before the prover sees them), half of
    each batch's proofs left out, a proof's byte flipped where it is
    produced, and stale commitments (the previous batch's) returned."""
    import tpukzg_torch as t
    commit, prove = "blob_to_kzg_commitment_batch", \
        "compute_blob_kzg_proof_batch"
    return {
        "control": lambda: planted.swap((t, commit, _commit_rounded),
                                        (t, prove, _prove_rounded)),
        "half_batch": lambda: planted.swap((t, prove, _prove_half)),
        "answer_altered": lambda: planted.swap((t, prove, _prove_flipped)),
        "stale_answer": lambda: planted.swap((t, commit, _stale)),
    }
