"""Batch verification through verify_blob_kzg_proof_batch_pipeline, on the
3-stage schedule of the repository's bench.py: at step i, batch i+1's
stage 1 (host checks, Fiat-Shamir z, upload, staging, barycentric eval
and decompression dispatched), batch i's stage 2 (y read back, rho,
fold MSM and pairing dispatched), batch i-1's verdict.

Inputs: a pool of distinct blobs from the seed, committed and proved in
set-up by the program's prover; each batch takes k distinct triples of
the pool in a seeded order.  In every block of 2 x len(tampers) batches,
in a seeded order, half are valid and one carries each kind of tamper at
a seeded position, so the verdicts are mixed and each layer that can
turn a verdict is reached:
  blob_element          one element of a blob changed (z and y change;
                        the pairing refuses);
  proofs_swapped        two proofs of the batch swapped (the fold MSM and
                        the pairing refuse);
  commitment_off_g1     a commitment replaced by a point of the curve
                        outside G1 (the subgroup check refuses);
  element_out_of_range  one element of a blob raised by r, with a
                        commitment and proof made for its values mod r at
                        the challenge of its bytes (the pairing accepts;
                        only the range check refuses).
Every tamper is refused on the device, so a tampered batch does the work
of a valid one.  The last two triples are made by the reference in
set-up, from tau.

The window runs batches until `seconds` have passed, then drains the two
in flight; verifications_per_s is k x batches over the seconds from the
first stage 1 to the last verdict.  Every verdict is compared with the
reference's, worked out triple by triple from the bytes and tau.
"""

from __future__ import annotations

import time

from h100bench import inputs, planted
from h100bench.counters import count_dispatch
from h100bench.reference import kzg as ref
from h100bench.reference.parallel import starmap

PROVE_CHUNK = 64          # blobs a prover call makes triples of, in set-up
WARMUP_BATCHES = 1
PHASE_BATCHES = 2         # batches timed by phase after a traced window


class Kind:
    def __init__(self, config, traffic, seed, device, root, log):
        self.cfg, self.tr = config, traffic
        self.seed, self.device, self.root, self.log = seed, device, root, log
        self.n = config["field_elements_per_blob"]
        self.tau = int(config["setup_tau"], 16)
        self.k = traffic["k"]

    # -- set-up ------------------------------------------------------------

    def setup(self):
        import tpukzg_torch
        tr, n = self.tr, self.n
        self.ts = inputs.trusted_setup(self.cfg, self.device, self.root)
        pool = tr["pool"]
        self.blob_bytes = inputs.blobs(pool, n, self.seed, 1)
        self.c_bytes, self.pi_bytes = [], []
        for i in range(0, pool, PROVE_CHUNK):
            part = self.blob_bytes[i:i + PROVE_CHUNK]
            cs = tpukzg_torch.blob_to_kzg_commitment_batch(part, self.ts)
            self.c_bytes += cs
            self.pi_bytes += tpukzg_torch.compute_blob_kzg_proof_batch(
                part, cs, self.ts)
        self.log(f"{pool} triples made by the program's prover")
        self._plan(pool)
        self.args = [([self.blob_bytes[b] for b, _, _ in s],
                      [self.c_bytes[c] for _, c, _ in s],
                      [self.pi_bytes[p] for _, _, p in s])
                     for s in self.specs]
        self.start = tpukzg_torch.verify_blob_kzg_proof_batch_pipeline
        for b in range(WARMUP_BATCHES):
            pend = self.start(*self.args[-1 - b], self.ts)
            pend.stage2()
            pend.result()

    def _plan(self, pool):
        """The planned batches as lists of (blob id, commitment id, proof
        id) triples; tampers append new blobs and commitments."""
        g = inputs.rng(self.seed, 2)
        tampers = self.tr["tampers"]
        block = 2 * len(tampers)
        off_c = len(self.c_bytes)
        self.c_bytes.append(inputs.off_g1_point(self.seed, 3))
        self.specs, self.tamper = [], []
        for b in range(self.tr["batches_planned"]):
            if b % block == 0:
                order = g.permutation([None] * (block - len(tampers))
                                      + list(tampers))
            kind = order[b % block]
            idx = g.permutation(pool)[:self.k]
            spec = [(int(i), int(i), int(i)) for i in idx]
            pos, other = (int(x) for x in g.choice(self.k, 2, replace=False))
            elem = int(g.integers(self.n))
            bi, ci, pi = spec[pos]
            if kind == "blob_element":
                raw = bytearray(self.blob_bytes[bi])
                raw[32 * elem + 31] ^= 1
                spec[pos] = (self._new_blob(raw), ci, pi)
            elif kind == "element_out_of_range":
                raw = bytearray(self.blob_bytes[bi])
                e = int.from_bytes(raw[32 * elem:32 * elem + 32], "big")
                raw[32 * elem:32 * elem + 32] = (e + ref.R).to_bytes(32, "big")
                values = [int.from_bytes(raw[i:i + 32], "big") % ref.R
                          for i in range(0, len(raw), 32)]
                c, p = ref.open_at_challenge(values, bytes(raw), self.tau,
                                             self.n)
                self.c_bytes.append(c)
                self.pi_bytes.append(p)
                spec[pos] = (self._new_blob(raw), len(self.c_bytes) - 1,
                             len(self.pi_bytes) - 1)
            elif kind == "commitment_off_g1":
                spec[pos] = (bi, off_c, pi)
            elif kind == "proofs_swapped":
                bo, co, po = spec[other]
                spec[pos], spec[other] = (bi, ci, po), (bo, co, pi)
            elif kind is not None:
                raise ValueError(f"unknown tamper {kind!r}")
            self.specs.append(spec)
            self.tamper.append(kind)

    def _new_blob(self, raw) -> int:
        self.blob_bytes.append(bytes(raw))
        return len(self.blob_bytes) - 1

    # -- window ------------------------------------------------------------

    def window(self, seconds, rec):
        """bench.py's schedule until the deadline, then the drain."""
        ts, start, args = self.ts, self.start, self.args
        t0 = time.perf_counter()
        deadline = t0 + seconds
        ids, pend, verdicts = [0], [], []
        with rec.span("verify.stage1"):
            pend.append(start(*args[0], ts))
        stop_at, i = None, 0
        while stop_at is None or i < stop_at:
            rec.step(i)
            if stop_at is None or i + 1 < stop_at:
                ids.append(i + 1)
                with rec.span("verify.stage1"):
                    pend.append(start(*args[(i + 1) % len(args)], ts))
            with rec.span("verify.stage2"):
                pend[i].stage2()
            if i > 0:
                with rec.span("verify.result"):
                    verdicts.append(pend[i - 1].result())
            if stop_at is None and time.perf_counter() >= deadline:
                stop_at = i + 2
            i += 1
        with rec.span("verify.result"):
            verdicts.append(pend[-1].result())
        self.seconds = time.perf_counter() - t0
        rec.step(i, final=True)
        self.ids, self.verdicts = ids, verdicts
        self.attempted = len(ids)

    def end_to_end(self):
        return {"verifications_per_s":
                self.k * len(self.verdicts) / self.seconds}

    def work(self):
        return {}

    # -- after the window ----------------------------------------------------

    def counters(self):
        """Traced runs only: one batch under the dispatch counter, and
        PHASE_BATCHES batches with the engine's phase timing on (each
        phase then ends in a sync)."""
        nxt = len(self.ids)
        args = self.args[nxt % len(self.args)]

        def one():
            pend = self.start(*args, self.ts)
            pend.stage2()
            pend.result()
        out = {"tensor_ops_per_batch.verify": count_dispatch(one)}
        bk = self.ts.blob
        bk.timing = True
        try:
            pair = []
            for _ in range(PHASE_BATCHES):
                one()
                pair.append(bk.last_phases["pairing"])
        finally:
            bk.timing = False
        out["pairing_s_per_batch"] = sum(pair) / len(pair)
        return out

    def release(self):
        self.ts = self.start = None

    def check(self):
        """Every verdict of the window against the reference's."""
        used = sorted({t for b in self.ids
                       for t in self.specs[b % len(self.specs)]})
        valid = dict(zip(used, starmap(ref.blob_valid, [
            (self.blob_bytes[b], self.c_bytes[c], self.pi_bytes[p],
             self.tau, self.n) for b, c, p in used])))
        want = [all(valid[t] for t in self.specs[b % len(self.specs)])
                for b in self.ids]
        wrong = sum(w != v for w, v in zip(want, self.verdicts))
        self.failed = wrong
        self.log(f"verdicts: {len(self.verdicts)} ({sum(want)} valid by the "
                 f"reference, from {len(used)} distinct triples)")
        return [("verdicts_wrong", wrong, 0)]


def _halves(orig):
    def broken(blobs, cs, pfs, ts):
        h = max(1, len(blobs) // 2)
        return orig(blobs[:h], cs[:h], pfs[:h], ts)
    return broken


def _range_unchecked(orig):
    def broken(raw, brp):
        mont, ok = orig(raw, brp)
        return mont, ok | True
    return broken


def _negated(orig):
    class Negated:
        def __init__(self, pend):
            self.pend = pend

        def stage2(self):
            self.pend.stage2()

        def result(self):
            return not self.pend.result()
    return lambda *a: Negated(orig(*a))


def faults() -> dict:
    """{name: () -> context manager}: the control (the range check of blob
    elements skipped, so the forged element_out_of_range triple, which the
    pairing accepts, passes), half of each batch left out, and each
    verdict negated where it is produced."""
    import tpukzg_torch as t
    from tpukzg_torch.kzg import blob
    entry = "verify_blob_kzg_proof_batch_pipeline"
    return {
        "control": lambda: planted.swap((blob, "stage_blobs",
                                         _range_unchecked)),
        "half_batch": lambda: planted.swap((t, entry, _halves)),
        "answer_altered": lambda: planted.swap((t, entry, _negated)),
    }
