"""EIP-4844-shaped blob commitments, proofs and batch verification over
bytes (counterpart of ``tpukzg/kzg/blob.py``).

Blobs are n big-endian 32-byte Fr elements, evaluations on the
bit-reversed domain.  The host does the Fiat-Shamir hashing; the
decompression, staging, evaluation, quotient, MSMs and pairing run on
the setup's device.  The batch verify runs as the JAX package's does: a
pending batch whose three verdicts (pairing, subgroup, range) fold on
the device, with one sync for y and one for the verdict, so it also
runs asynchronously, pipelined and in chunks.
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np
import torch

from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.field.mont import FR, R_MOD, upload
from tpukzg_torch.kzg import transcript
from tpukzg_torch.kzg.core import Kzg
from tpukzg_torch.poly.poly import barycentric_eval
from tpukzg_torch.utils import checked, obs

BYTES_PER_FIELD_ELEMENT = 32
PHASES = ("decompress", "stage_eval", "fold_msm", "pairing")

_R_BE = [int((R_MOD >> (16 * (15 - i))) & 0xFFFF) for i in range(16)]


def stage_blobs(raw, brp):
    """(k, n, 32) uint8 big-endian blob bytes (a tensor) ->
    ((k, n, 16) Montgomery natural-order evals, all-in-range flag)."""
    a = raw.to(torch.int64)
    limbs_be = (a[..., 0::2] << 8) | a[..., 1::2]         # MSB limb first
    ok = torch.zeros(limbs_be.shape[:-1], dtype=torch.bool, device=a.device)
    eq = torch.ones_like(ok)
    for i in range(16):
        ok = ok | (eq & (limbs_be[..., i] < _R_BE[i]))
        eq = eq & (limbs_be[..., i] == _R_BE[i])
    natural = limbs_be.flip(-1)[:, brp]
    return FR.to_mont(natural.to(torch.int32)), ok.all()


def blob_to_limbs(blob: bytes, n: int) -> np.ndarray:
    """n*32 big-endian bytes -> (n, 16) canonical Fr limbs, int32;
    raises ValueError on a wrong length or an element >= r."""
    if len(blob) != n * BYTES_PER_FIELD_ELEMENT:
        raise ValueError(f"blob must be {n * BYTES_PER_FIELD_ELEMENT} bytes")
    a = np.frombuffer(blob, dtype=np.uint8).reshape(n, 32).astype(np.int32)
    limbs_be = (a[:, 0::2] << 8) | a[:, 1::2]            # MSB limb first
    r_be = np.asarray(_R_BE, np.int32)
    diff = limbs_be != r_be
    first = np.argmax(diff, axis=1)                      # first differing
    rows = np.arange(n)
    if not np.all(diff[rows, first] & (limbs_be[rows, first] < r_be[first])):
        raise ValueError("blob element out of Fr range")
    return limbs_be[:, ::-1].copy()


def fr_ints_from_limbs(limbs) -> list[int]:
    a = np.asarray(limbs.cpu() if torch.is_tensor(limbs) else limbs)
    return [FR.to_int(row) for row in a.reshape(-1, 16)]


class BlobKzg:
    def __init__(self, kzg: Kzg):
        self.kzg = kzg
        self.n = kzg.n
        self.device = kzg.device
        self.bytes_per_blob = self.n * BYTES_PER_FIELD_ELEMENT
        self._brp = torch.as_tensor(kzg.plan.brp, device=self.device)
        # Seconds of each phase of the last verify, when `timing` is set
        # (each phase then ends in a device synchronize).
        self.timing = False
        self.last_phases: dict = {}

    # -- prover ------------------------------------------------------------

    def _blob_natural_mont(self, blobs):
        """blobs -> (k, n, 16) Montgomery evals in natural domain order;
        raises ValueError on a wrong length or an element >= r."""
        for b in blobs:
            if len(b) != self.bytes_per_blob:
                raise ValueError(f"blob must be {self.bytes_per_blob} bytes")
        raw = np.frombuffer(b"".join(blobs), np.uint8).reshape(
            len(blobs), self.n, 32)
        mont, ok = stage_blobs(torch.as_tensor(raw.copy()).to(self.device),
                               self._brp)
        if not bool(ok.item()):
            raise ValueError("blob element out of Fr range")
        return mont

    def _z_mont(self, zs):
        return torch.as_tensor(FR.from_int(
            [(zi << 256) % R_MOD for zi in zs]).reshape(len(zs), 16),
            device=self.device)

    def blob_to_kzg_commitment(self, blob: bytes) -> bytes:
        return self.blob_to_kzg_commitment_batch([blob])[0]

    def compute_kzg_proof(self, blob: bytes, z_bytes: bytes):
        """-> (proof_bytes, y_bytes)."""
        evals = self._blob_natural_mont([blob])[0]
        z = FR.to_int(blob_to_limbs(z_bytes, 1)[0])
        pi, y = self.kzg.open(evals, self._z_mont([z])[0])
        return (g1m.compress_points(tuple(c[None] for c in pi))[0],
                transcript.fr_to_bytes(FR.to_int(FR.from_mont(y))))

    def compute_blob_kzg_proof(self, blob: bytes,
                               commitment_bytes: bytes) -> bytes:
        z = transcript.compute_challenge(blob, commitment_bytes, self.n)
        proof, _ = self.compute_kzg_proof(blob, transcript.fr_to_bytes(z))
        return proof

    def blob_to_kzg_commitment_batch(self, blobs) -> list[bytes]:
        """Commit every blob in one batched Lagrange-SRS MSM."""
        if not blobs:
            return []
        return g1m.compress_points(self.kzg.commit(
            self._blob_natural_mont(blobs)))

    def compute_blob_kzg_proof_batch(self, blobs,
                                     commitment_bytes_list) -> list[bytes]:
        """Proofs for k blobs at their Fiat-Shamir points in one batched
        open (barycentric eval, quotient, one MSM per blob)."""
        k = len(blobs)
        if k != len(commitment_bytes_list):
            raise ValueError("blobs and commitments differ in count")
        if k == 0:
            return []
        evals = self._blob_natural_mont(blobs)
        zs = [transcript.compute_challenge(blobs[i], commitment_bytes_list[i],
                                           self.n) for i in range(k)]
        pi, _ = self.kzg.open(evals, self._z_mont(zs))
        return g1m.compress_points(pi)

    def verify_kzg_proof(self, commitment_bytes: bytes, z_bytes: bytes,
                         y_bytes: bytes, proof_bytes: bytes) -> bool:
        """The single verify (c-kzg-4844's verb).  Raises ValueError on a
        malformed point, a point off the curve or outside G1, and z or y
        not a 32-byte element below r."""
        pts, ok = g1m.decompress_batch([commitment_bytes, proof_bytes],
                                       self.device)
        if not bool(ok.all().item()):
            raise ValueError("G1 point not in subgroup")
        z, y = (torch.as_tensor(blob_to_limbs(b, 1)[0], device=self.device)
                for b in (z_bytes, y_bytes))
        ok = self.kzg.verify(tuple(c[0] for c in pts), z, y,
                             tuple(c[1] for c in pts))
        return bool(ok.item())

    def verify_blob_kzg_proof(self, blob: bytes, commitment_bytes: bytes,
                              proof_bytes: bytes) -> bool:
        return self.verify_blob_kzg_proof_batch(
            [blob], [commitment_bytes], [proof_bytes])

    # -- verify ------------------------------------------------------------

    def _decompress_g1_two_async(self, byte_list_a, byte_list_b):
        """Decompress and check two point lists in one batched pass ->
        (pts_a, pts_b, ok on the device) without a sync: the caller folds
        `ok` into its verdict."""
        pts, ok = g1m.decompress_batch(list(byte_list_a) + list(byte_list_b),
                                       self.device)
        ka = len(byte_list_a)
        return (tuple(c[:ka] for c in pts), tuple(c[ka:] for c in pts), ok)

    def _verdict_fold(self, ok, ok_sub, ok_range):
        """The three verdicts in one device bool: pairing, every point in
        G1, every blob element below r."""
        return ok & ok_sub.all() & ok_range

    def verify_blob_kzg_proof_batch(self, blobs, commitment_bytes_list,
                                    proof_bytes_list) -> bool:
        """Batch verify (SURVEY.md section 3.1): host Fiat-Shamir, one
        batched barycentric eval, rho powers, one 3k+1-point fold MSM and
        two pairings; one sync for y and one for the verdict."""
        return self.verify_blob_kzg_proof_batch_async(
            blobs, commitment_bytes_list, proof_bytes_list)()

    def verify_blob_kzg_proof_batch_async(self, blobs, commitment_bytes_list,
                                          proof_bytes_list):
        """Dispatch the front half (blob upload, staging, barycentric
        eval, decompression) now, without waiting for the device, and
        return a `resolve() -> bool` that finishes the batch (y readback,
        rho transcript, fold MSM, pairings, verdict)."""
        return _PendingBatch(self, blobs, commitment_bytes_list,
                             proof_bytes_list).result

    # The 3-stage pipeline.  rho = H(..., y) forces one sync after the
    # eval, but the verdict's sync can wait: stage2() reads y, hashes rho
    # and dispatches the MSM and the pairing without blocking; result()
    # syncs the verdict.  A serving loop keeps the device queue full:
    #
    #     pend[i+1] = batch_pipeline(batch_{i+1})   # upload + eval dispatch
    #     pend[i].stage2()                          # y sync, verify dispatch
    #     ok[i-1] = pend[i-1].result()              # done by now

    def verify_blob_kzg_proof_batch_pipeline(self, blobs,
                                             commitment_bytes_list,
                                             proof_bytes_list):
        """Dispatch the front half now -> a _PendingBatch with .stage2()
        (y sync, transcript, verify dispatch; no wait on the verdict) and
        .result() -> bool (which runs stage2 first if it has not run)."""
        return _PendingBatch(self, blobs, commitment_bytes_list,
                             proof_bytes_list)

    def verify_blob_kzg_proof_batch_chunked(self, blobs, commitment_bytes_list,
                                            proof_bytes_list,
                                            chunk: int = 64,
                                            retries: int = 1) -> bool:
        """Chunked verify for very large batches (SURVEY.md section 5.3):
        a chunk that raises is retried `retries` times, then the error
        propagates; the first chunk that fails makes the call False."""
        k = len(blobs)
        for i in range(0, k, chunk):
            sl = slice(i, min(i + chunk, k))
            for attempt in range(retries + 1):
                try:
                    ok = self.verify_blob_kzg_proof_batch(
                        blobs[sl], commitment_bytes_list[sl],
                        proof_bytes_list[sl])
                    break
                except Exception:
                    if attempt == retries:
                        raise
            if not ok:
                return False
        return True


def _y_to_host(y_dev):
    """The one sync of a batch before its verdict: y feeds the rho
    transcript."""
    return y_dev.cpu()


class _PendingBatch:
    """One batch verification in flight (counterpart of
    ``tpukzg/kzg/blob.py::_PendingBatch``).

    Stage 1 (the constructor): host checks and Fiat-Shamir z, the blob
    bytes' upload, staging, barycentric eval and decompression
    dispatched; nothing waits for the device.
    Stage 2 (`stage2()`): y read back (the one sync), rho hashed, the
    fold MSM, the pairing and the verdict fold dispatched, not waited for.
    `result()`: the verdict's sync (stage 2 first if it has not run).

    With ``TPUKZG_TIMING=1`` each step is marked and `result()` prints
    one ``[timing] label=seconds ...`` line to stderr.  With the engine's
    `timing` set, each phase (decompress, stage_eval, fold_msm, pairing)
    ends in a device sync and its seconds go to ``BlobKzg.last_phases``.
    """

    def __init__(self, bk: BlobKzg, blobs, commitment_bytes_list,
                 proof_bytes_list):
        self._timing = os.environ.get("TPUKZG_TIMING") == "1"
        self._marks = []
        self._bk = bk
        self._failed = None       # host-side reject or empty: fixed verdict
        self._ok_all = None       # the device verdict after stage2
        bk.last_phases = self._phases = {}
        self._mark("begin")
        k = len(blobs)
        if not k == len(commitment_bytes_list) == len(proof_bytes_list):
            raise ValueError("blobs, commitments and proofs differ in count")
        self._k = k
        if k == 0:
            self._failed = True
            return
        if any(len(b) != bk.bytes_per_blob for b in blobs):
            self._failed = False
            return
        dev = bk.device
        if bk.timing and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self._t = time.perf_counter()
        with obs.trace("verify.stage1"):
            try:
                self._c_pts, self._pi_pts, self._ok_sub = \
                    bk._decompress_g1_two_async(commitment_bytes_list,
                                                proof_bytes_list)
            except ValueError:    # malformed encoding (host-side reject)
                self._failed = False
                return
            self._mark("decompress_dispatch")
            self._phase("decompress")
            self._cs, self._pfs = commitment_bytes_list, proof_bytes_list
            # host Fiat-Shamir z = H(blob, C) while the device works; z in
            # Montgomery form by host bignums (z 2^256 mod r)
            zs = [transcript.compute_challenge(blobs[i],
                                               commitment_bytes_list[i], bk.n)
                  for i in range(k)]
            self._zs = zs
            self._z_can = FR.from_int(zs).reshape(k, 16)
            z_mont = FR.from_int([(zi << 256) % R_MOD for zi in zs]).reshape(
                k, 16)
            self._mark("host_fs_z")
            raw = np.frombuffer(b"".join(blobs), np.uint8).reshape(k, bk.n,
                                                                   32)
            self._mark("np_stack")
            raw_dev = upload(raw, dev)
            self._mark("device_put")
            mont, self._ok_range = stage_blobs(raw_dev, bk._brp)
            self._y_dev = FR.from_mont(barycentric_eval(
                bk.kzg.plan, mont, upload(z_mont, dev), bk.kzg.roots))
            self._mark("stage_eval_dispatch")
            self._phase("stage_eval")

    def _mark(self, label):
        if self._timing:
            self._marks.append((label, time.perf_counter()))

    def _phase(self, name):
        """With the engine's timing on, end phase `name` in a device sync
        and record its seconds."""
        bk = self._bk
        if not bk.timing:
            return
        if bk.device.type == "cuda":
            torch.cuda.synchronize(bk.device)
        t = time.perf_counter()
        self._phases[name] = t - self._t
        self._t = t

    def stage2(self) -> None:
        """y sync + rho transcript + verify dispatch (verdict not synced)."""
        if self._failed is not None or self._ok_all is not None:
            return
        bk, k, dev = self._bk, self._k, self._bk.device
        with obs.trace("verify.stage2"):
            self._mark("stage2_begin")
            y_can = _y_to_host(self._y_dev)
            self._mark("y_sync")
            ys = fr_ints_from_limbs(y_can)
            _, rho_powers = transcript.compute_r_powers(
                self._cs, self._zs, ys, self._pfs, bk.n)
            rho_can = FR.from_int(rho_powers).reshape(k, 16)
            self._mark("host_fs_rho")
            checked.check_limbs("verify_batch.z", self._z_can)
            checked.check_limbs("verify_batch.y", y_can)
            checked.check_limbs("verify_batch.rho", rho_can)
            pi_agg, lhs = bk.kzg.verify_batch_msm(
                self._c_pts, upload(self._z_can, dev), self._y_dev,
                self._pi_pts, upload(rho_can, dev))
            self._phase("fold_msm")
            ok = bk.kzg.verify_batch_pair(pi_agg, lhs)
            self._mark("verify_batch_dispatch")
            # one device->host read for all three verdicts, at result()
            self._ok_all = bk._verdict_fold(ok, self._ok_sub, self._ok_range)
            self._mark("verdict_dispatch")
            self._phase("pairing")

    def result(self) -> bool:
        if self._failed is not None:
            return self._failed
        self.stage2()
        out = bool(self._ok_all.item())
        self._mark("verdict_sync")
        if self._timing:
            prev = self._marks[0][1]
            parts = []
            for lbl, t in self._marks[1:]:
                parts.append(f"{lbl}={t - prev:.3f}")
                prev = t
            print("[timing]", " ".join(parts), file=sys.stderr, flush=True)
        return out
