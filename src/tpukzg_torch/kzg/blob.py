"""EIP-4844-shaped blob commitments, proofs and batch verification over
bytes (counterpart of ``tpukzg/kzg/blob.py:29-58, 88-105, 129-142,
171-428``), run synchronously.

Blobs are n big-endian 32-byte Fr elements, evaluations on the
bit-reversed domain.  The host does the Fiat-Shamir hashing; the
decompression, staging, evaluation, quotient, MSMs and pairing run on
the setup's device.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from tpukzg_torch.curve import g1 as g1m
from tpukzg_torch.field.mont import FR, R_MOD
from tpukzg_torch.kzg import transcript
from tpukzg_torch.kzg.core import Kzg
from tpukzg_torch.poly.poly import barycentric_eval

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

    def _mark(self, name, t0):
        """Record phase `name` as ending now (after a device sync) when
        timing is on; returns the start of the next phase."""
        if not self.timing:
            return t0
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t = time.perf_counter()
        self.last_phases[name] = t - t0
        return t

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

    def verify_blob_kzg_proof_batch(self, blobs, commitment_bytes_list,
                                    proof_bytes_list) -> bool:
        k = len(blobs)
        if not k == len(commitment_bytes_list) == len(proof_bytes_list):
            raise ValueError("blobs, commitments and proofs differ in count")
        if k == 0:
            return True
        if any(len(b) != self.bytes_per_blob for b in blobs):
            return False
        dev = self.device
        self.last_phases = {}
        if self.timing and dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t = time.perf_counter()
        try:
            pts, ok_sub = g1m.decompress_batch(
                list(commitment_bytes_list) + list(proof_bytes_list), dev)
        except ValueError:                 # malformed encoding
            return False
        c_pts = tuple(c[:k] for c in pts)
        pi_pts = tuple(c[k:] for c in pts)
        t = self._mark("decompress", t)

        zs = [transcript.compute_challenge(blobs[i], commitment_bytes_list[i],
                                           self.n) for i in range(k)]
        z_can = torch.as_tensor(FR.from_int(zs).reshape(k, 16), device=dev)
        z_mont = self._z_mont(zs)
        raw = np.frombuffer(b"".join(blobs), np.uint8).reshape(k, self.n, 32)
        raw_t = torch.as_tensor(raw.copy()).to(dev)
        mont, ok_range = stage_blobs(raw_t, self._brp)
        y_can = FR.from_mont(barycentric_eval(self.kzg.plan, mont, z_mont,
                                              self.kzg.roots))
        ys = fr_ints_from_limbs(y_can)     # sync: y feeds the transcript
        t = self._mark("stage_eval", t)
        # the verdict is False already: skip the MSM and the pairings
        if not bool((ok_sub.all() & ok_range).item()):
            return False

        _, rho_powers = transcript.compute_r_powers(
            commitment_bytes_list, zs, ys, proof_bytes_list, self.n)
        rho_can = torch.as_tensor(FR.from_int(rho_powers).reshape(k, 16),
                                  device=dev)
        pi_agg, lhs = self.kzg.verify_batch_msm(c_pts, z_can, y_can, pi_pts,
                                                rho_can)
        t = self._mark("fold_msm", t)
        ok = self.kzg.verify_batch_pair(pi_agg, lhs)
        verdict = bool(ok.item())
        self._mark("pairing", t)
        return verdict
