"""Public API, c-kzg-4844-shaped (counterpart of ``tpukzg/api.py``).

    ts = tpukzg_torch.generate_insecure_setup(tau, n)         # on the card
    ts = tpukzg_torch.load_trusted_setup(mono_b, lag_b, g2_tau_b)
    cs = tpukzg_torch.blob_to_kzg_commitment_batch(blobs, ts)
    pfs = tpukzg_torch.compute_blob_kzg_proof_batch(blobs, cs, ts)
    ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, pfs, ts)
    ok = tpukzg_torch.verify_kzg_proof(c, z_bytes, y_bytes, proof, ts)

    resolve = tpukzg_torch.verify_blob_kzg_proof_batch_async(blobs, cs, pfs, ts)
    pend = tpukzg_torch.verify_blob_kzg_proof_batch_pipeline(blobs, cs, pfs, ts)
    pend.stage2(); ok = pend.result()
    ok = tpukzg_torch.verify_blob_kzg_proof_batch_chunked(blobs, cs, pfs, ts)

Coefficient-form and field-level calls live on ``ts.kzg`` (``interpolate``,
``to_evals``, ``commit``, ``commit_coeff``, ``open``, ``open_coeff``,
``eval_at``).

Every entry point runs on the card unless `device` names another one;
with no card and no device given it raises.
"""

from __future__ import annotations

from tpukzg_torch.kzg.blob import BlobKzg as _BlobKzg
from tpukzg_torch.kzg.core import Kzg as _Kzg
from tpukzg_torch.kzg.setup import Setup as _Setup


class TrustedSetup:
    """SRS on one torch device, with its KZG and blob engines."""

    def __init__(self, setup: _Setup):
        self.setup = setup
        self.device = setup.device
        self.kzg = _Kzg(setup)
        self.blob = _BlobKzg(self.kzg)
        self.n = setup.n
        self.bytes_per_blob = self.blob.bytes_per_blob


def generate_insecure_setup(tau: int, n: int, device=None) -> TrustedSetup:
    """The dev SRS of (tau, n), cached or generated — INSECURE by
    construction."""
    return TrustedSetup(_Setup.generate_insecure(tau, n, device=device))


def load_trusted_setup(g1_monomial_bytes, g1_lagrange_bytes, g2_tau_bytes,
                       device=None) -> TrustedSetup:
    """A setup from compressed points (48-byte G1, 96-byte [tau]_2), each
    checked for its subgroup (c-kzg-4844 shape)."""
    return TrustedSetup(_Setup.from_compressed(
        g1_monomial_bytes, g1_lagrange_bytes, g2_tau_bytes, device=device))


def load_setup_file(path: str, device=None) -> TrustedSetup:
    """Load a .npz SRS written by the JAX package (layout v2; a layout-v1
    file, which has no Miller lines, gets them computed)."""
    return TrustedSetup(_Setup.load(path, device))


def blob_to_kzg_commitment(blob: bytes, ts: TrustedSetup) -> bytes:
    return ts.blob.blob_to_kzg_commitment(blob)


def compute_kzg_proof(blob: bytes, z_bytes: bytes, ts: TrustedSetup):
    """-> (proof_bytes, y_bytes)."""
    return ts.blob.compute_kzg_proof(blob, z_bytes)


def compute_blob_kzg_proof(blob: bytes, commitment_bytes: bytes,
                           ts: TrustedSetup) -> bytes:
    return ts.blob.compute_blob_kzg_proof(blob, commitment_bytes)


def blob_to_kzg_commitment_batch(blobs, ts: TrustedSetup) -> list[bytes]:
    """Commit k blobs in one batched MSM."""
    return ts.blob.blob_to_kzg_commitment_batch(blobs)


def compute_blob_kzg_proof_batch(blobs, commitment_bytes_list,
                                 ts: TrustedSetup) -> list[bytes]:
    """Prove k blobs in one batched open."""
    return ts.blob.compute_blob_kzg_proof_batch(blobs, commitment_bytes_list)


def verify_kzg_proof(commitment_bytes: bytes, z_bytes: bytes, y_bytes: bytes,
                     proof_bytes: bytes, ts: TrustedSetup) -> bool:
    """Does the proof open the commitment to y at z?"""
    return ts.blob.verify_kzg_proof(commitment_bytes, z_bytes, y_bytes,
                                    proof_bytes)


def verify_blob_kzg_proof(blob: bytes, commitment_bytes: bytes,
                          proof_bytes: bytes, ts: TrustedSetup) -> bool:
    return ts.blob.verify_blob_kzg_proof(blob, commitment_bytes, proof_bytes)


def verify_blob_kzg_proof_batch(blobs, commitment_bytes_list,
                                proof_bytes_list, ts: TrustedSetup) -> bool:
    return ts.blob.verify_blob_kzg_proof_batch(
        blobs, commitment_bytes_list, proof_bytes_list)



def verify_blob_kzg_proof_batch_async(blobs, commitment_bytes_list,
                                      proof_bytes_list, ts: TrustedSetup):
    """Dispatch the front half now; returns resolve() -> bool.  Lets a
    serving loop overlap batch i+1's upload with batch i's device work
    (see BlobKzg.verify_blob_kzg_proof_batch_async)."""
    return ts.blob.verify_blob_kzg_proof_batch_async(
        blobs, commitment_bytes_list, proof_bytes_list)


def verify_blob_kzg_proof_batch_pipeline(blobs, commitment_bytes_list,
                                         proof_bytes_list, ts: TrustedSetup):
    """3-stage pipelined verify: returns a pending batch with .stage2()
    (y sync + verify dispatch, non-blocking) and .result() -> bool, so a
    serving loop keeps the device queue full across batches (see
    BlobKzg.verify_blob_kzg_proof_batch_pipeline)."""
    return ts.blob.verify_blob_kzg_proof_batch_pipeline(
        blobs, commitment_bytes_list, proof_bytes_list)


def verify_blob_kzg_proof_batch_chunked(blobs, commitment_bytes_list,
                                        proof_bytes_list, ts: TrustedSetup,
                                        chunk: int = 64,
                                        retries: int = 1) -> bool:
    """Verify in chunks of `chunk` blobs, retrying a chunk that raises
    `retries` times before the error propagates."""
    return ts.blob.verify_blob_kzg_proof_batch_chunked(
        blobs, commitment_bytes_list, proof_bytes_list,
        chunk=chunk, retries=retries)
