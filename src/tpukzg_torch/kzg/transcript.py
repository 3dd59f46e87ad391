"""Fiat-Shamir transcript, host-side SHA-256 (copy of
``tpukzg/kzg/transcript.py`` with its own R_MOD)."""

from __future__ import annotations

import hashlib

from tpukzg_torch.field.mont import R_MOD

FIAT_SHAMIR_DOMAIN = b"FSBLOBVERIFY_V1_"
RANDOM_CHALLENGE_DOMAIN = b"RCKZGBATCH___V1_"
BYTES_PER_FIELD_ELEMENT = 32


def hash_to_fr(data: bytes) -> int:
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R_MOD


def fr_to_bytes(x: int) -> bytes:
    return (x % R_MOD).to_bytes(32, "big")


def compute_challenge(blob_bytes: bytes, commitment_bytes: bytes, n: int) -> int:
    data = (FIAT_SHAMIR_DOMAIN + n.to_bytes(16, "big")
            + blob_bytes + commitment_bytes)
    return hash_to_fr(data)


def compute_r_powers(commitment_bytes_list, zs, ys, proof_bytes_list, n: int):
    k = len(commitment_bytes_list)
    data = RANDOM_CHALLENGE_DOMAIN + n.to_bytes(16, "big") + k.to_bytes(8, "big")
    for i in range(k):
        data += commitment_bytes_list[i]
        data += fr_to_bytes(zs[i])
        data += fr_to_bytes(ys[i])
        data += proof_bytes_list[i]
    rho = hash_to_fr(data)
    powers = [1] * k
    for i in range(1, k):
        powers[i] = (powers[i - 1] * rho) % R_MOD
    return rho, powers
