"""EIP-4844 blob commitments, proofs and verdicts, and MSM answers, worked
out in plain Python from the inputs and the setup's tau.

The setup is the insecure one of a known tau, so [tau]_2 need not be
paired with: for points in G1, e(C - [y] G1, G2) == e(pi, [tau - z] G2)
holds exactly when C - [y] G1 == [tau - z] pi.  A blob's verdict is True
when its 32-byte elements are all below r, C and pi decode to points of
the curve, pi lies in G1 and that equation holds (which puts C in G1
too).  A batch's verdict is the AND of its blobs' verdicts.

Blobs hold evaluations on the bit-reversed domain of the n-th roots of
unity; the Fiat-Shamir point is z = SHA-256(domain, n, blob, C) mod r,
as EIP-4844's compute_challenge with this package's domain tag.
"""

from __future__ import annotations

import functools
import hashlib

import numpy as np

from h100bench.reference import bls

R = bls.R
FIAT_SHAMIR_DOMAIN = b"FSBLOBVERIFY_V1_"


@functools.lru_cache(maxsize=4)
def domain(n: int):
    """The n-th roots of unity in bit-reversed order (a blob's order)."""
    w = bls.fr_omega(n)
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * w % R
    bits = n.bit_length() - 1
    return tuple(roots[int(format(i, f"0{bits}b")[::-1], 2)] if bits else 1
                 for i in range(n))


def blob_elements(blob: bytes, n: int):
    """-> the n elements, or None if one is not below r."""
    if len(blob) != 32 * n:
        return None
    out = [int.from_bytes(blob[i:i + 32], "big") for i in range(0, 32 * n, 32)]
    return None if any(e >= R for e in out) else out


def challenge(blob: bytes, commitment: bytes, n: int) -> int:
    data = FIAT_SHAMIR_DOMAIN + n.to_bytes(16, "big") + blob + commitment
    return int.from_bytes(hashlib.sha256(data).digest(), "big") % R


def _batch_inverse(xs):
    pre = [1] * (len(xs) + 1)
    for i, x in enumerate(xs):
        pre[i + 1] = pre[i] * x % R
    inv = pow(pre[-1], -1, R)
    out = [0] * len(xs)
    for i in range(len(xs) - 1, -1, -1):
        out[i] = pre[i] * inv % R
        inv = inv * xs[i] % R
    return out


def evaluate(elems, z: int) -> int:
    """p(z) for the polynomial whose values on the blob's domain are
    `elems`: the barycentric formula (z^n - 1)/n sum e_i w_i / (z - w_i),
    or e_m where z = w_m."""
    n = len(elems)
    roots = domain(n)
    z %= R
    if z in roots:
        return elems[roots.index(z)]
    inv = _batch_inverse([(z - w) % R for w in roots])
    acc = 0
    for e, w, iv in zip(elems, roots, inv):
        acc += e * w % R * iv
    return acc % R * ((pow(z, n, R) - 1) * pow(n, -1, R) % R) % R


@functools.lru_cache(maxsize=4)
def lagrange_at(tau: int, n: int):
    """L_i(tau) over the blob's domain, so that p(tau) = sum e_i L_i(tau)
    (tau outside the domain)."""
    roots = domain(n)
    inv = _batch_inverse([(tau - w) % R for w in roots])
    f = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    return tuple(f * w % R * iv % R for w, iv in zip(roots, inv))


def commit_and_prove(blob: bytes, tau: int, n: int):
    """-> (commitment bytes, proof bytes) of a valid blob."""
    elems = blob_elements(blob, n)
    if elems is None:
        raise ValueError("blob element out of range")
    return open_at_challenge(elems, blob, tau, n)


def open_at_challenge(elems, blob: bytes, tau: int, n: int):
    """C = [p(tau)] G1 for the values `elems`, z the challenge of the bytes
    `blob` and C, y = p(z), pi = [(p(tau) - y) / (tau - z)] G1 -> (C, pi)
    as bytes."""
    p_tau = sum(e * l for e, l in zip(elems, lagrange_at(tau, n))) % R
    c = bls.compress(bls.mul_gen(p_tau))
    z = challenge(blob, c, n)
    y = evaluate(elems, z)
    q = (p_tau - y) * pow((tau - z) % R, -1, R) % R
    return c, bls.compress(bls.mul_gen(q))


def blob_valid(blob: bytes, commitment: bytes, proof: bytes, tau: int,
               n: int) -> bool:
    """The verdict of verify_blob_kzg_proof on one triple."""
    elems = blob_elements(blob, n)
    c = bls.decompress(commitment)
    pi = bls.decompress(proof)
    if elems is None or c is None or pi is None or not bls.in_g1(pi):
        return False
    z = challenge(blob, commitment, n)
    y = evaluate(elems, z)
    lhs = bls.add(c, bls.neg(bls.mul_gen(y)))
    rhs = bls.mul(pi, (tau - z) % R)
    return bls.affine(lhs) == bls.affine(rhs)


def _limbs_to_ints(limbs16) -> list:
    """(m, L) 16-bit limbs, least significant first -> m ints."""
    a = np.ascontiguousarray(np.asarray(limbs16, dtype="<u2"))
    return [int.from_bytes(row.tobytes(), "little") for row in a]


def limb_bytes(a16):
    """(N, 16) arrays of 16-bit limbs (least significant first) -> their
    (N, 32) little-endian bytes as float64."""
    a = np.ascontiguousarray(np.asarray(a16).astype("<i4"))
    return a.view(np.uint8).reshape(len(a), 16, 4)[:, :, :2].reshape(
        len(a), 32).astype(np.float64)


def dot_mod_r(k_bytes, s_bytes) -> int:
    """sum_i k_i s_i mod r for values given by limb_bytes: the 32 x 32 sums
    of byte products taken in float64 (each below 2^16 N, exact for
    N < 2^37), then recombined in Python integers."""
    m = k_bytes.T @ s_bytes
    total = 0
    for i in range(32):
        for j in range(32):
            total += int(m[i, j]) << (8 * (i + j))
    return total % R


def msm_answer(k16, s_bytes):
    """The affine point sum_i [k_i] P_i where P_i = [s_i] G1, from the
    scalars' limbs k and the discrete logs s (as limb_bytes) alone."""
    return bls.affine(bls.mul_gen(dot_mod_r(limb_bytes(k16), s_bytes)))


def point_from_limbs(X16, Y16, Z16):
    """A program's output point, coordinates as 24 16-bit Montgomery limbs
    each (homogeneous projective) -> affine (x, y) or None."""
    X, Y, Z = _limbs_to_ints(np.stack([X16, Y16, Z16]))
    return bls.from_projective_mont(X, Y, Z)
