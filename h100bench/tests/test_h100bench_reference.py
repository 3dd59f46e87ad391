"""The plain reference against the repository's known-answer vectors and
plain-integer sums, at small sizes."""

import json
import os

import numpy as np

from h100bench.tests import tiny
from h100bench import inputs
from h100bench.reference import bls, kzg

with open(os.path.join(tiny.REPO, "tests", "vectors", "kat.json")) as fh:
    KAT = json.load(fh)


def test_commitment_proof_and_verdict_of_the_kat_blob():
    k = KAT["kzg"]
    blob, tau, n = bytes.fromhex(k["blob"]), int(k["tau"], 16), k["n"]
    c, p = kzg.commit_and_prove(blob, tau, n)
    assert c.hex() == k["commitment"] and p.hex() == k["proof"]
    assert kzg.challenge(blob, c, n) == int(k["challenge_z"], 16)
    z = int(k["challenge_z"], 16)
    assert kzg.evaluate(kzg.blob_elements(blob, n), z) == int(k["eval_y"], 16)
    assert kzg.blob_valid(blob, c, p, tau, n) is k["verify"]


def test_g1_multiples_and_encodings():
    for s, enc in KAT["g1_multiples"].items():
        pt = bls.mul(bls.GEN, int(s))
        assert bls.compress(pt) == bytes.fromhex(enc)
        if int(s) < 1 << 256:
            assert bls.compress(bls.mul_gen(int(s))) == bytes.fromhex(enc)
        back = bls.decompress(bytes.fromhex(enc))
        assert bls.affine(back) == bls.affine(pt)


def test_refusals():
    k = KAT["kzg"]
    blob, tau, n = bytes.fromhex(k["blob"]), int(k["tau"], 16), k["n"]
    c, p = bytes.fromhex(k["commitment"]), bytes.fromhex(k["proof"])
    flipped = bytearray(blob)
    flipped[31] ^= 1
    assert not kzg.blob_valid(bytes(flipped), c, p, tau, n)
    big = bytearray(blob)
    e = int.from_bytes(blob[:32], "big") + kzg.R
    big[:32] = e.to_bytes(32, "big")
    assert not kzg.blob_valid(bytes(big), c, p, tau, n)
    off = inputs.off_g1_point(1, 3)
    assert bls.decompress(off) is not None
    assert not bls.in_g1(bls.decompress(off))
    assert not kzg.blob_valid(blob, off, p, tau, n)
    assert not kzg.blob_valid(blob, c, off, tau, n)
    assert not kzg.blob_valid(blob, c, c, tau, n)
    assert bls.decompress(bytes([0x80]) + bytes(47)) is None or \
        bls.on_curve(bls.affine(bls.decompress(bytes([0x80]) + bytes(47))))


def test_in_domain_evaluation():
    elems = list(range(1, 17))
    roots = kzg.domain(16)
    assert kzg.evaluate(elems, roots[5]) == 6


def test_msm_sum_and_output_points():
    g = np.random.default_rng(5)
    k = g.integers(0, 1 << 16, size=(300, 16))
    s = g.integers(0, 1 << 16, size=(300, 16))
    ki = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in k]
    si = [int.from_bytes(r.astype("<u2").tobytes(), "little") for r in s]
    assert kzg.dot_mod_r(kzg.limb_bytes(k), kzg.limb_bytes(s)) == \
        sum(a * b for a, b in zip(ki, si)) % kzg.R
    # a projective Montgomery point (X, Y, Z) = (x z R, y z R, z R)
    x, y = bls.affine(bls.mul_gen(12345))
    zr = 777 * (1 << 384) % bls.P
    limbs = [np.frombuffer((v * zr % bls.P).to_bytes(48, "little"), "<u2")
             for v in (x, y, 1)]
    assert kzg.point_from_limbs(*limbs) == (x, y)
    assert kzg.point_from_limbs(limbs[0], limbs[1],
                                np.zeros(24, "<u2")) is None
