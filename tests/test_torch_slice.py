"""The port's verify_blob_kzg_proof_batch as a whole, on the CPU at n=16,
against the JAX package and the golden model.

Verdicts come from golden.verify_blob_kzg_proof_batch: the JAX verdict
needs its pairing program, whose XLA:CPU compile takes minutes.  The JAX
package still checks the intermediates: y exact against its barycentric
eval, (pi_agg, lhs) affine-equal against its grouped fold MSM."""

import random

import numpy as np
import pytest
import torch

import golden.model as gold
import tpukzg_torch as tt
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.field.mont import FR
from tpukzg_torch.kzg import transcript
from tpukzg_torch.kzg.blob import stage_blobs
from tpukzg_torch.poly.poly import barycentric_eval

N = 16
TAU = 0xDEADBEEF

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def gs():
    return gold.GoldenSetup(TAU, N)


@pytest.fixture(scope="module")
def triples(gs):
    rng = random.Random(41)
    blobs = [b"".join(rng.randrange(gold.R).to_bytes(32, "big")
                      for _ in range(N)) for _ in range(3)]
    cs = [gold.g1_compress(gold.blob_to_kzg_commitment(
        gs, gold.blob_from_bytes(b))) for b in blobs]
    pfs = [gold.g1_compress(gold.compute_blob_kzg_proof(
        gs, gold.blob_from_bytes(b), c)[0]) for b, c in zip(blobs, cs)]
    return blobs, cs, pfs


@pytest.fixture(scope="module")
def ts():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


def _tampered(pfs):
    bad = bytearray(pfs[1])
    bad[13] ^= 4
    return [pfs[0], bytes(bad), pfs[2]]


@pytest.mark.parametrize("case", ["valid", "tampered", "swapped"])
def test_verdict_matches_golden(ts, gs, triples, case):
    """tampered: a flipped proof bit (rejected while decoding); swapped:
    two valid proofs exchanged (rejected by the pairing check)."""
    blobs, cs, pfs = triples
    if case == "tampered":
        pfs = _tampered(pfs)
    elif case == "swapped":
        pfs = [pfs[1], pfs[0], pfs[2]]
    try:
        want = gold.verify_blob_kzg_proof_batch(
            gs, [gold.blob_from_bytes(b) for b in blobs], cs, pfs)
    except ValueError:          # golden rejects the point while decoding
        want = False
    got = tt.verify_blob_kzg_proof_batch(blobs, cs, pfs, ts)
    assert got is want is (case == "valid")


def test_empty_and_malformed_batches(ts, triples):
    blobs, cs, pfs = triples
    assert tt.verify_blob_kzg_proof_batch([], [], [], ts) is True
    assert tt.verify_blob_kzg_proof_batch(
        [blobs[0][:-32]], cs[:1], pfs[:1], ts) is False     # wrong length
    assert tt.verify_blob_kzg_proof_batch(
        blobs[:1], [b"\x00" * 48], pfs[:1], ts) is False    # bad flags
    assert tt.verify_blob_kzg_proof_batch(
        [b"\xff" * (32 * N)], cs[:1], pfs[:1], ts) is False  # element >= r


def _front_half(ts, blobs, cs):
    """The port's staging + eval on the CPU -> (z ints, z_mont, y_can)."""
    k = len(blobs)
    zs = [transcript.compute_challenge(b, c, N) for b, c in zip(blobs, cs)]
    z_mont = torch.from_numpy(FR.to_mont_host(zs))
    raw = torch.from_numpy(np.frombuffer(b"".join(blobs), np.uint8)
                           .reshape(k, N, 32).copy())
    mont, ok = stage_blobs(raw, torch.from_numpy(ts.setup.plan.brp))
    assert bool(ok)
    y = FR.from_mont(barycentric_eval(ts.setup.plan, mont, z_mont))
    return zs, z_mont, mont, y


def test_y_matches_jax_barycentric(ts, gs, triples):
    from tpukzg.ntt.ntt import get_plan as jplan
    from tpukzg.poly.poly import barycentric_eval_jit
    blobs, cs, _ = triples
    zs, z_mont, mont, y = _front_half(ts, blobs, cs)
    ref = np.asarray(barycentric_eval_jit(
        jplan(N), mont.numpy().astype(np.uint32),
        z_mont.numpy().astype(np.uint32)))
    got = FR.to_mont(y).numpy()
    assert np.array_equal(got, ref.astype(np.int32))
    for i, b in enumerate(blobs):
        want = gold.barycentric_eval(
            gold._blob_to_natural(gs, gold.blob_from_bytes(b)), zs[i])
        assert FR.to_int(y[i]) == want


def test_fold_msm_matches_jax_kzg(ts, triples):
    import tpukzg
    blobs, cs, pfs = triples
    k = len(blobs)
    zs, _, _, y = _front_half(ts, blobs, cs)
    ys = [FR.to_int(r) for r in y]
    _, rho = transcript.compute_r_powers(cs, zs, ys, pfs, N)
    pts, ok = tg1.decompress_batch(cs + pfs, "cpu")
    assert bool(ok.all())
    c_pts = tuple(c[:k] for c in pts)
    pi_pts = tuple(c[k:] for c in pts)
    z_can = torch.from_numpy(FR.from_int(zs))
    rho_can = torch.from_numpy(FR.from_int(rho))
    pi_agg, lhs = ts.kzg.verify_batch_msm(c_pts, z_can, y, pi_pts, rho_can)

    jts = tpukzg.generate_insecure_setup(TAU, N)
    u32 = lambda t: tuple(c.numpy().astype(np.uint32) for c in t)  # noqa: E731
    jpi, jlhs = jts.kzg._vb_msm(u32(c_pts), z_can.numpy().astype(np.uint32),
                                y.numpy().astype(np.uint32), u32(pi_pts),
                                rho_can.numpy().astype(np.uint32))
    for got, ref in ((pi_agg, jpi), (lhs, jlhs)):
        ref_t = tuple(torch.from_numpy(np.asarray(c).astype(np.int32))
                      for c in ref)
        assert tg1.point_to_ints(got) == tg1.point_to_ints(ref_t)
    # pi_agg = sum rho^i pi_i, by the golden model
    want = gold.g1_msm([gold.g1_decompress(p) for p in pfs], rho)
    assert tg1.point_to_ints(pi_agg)[:2] == gold.g1_affine(want)
