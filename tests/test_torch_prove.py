"""The port's prover path (blob commitments and proofs, coefficient-form
commit/open through the NTT) on the CPU at n = 16, against the KATs, the
golden model and the JAX package.

The fixed-base MSM is held against golden multiples and golden MSMs, not
against the JAX ``PippengerLM.msm_fixed``: its XLA:CPU compile (a
Hillis-Steele scan of complete adds) costs minutes.  On the CPU one MSM
row (64 windows x 16 points, plain scan) takes ~3 s, so the tests
share their commitments and proofs through module fixtures.

Tolerances: field values and bytes exact; points affine-equal."""

import json
import os
import random

import numpy as np
import pytest
import torch

import golden.model as gold
import tpukzg_torch as tt
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.field.mont import FP, FR
from tpukzg_torch.kzg.blob import blob_to_limbs
from tpukzg_torch.msm.pippenger_lm import msm_fixed
from tpukzg_torch.poly.poly import eval_form_quotient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TAU = 0xDEADBEEF

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def kat():
    with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def ts():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


@pytest.fixture(scope="module")
def gs():
    return gold.GoldenSetup(TAU, N)


@pytest.fixture(scope="module")
def blobs(kat):
    rng = random.Random(52)
    vals = [rng.randrange(gold.R) for _ in range(N)]
    vals[2] = vals[9] = 0                       # zero scalars stay inert
    vals[4] = gold.R - 1
    other = b"".join(v.to_bytes(32, "big") for v in vals)
    return [bytes.fromhex(kat["kzg"]["blob"]), other]


@pytest.fixture(scope="module")
def batch(ts, blobs):
    cs = tt.blob_to_kzg_commitment_batch(blobs, ts)
    return cs, tt.compute_blob_kzg_proof_batch(blobs, cs, ts)


def test_batch_calls_vs_kat_and_golden(kat, gs, blobs, batch):
    cs, pfs = batch
    assert cs[0].hex() == kat["kzg"]["commitment"]
    assert pfs[0].hex() == kat["kzg"]["proof"]
    blob = gold.blob_from_bytes(blobs[1])
    c = gold.g1_compress(gold.blob_to_kzg_commitment(gs, blob))
    assert cs[1] == c
    assert pfs[1] == gold.g1_compress(
        gold.compute_blob_kzg_proof(gs, blob, c)[0])


def test_single_calls_match_batch(ts, blobs, batch):
    cs, pfs = batch
    assert tt.blob_to_kzg_commitment(blobs[1], ts) == cs[1]
    assert tt.compute_blob_kzg_proof(blobs[1], cs[1], ts) == pfs[1]


def test_compute_kzg_proof_in_domain_kat(kat, ts):
    """z = w^5 takes the quotient's correction branch.  (KAT kzg_open,
    out of the domain, is `test_coeff_form_paths`'s opening.)"""
    key = "kzg_open_in_domain"
    blob = bytes.fromhex(kat["kzg"]["blob"])
    z = int(kat[key]["z"], 16).to_bytes(32, "big")
    proof, y = tt.compute_kzg_proof(blob, z, ts)
    assert proof.hex() == kat[key]["proof"]
    assert int.from_bytes(y, "big") == int(kat[key]["y"], 16)


def test_coeff_form_paths(kat, gs, ts, blobs):
    """commit_coeff(interpolate(e)) is the blob's commitment, and
    open_coeff at z gives KAT kzg_open's proof and y, the evaluation-form
    opening (NTT, then `open`)."""
    kzg = ts.kzg
    evals = ts.blob._blob_natural_mont(blobs[:1])[0]
    coeffs = kzg.interpolate(evals)
    want = gold.intt(gold.bit_reversal_permutation(
        gold.blob_from_bytes(blobs[0])))
    assert FR.to_int(FR.from_mont(coeffs)) == want
    assert torch.equal(kzg.to_evals(coeffs), evals)
    c = tg1.compress_points(tuple(x[None] for x in kzg.commit_coeff(coeffs)))
    assert c[0].hex() == kat["kzg"]["commitment"]
    assert c[0] == gold.g1_compress(gold.commit_coeff(gs, want))
    z = int(kat["kzg_open"]["z"], 16)
    pi, y = kzg.open_coeff(coeffs, torch.from_numpy(FR.to_mont_host(z)))
    assert tg1.compress_points(tuple(x[None] for x in pi))[0].hex() == \
        kat["kzg_open"]["proof"]
    assert FR.to_int(FR.from_mont(y)) == int(kat["kzg_open"]["y"], 16)


def test_eval_form_quotient_vs_jax_and_golden(gs):
    import jax
    from tpukzg.field.mont import FR as JFR
    from tpukzg.ntt.ntt import get_plan as jax_plan
    from tpukzg.poly.poly import eval_form_quotient as jax_quotient
    from tpukzg_torch.ntt.ntt import get_plan
    rng = random.Random(17)
    ev = [[rng.randrange(gold.R) for _ in range(N)] for _ in range(2)]
    zs = [rng.randrange(gold.R), gs.roots[5]]                # in-domain
    ys = [gold.barycentric_eval(e, z, gs.omega) for e, z in zip(ev, zs)]
    e_m = FR.to_mont_host(sum(ev, [])).reshape(2, N, 16)
    z_m, y_m = FR.to_mont_host(zs), FR.to_mont_host(ys)
    got = eval_form_quotient(get_plan(N), *(torch.from_numpy(a)
                                            for a in (e_m, z_m, y_m)))
    jplan = jax_plan(N)
    want = np.asarray(jax.jit(lambda e, z, y: jax_quotient(jplan, e, z, y))(
        *(a.astype(np.uint32) for a in (e_m, z_m, y_m))))
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    for i in range(2):
        assert FR.to_int(FR.from_mont(got[i])) == gold.eval_form_quotient(
            ev[i], zs[i], ys[i], gs.omega)


def test_fixed_table_vs_golden(gs, ts):
    """table[:, w, i] = [2^(c w)] L_i.  (msm_fixed itself is every
    commitment and proof above, the golden blob's zero and r - 1
    elements included.)"""
    c = ts.kzg.c_commit
    table = ts.kzg.table("lag")
    W = table[0].shape[1]
    assert W == -(-256 // c)
    for w in (0, 1, W - 1):
        x, y, inf = tg1.normalize(tuple(t[:, w].T for t in table))
        for i in (0, 7, N - 1):
            want = gold.g1_mul(gs.g1_lagrange[i], 1 << (c * w))
            assert (FP.to_int(FP.from_mont(x[i])),
                    FP.to_int(FP.from_mont(y[i]))) == \
                gold.g1_affine(want)
    empty = msm_fixed(table, torch.zeros((0, N, 16), dtype=torch.int32), c)
    assert all(p.shape == (0, 24) for p in empty)


def test_value_errors_and_empty_batches(ts, kat):
    blob = bytes.fromhex(kat["kzg"]["blob"])
    c = bytes.fromhex(kat["kzg"]["commitment"])
    high = (gold.R).to_bytes(32, "big") + blob[32:]         # element = r
    for bad in (blob[:-1], blob + b"\0" * 32, high):
        with pytest.raises(ValueError):
            tt.blob_to_kzg_commitment(bad, ts)
        with pytest.raises(ValueError):
            tt.compute_blob_kzg_proof(bad, c, ts)
        with pytest.raises(ValueError):
            tt.blob_to_kzg_commitment_batch([blob, bad], ts)
        with pytest.raises(ValueError):
            tt.compute_blob_kzg_proof_batch([bad], [c], ts)
    for z in ((gold.R).to_bytes(32, "big"), b"\1" * 31):
        with pytest.raises(ValueError):
            tt.compute_kzg_proof(blob, z, ts)
    with pytest.raises(ValueError):
        tt.compute_blob_kzg_proof_batch([blob], [], ts)
    with pytest.raises(ValueError):
        blob_to_limbs(high, N)
    assert tt.blob_to_kzg_commitment_batch([], ts) == []
    assert tt.compute_blob_kzg_proof_batch([], [], ts) == []
    assert tt.verify_blob_kzg_proof(blob[:-1], c, c, ts) is False
