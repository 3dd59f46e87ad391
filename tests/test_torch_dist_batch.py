"""The port's sharded batch verify (``tpukzg_torch.dist.
ShardedBatchVerifier``) on the CPU: world size 2 in one gloo process
group (``dist.launch.run``), n = 16, k = 4, against the golden model's
aggregates (equal in affine form) and the single-device
``Kzg.verify_batch``'s verdicts (equal)."""

import random

import golden.model as gold

import torch_dist_cases as cases
from tpukzg_torch.dist import launch
from tpukzg_torch.kzg.core import Kzg
from tpukzg_torch.kzg.setup import Setup


def g1_affine(pts):
    return [gold.g1_affine(p) for p in pts]


def _openings(n, k, seed):
    """k golden openings at random z on the n-point dev SRS -> (C, pi)
    as golden points, then (C, z, y, pi, rho powers) as affine and
    canonical ints."""
    gs = gold.GoldenSetup(0xDEADBEEF, n)
    rng = random.Random(seed)
    cs, zs, ys, pis = [], [], [], []
    for _ in range(k):
        blob = gold.blob_from_bytes(b"".join(
            rng.randrange(gold.R).to_bytes(32, "big") for _ in range(n)))
        cs.append(gold.blob_to_kzg_commitment(gs, blob))
        z = rng.randrange(gold.R)
        pi, y = gold.compute_kzg_proof(gs, blob, z)
        zs.append(z), ys.append(y), pis.append(pi)
    rho = rng.randrange(gold.R)
    rhos = [pow(rho, i, gold.R) for i in range(k)]
    return (cs, pis), (g1_affine(cs), zs, ys, g1_affine(pis), rhos)


def _aggregates(cs, zs, ys, pis, rhos):
    """golden (sum rho^i pi_i, sum rho^i (C_i - [y_i] G1 + [z_i] pi_i))."""
    pi_agg = lhs = gold.G1_INF
    for c, z, y, p, r in zip(cs, zs, ys, pis, rhos):
        pi_agg = gold.g1_add(pi_agg, gold.g1_mul(p, r))
        term = gold.g1_add(gold.g1_add(c, gold.g1_neg(gold.g1_mul(
            gold.G1_GEN, y))), gold.g1_mul(p, z))
        lhs = gold.g1_add(lhs, gold.g1_mul(term, r))
    return gold.g1_affine(pi_agg), gold.g1_affine(lhs)


def test_sharded_batch_verifier(tmp_path):
    """World 2, n = 16, k = 4: the two aggregates equal golden's in affine
    form; the verdicts of a valid batch and of one with a wrong y equal
    the single-device Kzg.verify_batch's (True, False)."""
    n, k = 16, 4
    (cs_g, pis_g), valid = _openings(n, k, 0xBA7C)
    cs, zs, ys, pis, rhos = valid
    bad_ys = [ys[0], (ys[1] + 1) % gold.R] + ys[2:]
    tampered = (cs, zs, bad_ys, pis, rhos)
    out = launch.run(cases.on_one_thread, 2, "gloo",
                     init_file=str(tmp_path / "rendezvous"),
                     args=(cases.batch_verify_case, n, valid,
                           [valid, tampered]), timeout=120)
    assert out[0] == out[1]
    pi_ints, lhs_ints, verdicts = out[0]
    want_pi, want_lhs = _aggregates(cs_g, zs, ys, pis_g, rhos)
    assert pi_ints == want_pi + (False,)
    assert lhs_ints == want_lhs + (False,)
    setup = Setup.generate_insecure(0xDEADBEEF, n, device="cpu")
    kzg = Kzg(setup)
    single = [bool(kzg.verify_batch(*cases.batch_tensors(*b, "cpu")).item())
              for b in (valid, tampered)]
    assert single == [True, False]
    assert verdicts == single
