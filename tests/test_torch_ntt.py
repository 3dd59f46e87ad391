"""The port's NTT plan (src/tpukzg_torch/ntt) and batched inversion
against the JAX package, on the CPU, where the NTT runs the plain version
of kernel B5.  Tolerance: exact (canonical Fr limbs, bit for bit).

The Pallas NTT's CPU twin (``NttPallas(plan, interpret=True)``) runs
under ``jax.disable_jit()``: op by op its forward NTT takes ~12 s at
n = 16, while its jitted XLA:CPU compile takes minutes."""

import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from tpukzg.field.mont import FR as JFR
from tpukzg.ntt.ntt import get_plan as jax_plan
from tpukzg_torch.field.mont import FR
from tpukzg_torch.kernels import ntt as kntt
from tpukzg_torch.ntt.ntt import get_plan

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _mont(rng, shape):
    k = int(np.prod(shape))
    vals = [rng.randrange(FR.modulus) for _ in range(k)]
    vals[:3] = [0, 1, FR.modulus - 1][:k]
    return FR.to_mont_host(vals).reshape(tuple(shape) + (16,))


def _jax_op(n, op, a):
    """The JAX plan's `op` on uint32 limbs.  The coset ops are composed
    from the plan's own jitted ntt/intt and its coset tables (the body of
    ``_coset_ntt``/``_coset_intt``): a separate jit of each coset op costs
    2-6 s more of XLA:CPU compile."""
    plan = jax_plan(n)
    if op in ("ntt", "intt"):
        return np.asarray(getattr(plan, op)(a))
    if op == "coset_ntt":
        return np.asarray(plan.ntt(JFR.mul(a, plan.coset_pow)))
    return np.asarray(JFR.mul(plan.intt(a), plan.coset_pow_inv))


@pytest.mark.parametrize("op", ["ntt", "intt", "coset_ntt", "coset_intt"])
@pytest.mark.parametrize("n", [16, 256])
def test_ntt_ops_vs_jax_plan(n, op):
    a = _mont(random.Random(n), (2, n))
    got = getattr(get_plan(n), op)(torch.from_numpy(a))
    want = _jax_op(n, op, a.astype(np.uint32))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_ntt_vs_pallas_twin():
    """Forward only: the twin's inverse is held equal to the JAX plan's
    intt by tests/test_pallas.py, and the port's intt to that above."""
    from tpukzg.pallas.ntt import NttPallas
    n = 16
    pn = NttPallas(jax_plan(n), interpret=True)
    a = _mont(random.Random(7), (2, n))
    with jax.disable_jit():
        want = np.asarray(pn.ntt(a.astype(np.uint32)))
    assert np.array_equal(get_plan(n).ntt(torch.from_numpy(a)).numpy(),
                          want.astype(np.int32))


def test_ntt_kat_and_round_trip():
    with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as f:
        kat = json.load(f)["ntt"]
    n = int(kat["n"])
    plan = get_plan(n)
    coeffs = torch.from_numpy(FR.to_mont_host([int(c, 16)
                                               for c in kat["coeffs"]]))
    evals = plan.ntt(coeffs)
    assert FR.to_int(FR.from_mont(evals)) == [int(v, 16)
                                               for v in kat["evals"]]
    assert torch.equal(plan.intt(evals), coeffs)
    assert torch.equal(plan.coset_intt(plan.coset_ntt(coeffs)), coeffs)
    # the wrapper takes the plain version for a CPU tensor
    assert torch.equal(kntt.ntt(coeffs, plan), kntt.ntt_plain(coeffs, plan))


def test_plan_tables_match_jax_plan():
    for n in (2, 16, 256):
        ours, ref = get_plan(n), jax_plan(n)
        assert np.array_equal(ours.roots, np.asarray(ref.roots))
        assert np.array_equal(ours.coset_pow, np.asarray(ref.coset_pow))
        assert np.array_equal(ours.coset_pow_inv,
                              np.asarray(ref.coset_pow_inv))
        for s in range(ours.log_n):
            for inv, tab in ((False, ref._tw_fwd), (True, ref._tw_inv)):
                assert np.array_equal(ours.stage_twiddles(s, inv),
                                      np.asarray(tab[s]).reshape(-1, 16))
        # the device tables are made once per device
        assert ours.on("cpu", "tw_fwd") is ours.on("cpu", "tw_fwd")


def test_batch_inv_vs_jax():
    rng = random.Random(3)
    a = _mont(rng, (2, 16))
    a[0, 5] = 0
    a[1, 0] = 0
    a[1, 15] = 0
    want = np.asarray(JFR.batch_inv(a.astype(np.uint32), axis=-2))
    got = FR.batch_inv(torch.from_numpy(a), axis=-2)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert bool((got[0, 5] == 0).all() and (got[1, 15] == 0).all())
    # the other axis, against the one-by-one inversion
    got0 = FR.batch_inv(torch.from_numpy(a[:, :8].copy()), axis=0)
    assert torch.equal(got0, FR.inv(torch.from_numpy(a[:, :8].copy())))
