"""The port's NTT plan (src/tpukzg_torch/ntt) and batched inversion
against the JAX package, on the CPU, where the NTT runs the plain version
of kernel B5.  Tolerance: exact (canonical Fr limbs, bit for bit).

The Pallas NTT's CPU twin (``NttPallas(plan, interpret=True)``) runs
under ``jax.disable_jit()``: op by op its forward NTT takes ~12 s at
n = 16, while its jitted XLA:CPU compile takes minutes."""

import functools
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


@functools.lru_cache(maxsize=None)
def _jax_pair(n):
    """A (2, n) input and the JAX plan's ntt and intt of it."""
    a = _mont(random.Random(n), (2, n))
    u = a.astype(np.uint32)
    return a, _jax_op(n, "ntt", u), _jax_op(n, "intt", u)


@pytest.mark.parametrize("n,splits,groups", [
    (16, (4,), (0,)), (16, (1, 1, 1, 1), (1, 1, 1, 1)),
    (16, (2, 2), (2, 1)),
    (64, (6,), (0,)), (64, (1,) * 6, (2, 0, 1, 0, 2, 1)),
    (64, (4, 2), (1, 2)), (64, (3, 3), (0, 3)),
    (256, (8,), (0,)), (256, (1,) * 8, (0,) * 8), (256, (4, 4), (2, 2)),
    (256, (3, 3, 2), (2, 1, 0)), (256, (2, 6), (3, 2))],
    ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else str(v))
def test_ntt_passes_vs_jax_plan(n, splits, groups):
    """B5's passes in tensor code (stage ranges on strided groups, G
    groups of consecutive low bits a block, the bit-reversal in the first
    pass's load, 1/n in the last) against the JAX plan, both ways: one
    pass, one stage a pass, and uneven splits."""
    a, want_f, want_i = _jax_pair(n)
    plan = get_plan(n)
    x = torch.from_numpy(a)
    for inverse, want in ((False, want_f), (True, want_i)):
        got = kntt.ntt_passes(x, plan, splits, inverse, groups)
        assert np.array_equal(got.numpy(), want.astype(np.int32))


def test_ntt_launcher_passes():
    """The launcher's passes: one up to n = 64, two of 6 stages at 4096
    (1,024 blocks at the prover's k = 16 on 132 SMs), two of 9 at 2^18,
    each within the kernel's limits (G m <= 4096; G within the groups
    side by side), G m >= 64 where the grid still covers the SMs, the
    split running through the tensor-code passes."""
    assert kntt.passes_for(16, 4096, 132) == [(0, 6, 0), (6, 12, 0)]
    assert kntt.passes_for(1, 1 << 18, 132) == [(0, 9, 0), (9, 18, 0)]
    assert kntt.passes_for(3, 64, 132) == [(0, 6, 0)]
    assert kntt.passes_for(256, 1 << 7, 132) == [(0, 4, 2), (4, 7, 3)]
    assert kntt.passes_for(1, 1 << 7, 132) == [(0, 4, 0), (4, 7, 0)]
    for log_n in range(1, 29):
        passes = kntt.passes_for(16, 1 << log_n, 132)
        assert passes[0][0] == 0 and passes[-1][1] == log_n
        assert len(passes) == (1 if log_n <= 6 else max(2, -(-log_n // 12)))
        for (s0, s1, lg), nxt in zip(passes, passes[1:] + [(log_n,)]):
            assert nxt[0] == s1 and s1 - s0 + lg <= 12
            assert lg <= (log_n - s1 if s0 == 0 else s0)
    plan = get_plan(256)
    x = torch.from_numpy(_mont(random.Random(1), (2, 256)))
    passes = kntt.passes_for(2, 256, 4)
    got = kntt.ntt_passes(x, plan, [s1 - s0 for s0, s1, _ in passes], True,
                          [lg for *_, lg in passes])
    assert torch.equal(got, kntt.ntt_plain(x, plan, True))


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
