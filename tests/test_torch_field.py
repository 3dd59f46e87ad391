"""The port's field arithmetic (src/tpukzg_torch/field) against the JAX
package's, on the CPU.  Tolerance: exact — every op returns canonical
limbs, so the int32 limbs must equal the JAX uint32 limbs bit for bit."""

import random

import numpy as np
import pytest
import torch

from tpukzg.field import mont as jmont
from tpukzg.field.limb_major import FieldLM as JFieldLM
from tpukzg.field.tower import FP12 as JFP12
from tpukzg_torch.field import mont as tmont
from tpukzg_torch.field.limb_major import FieldLM
from tpukzg_torch.field.tower import FP12

FIELDS = [(tmont.FP, jmont.FP), (tmont.FR, jmont.FR)]
IDS = ["fp", "fr"]

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


def _vals(F, rng, n):
    edge = [0, 1, F.modulus - 1, F.modulus - 2, (F.modulus - 1) // 2,
            (F.modulus + 1) // 2]
    return edge + [rng.randrange(F.modulus) for _ in range(n - len(edge))]


def _pair(F, seed, n=24):
    rng = random.Random(seed)
    a = np.stack([F.from_int(x) for x in _vals(F, rng, n)])
    b = np.stack([F.from_int(x) for x in reversed(_vals(F, rng, n))])
    return a, b


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
@pytest.mark.parametrize("fields", FIELDS, ids=IDS)
def test_binary_ops_exact(fields, op):
    T, J = fields
    a, b = _pair(T, 1)
    got = getattr(T, op)(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = np.asarray(getattr(J, op)(a.astype(np.uint32), b.astype(np.uint32)))
    assert np.array_equal(got, ref.astype(np.int32))


@pytest.mark.parametrize("op", ["neg", "double", "sqr", "to_mont",
                                "from_mont", "inv"])
@pytest.mark.parametrize("fields", FIELDS, ids=IDS)
def test_unary_ops_exact(fields, op):
    T, J = fields
    a, _ = _pair(T, 2, n=12)
    got = getattr(T, op)(torch.from_numpy(a)).numpy()
    ref = np.asarray(getattr(J, op)(a.astype(np.uint32)))
    assert np.array_equal(got, ref.astype(np.int32))


@pytest.mark.parametrize("fields", FIELDS, ids=IDS)
def test_predicates_and_pow(fields):
    T, J = fields
    a, b = _pair(T, 3, n=10)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja = a.astype(np.uint32)
    assert np.array_equal(T.gt_half(ta).numpy(), np.asarray(J.gt_half(ja)))
    assert np.array_equal(T.eq(ta, tb).numpy(), (a == b).all(-1))
    assert T.is_zero(ta).numpy()[0]
    e = 0xD201000000010000
    got = T.pow_int(ta, e).numpy()
    ref = np.asarray(J.pow_int(ja, e))
    assert np.array_equal(got, ref.astype(np.int32))
    assert np.array_equal(T.sum_along(ta, 0).numpy(),
                          np.asarray(J.sum_along(ja, 0)).astype(np.int32))
    assert np.array_equal(T.mul_small(ta, 12).numpy(),
                          np.asarray(J.mul_small(ja, k=12)).astype(np.int32))


@pytest.mark.parametrize("fields", FIELDS, ids=IDS)
def test_mul_stress_limbs(fields):
    """All-0xFFFF operands (a = R - 1, above p) — the carry-stress input of
    utils/checked.py — against montmul_golden and the JAX product."""
    from tpukzg.utils import checked
    T, J = fields
    a, _ = _pair(T, 4, n=8)
    ff = np.full((8, T.L), 0xFFFF, np.int32)
    got = T.mul(torch.from_numpy(ff), torch.from_numpy(a)).numpy()
    ref = np.asarray(J.mul(ff.astype(np.uint32), a.astype(np.uint32)))
    assert np.array_equal(got, ref.astype(np.int32))
    b_val = (T.R - 1) % T.modulus
    red = T.from_int(b_val)
    for i in range(3):
        want = checked.montmul_golden(a[i].astype(np.uint32), red, J)
        g = T.mul(torch.from_numpy(red), torch.from_numpy(a[i])).numpy()
        assert g.tolist() == want.tolist()


@pytest.mark.parametrize("fields", FIELDS, ids=IDS)
def test_limb_major_ops_exact(fields):
    T, J = fields
    tl, jl = FieldLM(T), JFieldLM(J, carry_impl="scan")
    a, b = _pair(T, 5, n=8)
    at, bt = torch.from_numpy(a.T.copy()), torch.from_numpy(b.T.copy())
    aj, bj = a.T.astype(np.uint32), b.T.astype(np.uint32)
    for op in ("add", "sub", "mul"):
        got = getattr(tl, op)(at, bt).numpy()
        ref = np.asarray(getattr(jl, op)(aj, bj))
        assert np.array_equal(got, ref.astype(np.int32)), op
    for op in ("neg", "double"):
        assert np.array_equal(getattr(tl, op)(at).numpy(),
                              np.asarray(getattr(jl, op)(aj)).astype(np.int32))
    assert np.array_equal(tl.mul_small(at, 12).numpy(),
                          np.asarray(jl.mul_small(aj, 12)).astype(np.int32))


def _fp12_vals(seed, n=2):
    rng = random.Random(seed)
    v = [rng.randrange(tmont.P_MOD) for _ in range(n * 12)]
    return tmont.FP.to_mont_host(v).reshape(n, 2, 3, 2, 24)


@pytest.mark.parametrize("op", ["mul", "sqr", "inv", "conj", "frob1",
                                "frob2", "frob3"])
def test_fp12_tower_exact(op):
    a, b = _fp12_vals(6), _fp12_vals(7)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = a.astype(np.uint32), b.astype(np.uint32)
    if op == "mul":
        got, ref = FP12.mul(ta, tb), JFP12.mul(ja, jb)
    elif op.startswith("frob"):
        n = int(op[-1])
        got, ref = FP12.frobenius(ta, n), JFP12.frobenius(ja, n)
    else:
        got, ref = getattr(FP12, op)(ta), getattr(JFP12, op)(ja)
    assert np.array_equal(got.numpy(), np.asarray(ref).astype(np.int32))


def test_fp12_cyclotomic_sqr_exact():
    """On a cyclotomic element (after the easy part), against the JAX
    Granger-Scott squaring and the generic square."""
    a = torch.from_numpy(_fp12_vals(8, n=1))
    u = FP12.mul(FP12.conj(a), FP12.inv(a))
    g = FP12.mul(FP12.frobenius(u, 2), u)
    got = FP12.cyclotomic_sqr(g)
    ref = np.asarray(JFP12.cyclotomic_sqr(g.numpy().astype(np.uint32)))
    assert np.array_equal(got.numpy(), ref.astype(np.int32))
    assert torch.equal(got, FP12.sqr(g))
    assert bool(FP12.eq(FP12.mul(g, FP12.conj(g)),
                        FP12.one((1,), "cpu")).all())
