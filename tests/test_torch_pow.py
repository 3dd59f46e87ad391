"""The port's pow chains (FieldParams.pow_bits, pow_int and inv on the
trailing layout; FieldLM.inv and pow_bits on a moved view of the
limb-major layout) against the JAX package's pow_bits (one lax.fori_loop
that squares one and selects), on the CPU.  On a CPU tensor a chain runs
its products one by one through the plain product; on a card it is one
launch of the chain kernel, held against this plain loop by
tests/test_torch_cuda.py.  Tolerance: exact (canonical limbs)."""

import functools
import random

import numpy as np
import pytest
import torch

from tpukzg.field import mont as jmont
from tpukzg_torch.field import mont as tmont
from tpukzg_torch.field.limb_major import FieldLM
from tpukzg_torch.kernels import montmul

torch.set_num_threads(1)

P, R = tmont.P_MOD, tmont.R_MOD
# (name, exponent): the square root's, the Fermat inversions', and small
EXPS = {"fp": [("sqrt", (P + 1) // 4), ("inv", P - 2), ("1", 1), ("2", 2),
               ("3", 3)],
        "fr": [("inv", R - 2), ("1", 1), ("2", 2), ("3", 3)]}
FIELDS = {"fp": (tmont.FP, jmont.FP), "fr": (tmont.FR, jmont.FR)}
LANES = (1, 3, 16)
CASES = [(f, name, e) for f in ("fp", "fr") for name, e in EXPS[f]]


@functools.lru_cache(maxsize=None)
def _inputs(field):
    """20 Montgomery elements: a group of 1, 3 and 16 lanes (one per
    lane count), zero in the groups of 3 and 16, 1 and p - 1 in the
    group of 16."""
    T, _ = FIELDS[field]
    rng = random.Random(7 if field == "fp" else 8)
    vals = [rng.randrange(T.modulus) for _ in range(20)]
    vals[1] = vals[5] = 0
    vals[6], vals[7] = 1, T.modulus - 1
    return np.stack([T.to_mont_host(v) for v in vals])


def _group(lanes):
    start = {1: 0, 3: 1, 16: 4}[lanes]
    return slice(start, start + lanes)


@functools.lru_cache(maxsize=None)
def _jax_pow(field, e):
    """The JAX package's pow_bits on all 20 elements, once per exponent."""
    _, J = FIELDS[field]
    return np.asarray(J.pow_bits(_inputs(field).astype(np.uint32),
                                 J._bits(e))).astype(np.int32)


@pytest.mark.parametrize("layout", ["trailing", "limb_major"])
@pytest.mark.parametrize("lanes", LANES)
@pytest.mark.parametrize("field,name,e", CASES,
                         ids=[f"{f}-{n}" for f, n, _ in CASES])
def test_pow_chain_vs_jax(field, name, e, lanes, layout):
    T, _ = FIELDS[field]
    a = torch.from_numpy(_inputs(field)[_group(lanes)].copy())
    if layout == "trailing":
        if name == "inv":
            got = T.inv(a)
        elif name == "sqrt":
            got = T.pow_bits(a, T._bits(e))
        else:
            got = T.pow_int(a, e)
    else:
        lm = a.T.contiguous()                                # (L, lanes)
        if name == "inv":
            got = FieldLM(T).inv(lm).T
        else:
            got = T.pow_bits(lm.movedim(0, -1), T._bits(e))
    ref = _jax_pow(field, e)[_group(lanes)]
    assert np.array_equal(got.numpy(), ref)


@pytest.mark.parametrize("field", ["fp", "fr"])
def test_pow_bits_table_forms(field):
    """A bit table with leading zeros is the same exponent (the JAX loop
    squares through them); e = 0 gives one, as the JAX pow_int."""
    T, J = FIELDS[field]
    a = torch.from_numpy(_inputs(field)[4:8].copy())
    padded = np.concatenate([T._bits(5), np.zeros(3, np.int32)])
    assert torch.equal(T.pow_bits(a, padded), T.pow_int(a, 5))
    one = np.asarray(J.pow_int(_inputs(field)[4:8].astype(np.uint32), 0))
    assert np.array_equal(T.pow_int(a, 0).numpy(), one.astype(np.int32))


def test_chain_order_and_layouts():
    """The chain's products in the kernel's order (MSB first, the top bit
    taken as acc = a), and the element rows the kernel reads in place:
    a trailing tensor and a moved limb-major one without a copy."""
    assert montmul.exp_bits(1) == [] and montmul.exp_bits(6) == [1, 0]
    F = tmont.FR
    x = torch.from_numpy(_inputs("fr")[4:20].copy())             # (16, 16)
    v = montmul._element_rows(x, 16)
    assert v.data_ptr() == x.data_ptr() and v.stride() == (16, 1)
    lm = x.T.contiguous()
    v = montmul._element_rows(lm.movedim(0, -1), 16)
    assert v.data_ptr() == lm.data_ptr() and v.stride() == (1, 16)
    batched = lm.reshape(16, 4, 4).movedim(0, -1)                # (4, 4, 16)
    v = montmul._element_rows(batched, 16)
    assert v.data_ptr() == lm.data_ptr() and v.stride() == (1, 16)
    odd = torch.from_numpy(_inputs("fr")).T[:, ::2].movedim(0, -1)
    assert montmul._element_rows(odd, 16).is_contiguous()
    want = montmul.montmul_pow_plain(x, 11, F)
    assert torch.equal(montmul.montmul_pow(x, 11, F), want)
    assert torch.equal(F.pow_int(batched, 11),
                       want.T.reshape(16, 4, 4).movedim(0, -1))
    with pytest.raises(ValueError):
        montmul.montmul_pow(x, 0, F)
    with pytest.raises(ValueError):
        montmul.montmul_pow(x.to("meta"), 3, F)
