"""The shadows of the CUDA Montgomery products (``utils/checked.py``):
``shadow_montmul_lm`` replays ``mont_mul<F>`` of csrc/field.cuh,
``shadow_fp_mul_rows`` runs the PTX rows of ``fp_mul`` in csrc/ec.cuh.
Both are held bit for bit against the JAX package's ``shadow_montmul_lm``
(its Pallas core's replay), ``montmul_golden`` and the port's plain
product, their bounds are asserted, and a width made narrower must make
them raise."""

import random
import re

import numpy as np
import pytest
import torch

from tpukzg.field.mont import FP as JFP, FR as JFR
from tpukzg.utils import checked as jchecked
from tpukzg_torch.field.mont import FP, FR
from tpukzg_torch.kernels.montmul import montmul_plain
from tpukzg_torch.utils import checked

FIELDS = {"fp": (FP, JFP), "fr": (FR, JFR)}


def _lanes(field, seed, n_random=48):
    """(L, N) limbs of a and b: every pair of 0, 1, p - 1 and R mod p,
    each of them against random elements, and random pairs."""
    rng = random.Random(seed)
    m = field.modulus
    stress = [0, 1, m - 1, field.R % m]
    r = [rng.randrange(m) for _ in range(8 + 2 * n_random)]
    a = [s for s in stress for _ in stress] + stress + r[:4] + r[8::2]
    b = stress * len(stress) + r[4:8] + stress + r[9::2]
    return tuple(np.stack([field.from_int(v) for v in x]).T.copy()
                 for x in (a, b))


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_shadows_match_jax_shadow_golden_and_plain(name):
    field, jfield = FIELDS[name]
    a, b = _lanes(field, 0x5EED + len(name))
    got, bounds = checked.shadow_montmul_lm(a, b, field)
    jgot, jbounds = jchecked.shadow_montmul_lm(a.astype(np.uint32),
                                               b.astype(np.uint32), jfield)
    golden = np.stack([jchecked.montmul_golden(a[:, i], b[:, i], jfield)
                       for i in range(a.shape[1])], 1)
    plain = field.mul(torch.from_numpy(a.T.copy()),
                      torch.from_numpy(b.T.copy())).numpy().T
    assert got.dtype == np.uint32 and got.shape == a.shape
    assert np.array_equal(got, jgot)
    assert np.array_equal(got, golden)
    assert np.array_equal(got.astype(np.int64), plain.astype(np.int64))
    assert bounds["s"] < 1 << 64 and bounds["c"] < 1 << 32
    assert bounds["t_top"] <= 1 and bounds["carry_in"] <= 1
    assert bounds["top_sum"] < 1 << 32
    assert jbounds["column_sum"] < 1 << 32
    if name == "fp":
        rows, rb = checked.shadow_fp_mul_rows(a, b)
        assert np.array_equal(rows, got)
        dropped = {k: v for k, v in rb.items() if k.startswith("dropped@")}
        cleared = {k: v for k, v in rb.items() if k.startswith("cleared@")}
        assert len(dropped) == 4 and len(cleared) == 1
        assert max(dropped.values()) < 1 << 32
        assert set(cleared.values()) == {0}
        assert rb["cc_sum"] < 1 << 33 and rb["carry_in"] <= 1


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_montmul_shadow_on_all_ones_limbs(name):
    """R - 1 in both operands (every limb 0xFFFF, as chip_smoke.py's B1
    check feeds the kernel): the same bits as the plain product, with
    the 64-bit accumulator and the carries at their fullest and
    t[N + 1] = 1."""
    field, _ = FIELDS[name]
    x = np.full((field.L, 3), 0xFFFF, np.int32)
    got, bounds = checked.shadow_montmul_lm(x, x, field)
    t = torch.from_numpy(x)
    want = montmul_plain(t, t, field, limb_dim=0).numpy()
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))
    assert bounds["s"] >> 63 and bounds["c"] == (1 << 32) - 1
    assert bounds["t_top"] == 1


@pytest.mark.parametrize("shadow, width, bits", [
    ("fp", "ACC_BITS", 63), ("fr", "WORD_BITS", 31),
    ("rows", "WORD_BITS", 31)])
def test_shadow_with_a_narrower_width_raises(monkeypatch, shadow, width,
                                             bits):
    """The audit bites: with a 63-bit accumulator or 31-bit words the
    same inputs overflow a site."""
    field = FR if shadow == "fr" else FP
    a, b = _lanes(field, 7, n_random=8)
    monkeypatch.setattr(checked, width, bits)
    with pytest.raises(AssertionError, match="does not fit"):
        if shadow == "rows":
            checked.shadow_fp_mul_rows(a, b)
        else:
            checked.shadow_montmul_lm(a, b, field)


def _source(name):
    with open(f"{checked._CSRC}/{name}") as fh:
        return fh.read()


@pytest.mark.parametrize("name", ["fp", "fr"])
def test_shadow_constants_are_the_sources(name):
    """p and INV = -p^-1 mod 2^32 of the shadows are field.cuh's, and the
    reduction rows of fp_mul multiply m by p's words in order."""
    field, _ = FIELDS[name]
    n = field.L // 2
    p, inv = checked._field_words(field.modulus, n)
    src = _source("field.cuh")
    tag = "Fp" if name == "fp" else "Fr"
    words = re.search(rf"k{tag}P\[{n}\] = \{{(.*?)\}};", src, re.S).group(1)
    assert [int(w, 16) for w in re.findall(r"0x[0-9a-f]+", words)] == p
    got_inv = re.search(rf"struct {tag}T \{{.*?INV = (0x[0-9a-f]+)u;",
                        src, re.S).group(1)
    assert int(got_inv, 16) == inv
    if name == "fp":
        blocks = checked._fp_mul_rows_source()
        assert len(blocks) == 2
        lo = [int(args[2], 16) for _, op, args in blocks[1][1]
              if op.startswith(("mad.lo", "madc.lo"))]
        hi = [int(args[2], 16) for _, op, args in blocks[1][1]
              if op.startswith(("mad.hi", "madc.hi"))]
        assert lo == p and hi == p
