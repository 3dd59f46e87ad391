"""The port's CUDA kernels against their plain tensor versions, on a card.

Every test here needs an NVIDIA GPU and skips without one: the kernels
have no CPU mode.  The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: montmul, ec_add, the NTT and the fraction-tree numerator
exact; the scans affine-equal (a row above 768 lanes is several tiles
joined by a carry, which adds in another order than the plain `loop`
scan)."""

import random

import pytest
import torch

from tpukzg_torch.field.mont import FP, FR, FP_PLAIN, FR_PLAIN
from tpukzg_torch.field.limb_major import FP_LM_PLAIN
from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.kernels import bucket, ec, fractree, montmul, ntt

from torch_cases import (ec_inputs, long_row_scan_inputs, ntt_inputs,
                         operands, scan_inputs)

# ---------------------------------------------------------------------------
# on the card: each kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [(FP, FP_PLAIN), (FR, FR_PLAIN)],
                         ids=["fp", "fr"])
def test_montmul_kernel_on_card(cuda, fields):
    T, TP = fields
    a, b = (torch.from_numpy(x).to(cuda) for x in operands(T, 12, 4096))
    got = montmul.montmul(a, b, T, limb_dim=0)
    assert torch.equal(got, montmul.montmul_plain(a, b, TP, limb_dim=0))


@pytest.mark.cuda
def test_ec_add_kernel_on_card(cuda):
    p, q = ec_inputs()
    tp = tuple(torch.from_numpy(c).to(cuda) for c in p)
    tq = tuple(torch.from_numpy(c).to(cuda) for c in q)
    got = ec.ec_add(tp, tq)
    want = ec.ec_add_plain(tp, tq, FP_LM_PLAIN)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [33, 513, 1000])
def test_bucket_kernel_on_card(cuda, n):
    pts, seg = scan_inputs(3, n, n)
    tp = tuple(torch.from_numpy(c).to(cuda) for c in pts)
    ts = torch.from_numpy(seg).to(cuda)
    assert bool(G1_LM_PLAIN.eq(bucket.seg_scan(tp, ts),
                               bucket.seg_scan_plain(tp, ts)).all())
    assert bool(G1_LM_PLAIN.eq(bucket.suffix_scan(tp),
                               bucket.suffix_scan_plain(tp)).all())


@pytest.mark.cuda
def test_fractree_kernel_on_card(cuda):
    from tpukzg_torch.ntt.ntt import get_plan
    from tpukzg_torch.poly.poly import _fraction_merge
    n, k = 2048, 3
    rng = random.Random(6)
    plan = get_plan(n)
    evals = torch.from_numpy(FR.to_mont_host(
        [rng.randrange(FR.modulus) for _ in range(k * n)]).reshape(k, n, 16))
    z = torch.from_numpy(FR.to_mont_host([rng.randrange(FR.modulus),
                                          plan.roots_int[7], 3]))
    roots = torch.from_numpy(plan.roots)
    ev, zz, rr = evals.to(cuda), z.to(cuda), roots.to(cuda)
    got = _fraction_merge(*fractree.fractree_partials(ev, zz, rr), FR_PLAIN)
    want = _fraction_merge(*fractree.fractree_partials_plain(ev, zz, rr),
                           FR_PLAIN)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 4096, 1 << 14])
def test_ntt_kernel_on_card(cuda, n):
    """One block per polynomial up to n = 4096; 2^14 adds two passes."""
    from tpukzg_torch.ntt.ntt import get_plan
    plan = get_plan(n)
    x = torch.from_numpy(ntt_inputs(3 if n <= 4096 else 1, n, n)).to(cuda)
    for inverse in (False, True):
        assert torch.equal(ntt.ntt(x, plan, inverse),
                           ntt.ntt_plain(x, plan, inverse))
    assert torch.equal(ntt.ntt(ntt.ntt(x, plan), plan, True), x)


@pytest.mark.cuda
def test_bucket_kernel_long_rows_on_card(cuda):
    """Rows of 6000 lanes: 8 tiles, segments carried across tile edges."""
    pts, seg = long_row_scan_inputs(2, 6000, 9)
    tp = tuple(torch.from_numpy(c).to(cuda) for c in pts)
    ts = torch.from_numpy(seg).to(cuda)
    assert bool(G1_LM_PLAIN.eq(bucket.seg_scan(tp, ts),
                               bucket.seg_scan_plain(tp, ts)).all())
