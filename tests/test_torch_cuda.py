"""The port's CUDA kernels against their plain tensor versions, on a card.

Every test here needs an NVIDIA GPU and skips without one: the kernels
have no CPU mode.  The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: montmul, ec_add, the NTT and the fraction-tree numerator
exact; the scans affine-equal (the kernel adds in chunks and runs, in
another order than the plain `loop` scan)."""

import random

import pytest
import torch

from tpukzg_torch.field.mont import FP, FR, FP_PLAIN, FR_PLAIN
from tpukzg_torch.field.limb_major import FP_LM_PLAIN
from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.kernels import bucket, ec, fractree, montmul, ntt

from torch_cases import (ec_inputs, long_row_scan_inputs, ntt_inputs,
                         operands, scan_inputs, srs_points)

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
def test_ec_add_kernel_many_blocks_on_card(cuda):
    """1000 lanes (8 blocks of 128, the last ragged), bit-exact; the
    first five are inf + Q, P + inf, inf + inf, P + P and P + (-P)."""
    pool = tuple(torch.from_numpy(c).to(cuda) for c in srs_points())
    gen = torch.Generator(device="cuda").manual_seed(3)
    i1, i2 = (torch.randint(0, pool[0].shape[1], (1000,), generator=gen,
                            device=cuda) for _ in range(2))
    p = [c[:, i1].clone() for c in pool]
    q = [c[:, i2].clone() for c in pool]
    inf = G1_LM_PLAIN.inf((1,), cuda)
    for c in range(3):
        p[c][:, 0] = inf[c][:, 0]
        q[c][:, 1] = inf[c][:, 0]
        p[c][:, 2] = q[c][:, 2] = inf[c][:, 0]
        q[c][:, 3], q[c][:, 4] = p[c][:, 3], p[c][:, 4]
    q[1][:, 4] = FP_LM_PLAIN.neg(p[1][:, 4:5])[:, 0]
    got = ec.ec_add(p, q)
    want = ec.ec_add_plain(tuple(p), tuple(q), FP_LM_PLAIN)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, 4:5] for c in got)).all())


def _scan_agrees(tp, ts, runs=None):
    got = bucket._launch(tp, ts, runs)
    assert bool(G1_LM_PLAIN.eq(got, bucket.seg_scan_plain(tp, ts)).all())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("runs", [1, 2, 4, 8])
def test_bucket_kernel_chunk_edges_on_card(cuda, runs):
    """Rows of C - 1, C and C + 1 lanes (C = 128 runs, a block's chunk)
    and of 3 C + 5, segmented and as one segment, with the grid the
    launcher reports (one kernel for rows of one chunk, else three);
    with one lane a run,
    also one segment spanning every chunk of a 131-chunk row (the carry
    pass's two tiles of 128 chunks), 5 lanes of other keys at each end."""
    C = bucket.THREADS * runs
    for n in (C - 1, C, C + 1, 3 * C + 5):
        pts, seg = scan_inputs(2, n, n, nkeys=max(2, n // 40))
        tp = tuple(torch.from_numpy(c).to(cuda) for c in pts)
        _scan_agrees(tp, torch.from_numpy(seg).to(cuda), runs)
        nch = -(-n // C)          # the blocks the launcher reports
        assert bucket.last_grid == ({"scan_local": 2} if nch == 1 else {
            "scan_local": 2 * nch, "scan_carry": 2,
            "scan_fixup": 2 * (nch - 1)})
        _scan_agrees(tp, torch.zeros((2, n), dtype=torch.int32,
                                     device=cuda), runs)
    if runs == 1:
        n = 130 * 128 + 7
        pts, _ = scan_inputs(1, n, 11)
        seg = torch.ones((1, n), dtype=torch.int32, device=cuda)
        seg[:, :5], seg[:, -5:] = 0, 2
        _scan_agrees(tuple(torch.from_numpy(c).to(cuda) for c in pts), seg,
                     runs)


@pytest.mark.cuda
def test_bucket_kernel_fixed_base_row_on_card(cuda):
    """One row shaped like a fixed-base MSM's: 98,304 lanes under 2,048
    sorted digit keys (0 included), with the launcher's choice of runs
    and with 4; two launches give the same limbs.  Then the suffix scan
    over 2,047 buckets (one segment)."""
    pts, seg = scan_inputs(1, 98304, 12, nkeys=2048)
    tp = tuple(torch.from_numpy(c).to(cuda) for c in pts)
    ts = torch.from_numpy(seg).to(cuda)
    want = bucket.seg_scan_plain(tp, ts)
    for runs in (None, 4):
        got = bucket._launch(tp, ts, runs)
        assert bool(G1_LM_PLAIN.eq(got, want).all())
        again = bucket._launch(tp, ts, runs)
        assert all(torch.equal(a, b) for a, b in zip(got, again))
    sub = tuple(c[:, :, :2047].contiguous() for c in tp)
    assert bool(G1_LM_PLAIN.eq(bucket.suffix_scan(sub),
                               bucket.suffix_scan_plain(sub)).all())


@pytest.mark.cuda
def test_bucket_kernel_long_rows_on_card(cuda):
    """Rows of 6000 lanes: several chunks, segments carried across chunk
    edges."""
    pts, seg = long_row_scan_inputs(2, 6000, 9)
    tp = tuple(torch.from_numpy(c).to(cuda) for c in pts)
    ts = torch.from_numpy(seg).to(cuda)
    assert bool(G1_LM_PLAIN.eq(bucket.seg_scan(tp, ts),
                               bucket.seg_scan_plain(tp, ts)).all())
