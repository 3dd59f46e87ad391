"""The port's CUDA kernels against their plain tensor versions, on a card.

Every test here needs an NVIDIA GPU and skips without one: the kernels
have no CPU mode.  The file imports neither JAX nor the JAX package, so
it also runs where only the port is installed:

    PYTHONPATH=src python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances: montmul (against its plain version and against the CIOS
shadow of utils/checked.py) and its chain launch, ec_add, ec_double (both
kernels), the NTT and the fraction-tree numerator exact; the scans affine-equal (the kernel adds in chunks and runs, in
another order than the plain `loop` scan); the windowed ladder, the
batch MSM and the sharded MSM affine-equal; the distributed NTT
exact."""

import numpy as np
import pytest
import torch

from tpukzg_torch.field.mont import FP, FR, FP_PLAIN, FR_PLAIN
from tpukzg_torch.field.limb_major import FP_LM_PLAIN
from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.kernels import bucket, ec, fractree, montmul, ntt
from tpukzg_torch.utils import checked

from torch_cases import (SRS16, ec_inputs, long_row_scan_inputs,
                         ntt_inputs, operands, scan_inputs, srs_points)

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
@pytest.mark.parametrize("field", [FP, FR], ids=["fp", "fr"])
def test_montmul_kernel_against_cios_shadow_on_card(cuda, field):
    """B1 against the replay of mont_mul<F> (utils/checked.py) on 256
    lanes with R - 1, p - 1, 0, 1 and R mod p in both operands: bit for
    bit, and every site of the shadow within its width."""
    a, b = operands(field, 13, 256)
    stress = [a[:, 0].copy(), a[:, 1].copy(), a[:, 2].copy(),
              field.from_int(1), field.from_int(field.R)]
    for i, s in enumerate(stress):
        a[:, i], b[:, i], b[:, 5 + i] = s, stress[-1 - i], s
    got = montmul.montmul(torch.from_numpy(a).to(cuda),
                          torch.from_numpy(b).to(cuda), field, limb_dim=0)
    want, bounds = checked.shadow_montmul_lm(a, b, field)
    assert np.array_equal(got.cpu().numpy().astype(np.int64),
                          want.astype(np.int64))
    assert bounds["s"] < 1 << 64 and bounds["c"] < 1 << 32
    assert bounds["t_top"] <= 1 and bounds["top_sum"] < 1 << 32


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


def _card_fr(cuda, shape, seed):
    """Canonical Fr limbs (below 2^254 < r) made on the card."""
    gen = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randint(0, 1 << 16, tuple(shape) + (16,), generator=gen,
                      device=cuda, dtype=torch.int32)
    x[..., 15] &= 0x3FFF
    return x


def _y(pair, n_inv):
    from tpukzg_torch.poly.poly import _fraction_merge
    return FR_PLAIN.mul(_fraction_merge(*pair, FR_PLAIN), n_inv)


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1, 4096), (3, 4096), (16, 4096),
                                 (256, 4096), (3, 256), (3, 2048)])
def test_fractree_kernel_on_card(cuda, k, n):
    """y bit-exact against the plain leaves, with z in-domain at the first
    element of a chunk and, in a second run, at the last; at k = 16 the
    launcher's grid holds at least one block an SM."""
    from tpukzg_torch.ntt.ntt import get_plan
    plan = get_plan(n)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    parts = fractree.parts_for(k, n, sms)
    chunk = n // parts
    c = min(1, parts - 1)
    evals = _card_fr(cuda, (k, n), k + n)
    roots = torch.from_numpy(plan.roots).to(cuda)
    n_inv = torch.from_numpy(plan.n_inv).to(cuda)
    for m in (c * chunk, c * chunk + chunk - 1):
        z = _card_fr(cuda, (k,), m)
        z[0] = roots[m]
        got = _y(fractree.fractree_partials(evals, z, roots), n_inv)
        assert fractree.last_grid == {"parts": parts,
                                      "threads": fractree.threads_for(chunk),
                                      "blocks": k * parts, "fold_blocks": k}
        assert torch.equal(got, _y(fractree.fractree_partials_plain(
            evals, z, roots), n_inv))
        assert torch.equal(got[0], evals[0, m])
    if k == 16:
        assert fractree.last_grid["blocks"] >= sms


@pytest.mark.cuda
@pytest.mark.parametrize("parts,threads", [(1, 32), (2, 64), (8, 256),
                                           (4, 128), (64, 32)])
def test_fractree_kernel_grids_on_card(cuda, parts, threads):
    """Other grids than the launcher's, n = 256, k = 3: runs of several
    elements a thread, (8 x 256) chunks of 32 elements on 256 threads,
    where 224 threads hold the identity, and (64 x 32) two parts a lane
    of the fold; the pairs equal the tensor-code mirror's, and y the
    plain version's."""
    from tpukzg_torch.ntt.ntt import get_plan
    n, k = 256, 3
    plan = get_plan(n)
    evals = _card_fr(cuda, (k, n), 11)
    z = _card_fr(cuda, (k,), 12)
    roots = torch.from_numpy(plan.roots).to(cuda)
    z[1] = roots[n - 1]
    n_inv = torch.from_numpy(plan.n_inv).to(cuda)
    pair = fractree._launch(evals, z, roots, parts, threads)
    assert fractree.last_grid["blocks"] == k * parts
    assert fractree.last_grid["fold_blocks"] == k
    assert pair[0].shape == (k, 1, 16)
    want = fractree.fractree_partials_strided(evals, z, roots, parts,
                                              threads)
    assert all(torch.equal(g, w) for g, w in zip(pair, want))
    assert torch.equal(_y(pair, n_inv), _y(fractree.fractree_partials_plain(
        evals, z, roots), n_inv))


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [3, 6, 0])
def test_fractree_parts_must_be_power_of_two_on_card(cuda, parts):
    """The chunks must divide n, a power of two, so the launcher refuses
    any other count of parts."""
    n = 768 if parts == 3 else 256
    evals, roots = _card_fr(cuda, (2, n), 1), _card_fr(cuda, (n,), 2)
    with pytest.raises(ValueError, match="power of two"):
        fractree._launch(evals, _card_fr(cuda, (2,), 3), roots, parts, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("n", [2, 16, 64, 4096, 1 << 14, 1 << 18])
def test_ntt_kernel_on_card(cuda, n, k):
    """Both directions bit-exact against the plain stage loop, and
    intt(ntt(x)) == x: one pass up to n = 64, two of 6 stages at 4096,
    of 7 at 2^14, of 9 at 2^18 (the plain version one polynomial at a
    time there)."""
    from tpukzg_torch.ntt.ntt import get_plan
    plan = get_plan(n)
    if k * n <= 1 << 14:
        x = torch.from_numpy(ntt_inputs(k, n, n)).to(cuda)
    else:
        x = _card_fr(cuda, (k, n), n + k)
    for inverse in (False, True):
        got = ntt.ntt(x, plan, inverse)
        assert len(ntt.last_grid) == len(ntt.split_stages(plan.log_n))
        step = 1 if n >= 1 << 18 else k
        for i in range(0, k, step):
            assert torch.equal(got[i:i + step],
                               ntt.ntt_plain(x[i:i + step], plan, inverse))
    assert torch.equal(ntt.ntt(ntt.ntt(x, plan), plan, True), x)


@pytest.mark.cuda
def test_ntt_kernel_fills_the_card_on_card(cuda):
    """At the prover's (16, 4096) the first pass runs at least one block
    an SM; at 2^18 the transform takes at most 3 passes."""
    from tpukzg_torch.ntt.ntt import get_plan
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    ntt.ntt(_card_fr(cuda, (16, 4096), 1), get_plan(4096))
    assert [p["stages"] for p in ntt.last_grid] == [[0, 6], [6, 12]]
    assert ntt.last_grid[0]["blocks"] >= sms
    ntt.ntt(_card_fr(cuda, (1, 1 << 18), 2), get_plan(1 << 18), True)
    assert len(ntt.last_grid) <= 3


@pytest.mark.cuda
@pytest.mark.parametrize("passes", [
    [(0, 12, 0)], [(0, 4, 3), (4, 8, 2), (8, 12, 0)],
    [(0, 6, 0), (6, 12, 3)], [(0, 1, 0)] + [(s, s + 1, 1)
                                            for s in range(1, 12)]],
    ids=["one", "three", "g1g8", "stagewise"])
def test_ntt_kernel_other_passes_on_card(cuda, passes):
    """Splits and groups the launcher does not choose, n = 4096, k = 3."""
    from tpukzg_torch.ntt.ntt import get_plan
    plan = get_plan(4096)
    x = _card_fr(cuda, (3, 4096), 5)
    for inverse in (False, True):
        got = ntt._launch(x, plan, inverse, passes)
        assert [p["blocks"] for p in ntt.last_grid] == [
            3 * 4096 >> (s1 - s0 + lg) for s0, s1, lg in passes]
        assert torch.equal(got, ntt.ntt_plain(x, plan, inverse))


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


# ---------------------------------------------------------------------------
# the setup path and the public MSM on the card, against the same code's
# plain run (or its CPU run, where the code has no plain twin)
# ---------------------------------------------------------------------------


def _srs16(device):
    from tpukzg_torch.kzg.setup import Setup
    return Setup.load(SRS16, device=device)


@pytest.mark.cuda
def test_g1_ladder_on_card(cuda):
    """A 32-lane G1 ladder (scalars 0, 1, r - 1, 2^255 + 1 and seeded
    ones): each step's add is one ec_add launch, and the limbs equal the
    plain ladder's (plain products and plain adds) on the card."""
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.kernels import _build
    pool = tuple(torch.from_numpy(c).to(cuda) for c in srs_points())
    gen = torch.Generator(device="cuda").manual_seed(5)
    k = torch.randint(0, 1 << 16, (32, 16), generator=gen, device=cuda,
                      dtype=torch.int32)
    k[..., 15] &= 0x3FFF
    k[:4] = torch.as_tensor(FR.from_int([0, 1, FR.modulus - 1,
                                         (1 << 255) + 1]), device=cuda)
    before = _build.launches["ec_add"]
    got = G1_LM.scalar_mul_ladder(pool, k)
    assert _build.launches["ec_add"] - before == 256
    want = G1_LM_PLAIN.scalar_mul_ladder(pool, k)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_g2_ladder_and_lines_on_card(cuda):
    """The G2 ladder and the Miller lines on the card (Fp products by the
    montmul kernel) give the CPU's limbs; the lines of the committed G2
    points equal the file's."""
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.pairing.lines import precompute_lines
    cpu, card = _srs16("cpu"), _srs16(cuda)
    k = torch.as_tensor(FR.from_int([0xDEADBEEF, FR.modulus - 1]))
    want = G2.scalar_mul(cpu.g2_gen, k)
    got = G2.scalar_mul_ladder(card.g2_gen, k.to(cuda))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got, want))
    both = tuple(torch.stack([a, b]) for a, b in zip(card.g2_gen,
                                                     card.g2_tau))
    d, a = precompute_lines(both)
    for got_l, want_l in zip((d[0], a[0], d[1], a[1]),
                             card.lines_gen + card.lines_tau):
        assert torch.equal(got_l, want_l)


@pytest.mark.cuda
def test_from_compressed_on_card(cuda):
    """n = 16: the committed SRS compressed and loaded back on the card
    equals the file in affine form; a point outside G1 is refused."""
    from tpukzg_torch.curve import g1 as g1m, g2 as g2m
    from tpukzg_torch.kzg.setup import Setup
    ref = _srs16(cuda)
    mono = g1m.compress_points(ref.monomial_g1)
    lag = g1m.compress_points(ref.lagrange_g1)
    tau_b = g2m.compress_point(ref.g2_tau)
    s = Setup.from_compressed(mono, lag, tau_b, device=cuda)
    assert s.device.type == cuda.type
    assert g1m.compress_points(s.monomial_g1) == mono
    assert g1m.compress_points(s.lagrange_g1) == lag
    assert g2m.compress_point(s.g2_tau) == tau_b
    for a, b in zip(s.lines_gen + s.lines_tau, ref.lines_gen + ref.lines_tau):
        assert torch.equal(a, b)
    x = 4
    while True:          # on the curve, outside G1: y^2 = x^3 + 4 has roots
        rhs = (x ** 3 + 4) % FP.modulus
        y = pow(rhs, (FP.modulus + 1) // 4, FP.modulus)
        if y * y % FP.modulus == rhs:
            bad = g1m.compress(x, y, False)
            _, ok = g1m.decompress_batch([bad], cuda)
            if not bool(ok.item()):
                break
        x += 1
    with pytest.raises(ValueError):
        Setup.from_compressed(mono, lag[:-1] + [bad], tau_b, device=cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [8, 16, 1 << 17])
def test_msm_chunks_on_card(cuda, chunk):
    """The public MSM over 30 SRS points with seeded scalars (one zero) at
    a few point chunks, 8 and 16 leaving a pad, equals the same MSM on
    the CPU in affine form."""
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.msm.pippenger_lm import msm
    pool = tuple(torch.from_numpy(c[:, :30].T.copy()) for c in srs_points())
    gen = torch.Generator().manual_seed(7)
    k = torch.randint(0, 1 << 16, (30, 16), generator=gen, dtype=torch.int32)
    k[..., 15] &= 0x3FFF
    k[3] = 0
    want = msm(pool, k, point_chunk=chunk)
    got = msm(tuple(c.to(cuda) for c in pool), k.to(cuda), point_chunk=chunk)
    assert g1m.compress_points(tuple(c.cpu()[None] for c in got)) == \
        g1m.compress_points(tuple(c[None] for c in want))


@pytest.mark.cuda
def test_verify_kzg_proof_on_card(cuda):
    """The single verify on the card at n = 16: the KAT opening True, a
    wrong y False."""
    import json
    import os
    import tpukzg_torch as tt
    from torch_cases import REPO
    with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as fh:
        kat = json.load(fh)
    ts = tt.generate_insecure_setup(0xDEADBEEF, 16, device=cuda)
    c = bytes.fromhex(kat["kzg"]["commitment"])
    o = kat["kzg_open"]
    z, y = (int(o[k], 16) for k in ("z", "y"))
    pf = bytes.fromhex(o["proof"])
    assert tt.verify_kzg_proof(c, z.to_bytes(32, "big"), y.to_bytes(32, "big"),
                               pf, ts) is True
    assert tt.verify_kzg_proof(c, z.to_bytes(32, "big"),
                               (y + 1).to_bytes(32, "big"), pf, ts) is False


@pytest.mark.cuda
@pytest.mark.parametrize("times", [1, 3, 11, 32])
def test_ec_double_kernel_on_card(cuda, times):
    """B6: a run of `times` doublings in one launch equals the plain
    version bit for bit, infinity in lanes 0 and 7."""
    from tpukzg_torch.kernels import _build
    pts = [torch.from_numpy(c.copy()).to(cuda) for c in srs_points()]
    inf = G1_LM_PLAIN.inf((1,), cuda)
    for c in range(3):
        pts[c][:, 0] = pts[c][:, 7] = inf[c][:, 0]
    before = _build.launches["ec_double"]
    got = ec.ec_double(tuple(pts), times)
    assert _build.launches["ec_double"] - before == 1
    want = ec.ec_double_plain(tuple(pts), FP_LM_PLAIN, times)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, [0, 7]] for c in got)).all())


@pytest.mark.cuda
def test_ec_double_kernel_many_blocks_on_card(cuda):
    """1000 lanes (8 blocks of 128, the last ragged) with a broadcast
    batch axis, t = 2, against the plain version."""
    pool = tuple(torch.from_numpy(c).to(cuda) for c in srs_points())
    gen = torch.Generator(device="cuda").manual_seed(4)
    idx = torch.randint(0, pool[0].shape[1], (2, 500), generator=gen,
                        device=cuda)
    p = tuple(c[:, idx] for c in pool)
    got = ec.ec_double(p, 2)
    assert got[0].shape == (24, 2, 500)
    want = ec.ec_double_plain(p, FP_LM_PLAIN, 2)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _card_triples(ts, k, seed):
    import random
    import tpukzg_torch as tt
    rng = random.Random(seed)
    blobs = [b"".join(rng.randrange(FR.modulus).to_bytes(32, "big")
                      for _ in range(ts.n)) for _ in range(k)]
    cs = tt.blob_to_kzg_commitment_batch(blobs, ts)
    return blobs, cs, tt.compute_blob_kzg_proof_batch(blobs, cs, ts)


@pytest.mark.cuda
def test_pipeline_schedule_on_card(cuda):
    """n = 16: bench.py's pipelined schedule over every kind of batch
    gives the synchronous path's verdicts, which are the expected ones
    (the CPU tests hold them against the golden model)."""
    import tpukzg_torch as tt
    from torch_cases import BATCH_CASES, batch_case
    ts = tt.generate_insecure_setup(0xDEADBEEF, 16, device=cuda)
    triples = _card_triples(ts, 3, 8)
    batches = [batch_case(c, triples, 16) for c in BATCH_CASES]
    pend = [tt.verify_blob_kzg_proof_batch_pipeline(*batches[0], ts)]
    got = []
    for i in range(len(batches)):
        if i + 1 < len(batches):
            pend.append(tt.verify_blob_kzg_proof_batch_pipeline(
                *batches[i + 1], ts))
        pend[i].stage2()
        if i > 0:
            got.append(pend[i - 1].result())
    got.append(pend[-1].result())
    sync = [tt.verify_blob_kzg_proof_batch(*b, ts) for b in batches]
    assert got == sync == [c in ("valid", "empty") for c in BATCH_CASES]
    assert tt.verify_blob_kzg_proof_batch_chunked(*triples, ts, chunk=2)


@pytest.mark.cuda
def test_pipeline_stages_do_not_sync_on_card(cuda, monkeypatch):
    """Stage 1 and stage 2 of a batch run under sync debug mode "error",
    apart from the y readback (the one sync the JAX package has too)."""
    import tpukzg_torch as tt
    from tpukzg_torch.kzg import blob
    ts = tt.generate_insecure_setup(0xDEADBEEF, 16, device=cuda)
    triples = _card_triples(ts, 3, 9)
    assert tt.verify_blob_kzg_proof_batch(*triples, ts)    # warm caches
    real = blob._y_to_host

    def exempt(y):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(y)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    monkeypatch.setattr(blob, "_y_to_host", exempt)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pend = tt.verify_blob_kzg_proof_batch_pipeline(*triples, ts)
        pend.stage2()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert pend.result() is True


def _double_lanes(cuda, lanes, seed):
    """`lanes` SRS points (drawn with repeats) with infinity in lane 0
    and, from 5 lanes on, in the last lane."""
    pool = tuple(torch.from_numpy(c).to(cuda) for c in srs_points())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    idx = torch.randint(0, pool[0].shape[1], (lanes,), generator=gen,
                        device=cuda)
    p = [c[:, idx].contiguous() for c in pool]
    inf = G1_LM_PLAIN.inf((1,), cuda)
    for c in range(3):
        p[c][:, 0] = inf[c][:, 0]
        if lanes >= 5:
            p[c][:, -1] = inf[c][:, 0]
    return tuple(p)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 2, 3, 5, 512, 1 << 16])
@pytest.mark.parametrize("times", [1, 8, 32])
def test_ec_double_both_kernels_on_card(cuda, times, lanes):
    """B6 by one thread a point and by four (the quad kernel), each one
    launch, against the plain version bit for bit: ragged last quads
    (1, 3, 5 lanes), the Horner fold's 2 lanes, the subgroup check's 512
    and 2^16."""
    from tpukzg_torch.kernels import _build
    p = _double_lanes(cuda, lanes, times + lanes)
    want = ec.ec_double_plain(p, FP_LM_PLAIN, times)
    for group in (1, 4):
        before = _build.launches["ec_double"]
        got = ec.ec_double(p, times, group)
        assert _build.launches["ec_double"] - before == 1
        assert all(torch.equal(a, b) for a, b in zip(got, want)), group
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, :1] for c in want)).all())


@pytest.mark.cuda
def test_ec_kernels_on_every_device_on_card(cuda):
    """B2 and both B6 kernels on each visible card, several launches
    each: every call launches once (the counts stay right) and agrees
    with the plain version, on the first device and the others alike (no
    launch depends on a per-device attribute set elsewhere)."""
    from tpukzg_torch.kernels import _build
    p0, q0 = ec_inputs()
    for d in range(torch.cuda.device_count()):
        dev = torch.device("cuda", d)
        with torch.cuda.device(dev):
            p = tuple(torch.from_numpy(c).to(dev) for c in p0)
            q = tuple(torch.from_numpy(c).to(dev) for c in q0)
            want_add = ec.ec_add_plain(p, q, FP_LM_PLAIN)
            want_dbl = ec.ec_double_plain(p, FP_LM_PLAIN, 3)
            before = dict(_build.launches)
            for _ in range(3):
                assert all(torch.equal(a, b) for a, b in zip(
                    ec.ec_add(p, q), want_add))
                for group in (1, 4):
                    assert all(torch.equal(a, b) for a, b in zip(
                        ec.ec_double(p, 3, group), want_dbl))
            assert _build.launches["ec_add"] - before.get("ec_add", 0) == 3
            assert _build.launches["ec_double"] - \
                before.get("ec_double", 0) == 6


def _card_elems(F, cuda, lanes, seed):
    """(lanes, L) canonical Montgomery elements made on the card, zero in
    lane 0 and 1 in lane 1 where there is room."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randint(0, 1 << 16, (lanes, F.L), generator=gen, device=cuda,
                      dtype=torch.int32)
    x[:, -1] &= 0x0FFF                       # below 2^(16 L - 4) < p, r
    x[0] = 0
    if lanes > 1:
        x[1] = torch.from_numpy(F.one_mont).to(cuda)
    return x


POW_CASES = [(FP, FP_PLAIN, "sqrt", (FP.modulus + 1) // 4),
             (FP, FP_PLAIN, "inv", FP.modulus - 2),
             (FR, FR_PLAIN, "inv", FR.modulus - 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["trailing", "limb_major"])
@pytest.mark.parametrize("lanes", [1, 16, 512, 8192])
@pytest.mark.parametrize("case", POW_CASES,
                         ids=["fp-sqrt", "fp-inv", "fr-inv"])
def test_montmul_pow_kernel_on_card(cuda, case, lanes, layout):
    """The chain launch against the plain chain (the same products one
    by one) bit for bit: the square root's and the Fermat inversions'
    exponents, on (lanes, L) and on a moved view of (L, lanes), which the
    kernel reads in place."""
    from tpukzg_torch.kernels import _build
    F, FP_, _, e = case
    x = _card_elems(F, cuda, lanes, lanes + e % 97)
    if layout == "limb_major":
        x = x.T.contiguous().movedim(0, -1)
    want = montmul.montmul_pow_plain(x, e, FP_)
    key = "montmul_pow_" + F.name.lower()
    before = _build.launches[key]
    got = montmul.montmul_pow(x, e, F)
    assert _build.launches[key] - before == 1
    assert got.stride() == x.stride()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [(FP, FP_PLAIN), (FR, FR_PLAIN)],
                         ids=["fp", "fr"])
def test_pow_bits_is_one_launch_on_card(cuda, fields):
    """FieldParams.pow_bits, inv and pow_int on a CUDA tensor: one launch
    of the chain kernel and no other; the limb-major inverse too."""
    from tpukzg_torch.field.limb_major import FieldLM
    from tpukzg_torch.kernels import _build
    F, FP_ = fields
    x = _card_elems(F, cuda, 64, 3)
    for fn, ref in ((lambda: F.inv(x), lambda: FP_.inv(x)),
                    (lambda: F.pow_int(x, 5), lambda: FP_.pow_int(x, 5)),
                    (lambda: FieldLM(F).inv(x.T.contiguous()).T,
                     lambda: FP_.inv(x))):
        want = ref()
        before = dict(_build.launches)
        got = fn()
        after = dict(_build.launches)
        diff = {k: v - before.get(k, 0) for k, v in after.items()
                if v != before.get(k, 0)}
        assert diff == {"montmul_pow_" + F.name.lower(): 1}
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_no_spill_in_b1_b6_on_card(cuda):
    """ptxas reports no spill for any kernel of montmul.cu (the product
    and the chain kernel) or ec.cu (B2 and both B6 kernels)."""
    import re
    from tpukzg_torch.kernels import _build
    _build.lib()
    log, src, seen = _build.build_info["log"], None, {}
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and src in ("montmul.cu", "ec.cu"):
            seen.setdefault(src, []).append(int(m[1]) + int(m[2]))
    assert len(seen.get("montmul.cu", [])) >= 4      # 2 kernels x 2 fields
    assert len(seen.get("ec.cu", [])) >= 3
    assert all(v == 0 for vs in seen.values() for v in vs), seen


# ---------------------------------------------------------------------------
# the windowed ladder, the batch MSM and the multi-GPU paths on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_windowed_ladder_on_card(cuda):
    """`scalar_mul` on the card is the windowed ladder: for 32 lanes 64
    runs of 4 doublings (one ec_double launch each) and 14 + 64 ec_add
    launches, equal in affine form to the plain 256-step ladder; G2's
    windowed ladder equals the CPU ladder in affine form."""
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.kernels import _build
    pool = tuple(torch.from_numpy(c).to(cuda) for c in srs_points())
    gen = torch.Generator(device="cuda").manual_seed(6)
    k = torch.randint(0, 1 << 16, (32, 16), generator=gen, device=cuda,
                      dtype=torch.int32)
    k[..., 15] &= 0x3FFF
    k[:4] = torch.as_tensor(FR.from_int([0, 1, FR.modulus - 1,
                                         (1 << 255) + 1]), device=cuda)
    before = dict(_build.launches)
    got = G1_LM.scalar_mul(pool, k)
    assert _build.launches["ec_double"] - before.get("ec_double", 0) == 64
    assert _build.launches["ec_add"] - before.get("ec_add", 0) == 14 + 64
    want = G1_LM_PLAIN.scalar_mul_ladder(pool, k)
    assert bool(G1_LM_PLAIN.eq(got, want).all())
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, 0] for c in got)))
    cpu, card = _srs16("cpu"), _srs16(cuda)
    k2 = torch.as_tensor(FR.from_int([0xDEADBEEF, FR.modulus - 1, 0]))
    want2 = G2.normalize(G2.scalar_mul(cpu.g2_gen, k2))
    got2 = G2.normalize(G2.scalar_mul(card.g2_gen, k2.to(cuda)))
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got2, want2))


@pytest.mark.cuda
def test_msm_batch_on_card(cuda):
    """msm_batch over the 32 SRS points, k = 5 seeded rows, through the
    bucket-scan kernel: equal in affine form to one msm a row on the
    card and to the same batch on the CPU."""
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.kernels import _build
    from tpukzg_torch.msm.pippenger_lm import msm, msm_batch
    pool = tuple(torch.from_numpy(c.T.copy()) for c in srs_points())
    gen = torch.Generator().manual_seed(8)
    k = torch.randint(0, 1 << 16, (5, 32, 16), generator=gen,
                      dtype=torch.int32)
    k[..., 15] &= 0x3FFF
    k[2] = 0
    before = _build.launches["bucket_scan"]
    got = msm_batch(tuple(c.to(cuda) for c in pool), k.to(cuda))
    assert _build.launches["bucket_scan"] > before
    want = msm_batch(pool, k)
    rows = [msm(tuple(c.to(cuda) for c in pool), k[i].to(cuda))
            for i in range(5)]
    got_b = g1m.compress_points(tuple(c.cpu() for c in got))
    assert got_b == g1m.compress_points(want)
    assert got_b == [g1m.compress_points(tuple(c.cpu()[None] for c in r))[0]
                     for r in rows]


@pytest.mark.cuda
def test_dist_world_one_nccl_on_card(cuda, tmp_path):
    """One rank on NCCL (the card of rank 0): ShardedMsm over the 32 SRS
    points equals the single-device msm in affine form; DistNtt at n =
    2^10 (n1 = 16) equals NttPlan bit for bit, forward and back."""
    import random
    import torch_dist_cases as cases
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.dist import launch
    from tpukzg_torch.msm.pippenger_lm import msm
    from tpukzg_torch.ntt.ntt import get_plan
    pool = tuple(torch.from_numpy(c.T.copy()) for c in srs_points())
    aff = [g1m.point_to_ints(tuple(c[i] for c in pool))[:2]
           for i in range(32)]
    rng = random.Random(9)
    ks = [rng.randrange(FR.modulus) for _ in range(32)]
    want = g1m.point_to_ints(tuple(c.cpu() for c in msm(
        tuple(c.to(cuda) for c in pool),
        torch.as_tensor(FR.from_int(ks), device=cuda))))
    (got,) = launch.run(cases.sharded_msm_case, 1, "nccl",
                        init_file=str(tmp_path / "msm"),
                        args=("G1", aff, ks, None, None))
    assert got == want
    n = 1 << 10
    coeffs = [rng.randrange(FR.modulus) for _ in range(n)]
    ((n1, n2, fwd, back),) = launch.run(
        cases.dist_ntt_case, 1, "nccl", init_file=str(tmp_path / "ntt"),
        args=(n, 16, coeffs, None))
    assert (n1, n2) == (16, 64)
    vec = torch.as_tensor(FR.to_mont_host(coeffs))
    assert torch.equal(torch.tensor(fwd, dtype=torch.int32),
                       get_plan(n).ntt(vec.to(cuda)).cpu())
    assert torch.equal(torch.tensor(back, dtype=torch.int32), vec)
