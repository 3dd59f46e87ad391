"""Each kernel's plain tensor version (src/tpukzg_torch/kernels) against
the JAX function as the JAX tests run it on the CPU.  Tolerance: exact
(the plain scans are the reference's `loop` scans).  The kernels
themselves are held against these plain versions on a card by
tests/test_torch_cuda.py."""

import functools
import random

import numpy as np
import pytest
import torch

from tpukzg.field.mont import FP as JFP, FR as JFR
from tpukzg.pallas.montmul import montmul_lm
from tpukzg_torch.field.mont import FP, FR, FP_PLAIN, FR_PLAIN
from tpukzg_torch.field.limb_major import FP_LM_PLAIN
from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.kernels import bucket, ec, montmul

from torch_cases import (chunk_scan_inputs, ec_inputs, g2_points, operands,
                         scan_inputs, srs_points, window_inputs)

# Tiny tensors: one intra-op thread keeps parallel test workers from
# oversubscribing the cores.
torch.set_num_threads(1)


@pytest.mark.parametrize("fields", [(FP, FP_PLAIN, JFP), (FR, FR_PLAIN, JFR)],
                         ids=["fp", "fr"])
def test_montmul_plain_vs_montmul_lm(fields):
    T, TP, J = fields
    a, b = operands(T, 11, 32)
    ref = np.asarray(montmul_lm(a.astype(np.uint32), b.astype(np.uint32), J))
    got = montmul.montmul_plain(torch.from_numpy(a), torch.from_numpy(b), TP,
                                limb_dim=0)
    assert np.array_equal(got.numpy(), ref.astype(np.int32))
    # the dispatching wrapper takes the plain version for CPU tensors
    got2 = montmul.montmul(torch.from_numpy(a.T.copy()),
                           torch.from_numpy(b.T.copy()), T)
    assert np.array_equal(got2.numpy().T, ref.astype(np.int32))


def test_ec_add_plain_vs_pallas_ec():
    import jax.numpy as jnp
    from tpukzg.pallas.ec import ec_add as jec_add
    p, q = ec_inputs()
    mu = jnp.asarray(np.asarray(JFP.mu_limbs, np.uint32)[:, None])
    pm = jnp.asarray(np.asarray(JFP.mod_limbs, np.uint32)[:, None])
    # eager jnp, as the kernel body runs in interpret mode (a jit of the
    # whole formula costs a minute and a half of XLA:CPU compile)
    ref = jec_add(tuple(jnp.asarray(c.astype(np.uint32)) for c in p),
                  tuple(jnp.asarray(c.astype(np.uint32)) for c in q),
                  mu, pm, 24)
    tp = tuple(torch.from_numpy(c) for c in p)
    tq = tuple(torch.from_numpy(c) for c in q)
    got = ec.ec_add_plain(tp, tq, FP_LM_PLAIN)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, 1:2] for c in got)).all())
    assert all(torch.equal(a, b) for a, b in zip(ec.ec_add(tp, tq), got))


def _double_inputs():
    """32 SRS points with infinity in lanes 0 and 7."""
    pts = [c.copy() for c in srs_points()]
    inf = (np.zeros(24, np.int32), FP.one_mont, np.zeros(24, np.int32))
    for c in range(3):
        pts[c][:, 0] = pts[c][:, 7] = inf[c]
    return tuple(pts)


def test_ec_double_plain_vs_pallas_ec():
    import jax.numpy as jnp
    from tpukzg.pallas.ec import ec_double as jec_double
    p = _double_inputs()
    mu = jnp.asarray(np.asarray(JFP.mu_limbs, np.uint32)[:, None])
    pm = jnp.asarray(np.asarray(JFP.mod_limbs, np.uint32)[:, None])
    # eager jnp, as the kernel body runs in interpret mode
    ref = jec_double(tuple(jnp.asarray(c.astype(np.uint32)) for c in p),
                     mu, pm, 24)
    tp = tuple(torch.from_numpy(c) for c in p)
    got = ec.ec_double_plain(tp, FP_LM_PLAIN)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))
    assert bool(G1_LM_PLAIN.is_inf(tuple(c[:, [0, 7]] for c in got)).all())
    assert not bool(G1_LM_PLAIN.is_inf(tuple(c[:, 1:7] for c in got)).any())
    # the dispatching wrapper takes the plain version for CPU tensors
    assert all(torch.equal(a, b) for a, b in zip(ec.ec_double(tp), got))


def test_ec_double_run_equals_single_doubles():
    """A run of t doublings (one launch on the card) equals t single
    doubles, and the curve's double_n and the ladder's double agree."""
    tp = tuple(torch.from_numpy(c[:, :8]) for c in _double_inputs())
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    one = tp
    for t in range(1, 6):
        one = ec.ec_double_plain(one, FP_LM_PLAIN)
        for got in (ec.ec_double_plain(tp, FP_LM_PLAIN, t),
                    ec.ec_double(tp, t), G1_LM.double_n(tp, t),
                    G1_LM_PLAIN.double_n(tp, t)):
            assert all(torch.equal(a, b) for a, b in zip(got, one))
    assert all(torch.equal(a, b) for a, b in zip(ec.ec_double(tp, 0), tp))
    assert all(torch.equal(a, b) for a, b in zip(G1_LM.double(tp),
                                                 ec.ec_double(tp)))
    # [2^t] P is the double-and-add of 2^t
    k = torch.from_numpy(FR.from_int([1 << 5] * 8))
    ladder = G1_LM_PLAIN.scalar_mul(tp, k)
    assert bool(G1_LM_PLAIN.eq(ladder, one).all())


@functools.lru_cache(maxsize=None)
def _jax_double_steps():
    """Lanes of 1, 3 and 5 SRS points (infinity in the second lane of the
    group of 3) and their first 32 doublings by the plain version, the
    32 stacked as lanes; and the JAX ec_double of those 32 x 9 lanes,
    one eager call (as the kernel body runs in interpret mode)."""
    import jax.numpy as jnp
    from tpukzg.pallas.ec import ec_double as jec_double
    pts = [c[:, 8:17].copy() for c in _double_inputs()]
    inf = (np.zeros(24, np.int32), FP.one_mont, np.zeros(24, np.int32))
    for c in range(3):
        pts[c][:, 2] = inf[c]
    steps = [tuple(torch.from_numpy(c) for c in pts)]
    for _ in range(32):
        steps.append(ec.ec_double_plain(steps[-1], FP_LM_PLAIN))
    inputs = [np.concatenate([s[c].numpy() for s in steps[:32]], 1)
              for c in range(3)]
    mu = jnp.asarray(np.asarray(JFP.mu_limbs, np.uint32)[:, None])
    pm = jnp.asarray(np.asarray(JFP.mod_limbs, np.uint32)[:, None])
    ref = jec_double(tuple(jnp.asarray(c.astype(np.uint32)) for c in inputs),
                     mu, pm, 24)
    return steps, [np.asarray(r).astype(np.int32) for r in ref]


@pytest.mark.parametrize("lanes", [1, 3, 5])
@pytest.mark.parametrize("times", [1, 8, 32])
def test_ec_double_runs_vs_pallas_ec(times, lanes):
    """B6's layered plain version (two batched products of four, as the
    quad kernel splits them) on runs of t = 1, 8 and 32 over 1, 3 and 5
    lanes: each of the first 32 doublings equals the JAX ec_double of the
    same input bit for bit, so a run of t equals t JAX doublings; the run
    in one call equals the steps, and the CPU wrapper takes it."""
    steps, ref = _jax_double_steps()
    for k in range(32):
        for c in range(3):
            assert np.array_equal(steps[k + 1][c].numpy(),
                                  ref[c][:, 9 * k:9 * k + 9])
    sl = {1: slice(0, 1), 3: slice(1, 4), 5: slice(4, 9)}[lanes]
    p = tuple(c[:, sl] for c in steps[0])
    got = ec.ec_double_plain(p, FP_LM_PLAIN, times)
    assert all(torch.equal(g, s[:, sl]) for g, s in zip(got, steps[times]))
    assert all(torch.equal(g, w) for g, w in zip(ec.ec_double(p, times), got))


def test_ec_double_group_by_lanes():
    """The launcher's choice of threads a point: four up to
    QUAD_MAX_LANES lanes, one above."""
    m = ec.QUAD_MAX_LANES
    assert [ec.double_group(n) for n in (1, 2, 512, 4096, m, m + 1)] == \
        [4, 4, 4, 4, 4, 1]
    with pytest.raises(ValueError):
        ec.ec_double(tuple(torch.zeros((24, 2), dtype=torch.int32)
                           for _ in range(3)), 1, 2)


def test_ec_double_refuses_other_devices():
    a = torch.zeros((24, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        ec.ec_double((a, a, a), 2)
    with pytest.raises(ValueError):
        ec.ec_double(tuple(torch.zeros((24, 4), dtype=torch.int32)
                           for _ in range(3)), -1)


def test_seg_scan_plain_vs_loop_scan():
    from tpukzg.curve.weierstrass_lm import G1_LM as JG1
    from tpukzg.msm.scan import seg_scan as jseg
    pts, seg = scan_inputs(2, 16, 1)
    ref = jseg(JG1.add, JG1.select, tuple(c.astype(np.uint32) for c in pts),
               seg, coord_axis=2, seg_axis=1, impl="loop")
    got = bucket.seg_scan_plain(tuple(torch.from_numpy(c) for c in pts),
                                torch.from_numpy(seg))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))


def test_suffix_scan_plain_vs_loop_scan():
    from tpukzg.curve.weierstrass_lm import G1_LM as JG1
    from tpukzg.msm.scan import suffix_scan as jsuf
    pts, _ = scan_inputs(2, 15, 3)
    ref = jsuf(JG1.add, JG1.select, tuple(c.astype(np.uint32) for c in pts),
               coord_axis=2, batch_shape=(2, 15), scan_axis_in_batch=1,
               impl="loop")
    got = bucket.suffix_scan_plain(tuple(torch.from_numpy(c) for c in pts))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))


@pytest.fixture(scope="module")
def chunk_case():
    """Keys and points of chunk_scan_inputs, with the JAX loop scans of
    them (segmented, and suffix) as references."""
    from tpukzg.curve.weierstrass_lm import G1_LM as JG1
    from tpukzg.msm.scan import seg_scan as jseg, suffix_scan as jsuf
    pts, seg = chunk_scan_inputs(7)
    ju = tuple(c.astype(np.uint32) for c in pts)
    ref_seg = jseg(JG1.add, JG1.select, ju, seg, coord_axis=2, seg_axis=1,
                   impl="loop")
    ref_suf = jsuf(JG1.add, JG1.select, ju, coord_axis=2,
                   batch_shape=seg.shape, scan_axis_in_batch=1, impl="loop")
    as_t = lambda r: tuple(torch.from_numpy(np.asarray(c).astype(np.int32))
                           for c in r)
    return (tuple(torch.from_numpy(c) for c in pts), torch.from_numpy(seg),
            as_t(ref_seg), as_t(ref_suf))


@pytest.mark.parametrize("sizes", [(3,), (4,), (8,), (16, 4)],
                         ids=["c3", "c4", "c8", "c16r4"])
def test_seg_scan_chunked_vs_loop_scan(chunk_case, sizes):
    """The kernel's three passes in tensor code (chunks of 3, 4 and 8
    lanes; and chunks of 16 scanned as runs of 4, as a block scans its
    threads' runs) against the JAX loop scans: affine-equal in every
    lane, the suffix scan through the same code with one key."""
    tp, ts, ref_seg, ref_suf = chunk_case
    got = bucket.seg_scan_chunked(tp, ts, sizes)
    assert bool(G1_LM_PLAIN.eq(got, ref_seg).all())
    assert bool(G1_LM_PLAIN.eq(got, bucket.seg_scan_plain(tp, ts)).all())
    rev = tuple(torch.flip(c, dims=[2]) for c in tp)
    got = bucket.seg_scan_chunked(rev, torch.zeros_like(ts), sizes)
    got = tuple(torch.flip(c, dims=[2]) for c in got)
    assert bool(G1_LM_PLAIN.eq(got, ref_suf).all())


@pytest.mark.parametrize("g,nb,s,threads,curve", [
    (2, 255, 1, 128, "g1"), (2, 255, 4, 8, "g1"), (1, 2047, 2, 128, "g1"),
    (1, 2047, 32, 8, "g1"), (1, 37, 64, 128, "g1"), (2, 63, 4, 4, "g2"),
    (1, 37, 64, 128, "g2")], ids=["verify-s1", "ragged-s4", "fixed-s2",
                                  "fixed-s32-t8", "one-segment",
                                  "g2-ragged-s4-t4", "g2-one-segment"])
def test_window_sum_chunked_vs_plain(g, nb, s, threads, curve):
    """The window-sum kernels' decomposition in tensor code against the
    plain route (suffix scan, then the tree sum), affine-equal: rows of
    the batch verify's 255 buckets and the fixed-base MSM's 2047 at a
    row or two; s = 1, s not dividing B - 1, a segment longer than the
    row; blocks of 128 segments and of 8 (so the join meets several
    blocks); empty buckets, a row all infinity and the doubling case
    (window_inputs).  G2 buckets (48 limbs, the pool of
    torch_cases.g2_points) in two of the cases.  The CPU wrapper takes
    the plain route."""
    pool = g2_points() if curve == "g2" else None
    b = tuple(torch.from_numpy(c)
              for c in window_inputs(g, nb, nb + s, pool=pool))
    want = bucket.window_sum_plain(b)
    got = bucket.window_sum_chunked(b, s, threads)
    L = 24 if curve == "g1" else 48
    assert got[0].shape == (L, g)
    assert bool(bucket.plain_curve(b).eq(got, want).all())
    assert all(torch.equal(a, w) for a, w in zip(bucket.window_sum(b), want))
    if g == 2:
        assert bool(bucket.plain_curve(b).is_inf(
            tuple(c[:, 1:] for c in got)).all())


def test_window_segment_for():
    """The launcher's buckets a thread on a 132-SM card: the MSM's two
    rows of 65,535 (4: at 2 a row would need 256 join threads), the
    verify fold's 64 x 255 and the fixed-base 3 x 2047 (1: too few
    blocks for two an SM), msm_batch's 75 x 2047 (4); always a power of
    two leaving at most THREADS blocks a row."""
    shapes = [(2, 65535), (64, 255), (3, 2047), (75, 2047), (512, 65535),
              (1, 1), (1, 1 << 20)]
    got = [bucket.window_segment_for(g, nb, 132) for g, nb in shapes]
    assert got[:5] == [4, 1, 1, 4, 16]
    for (g, nb), s in zip(shapes, got):
        assert s & (s - 1) == 0
        assert -(-nb // (s * bucket.THREADS)) <= bucket.THREADS
    with pytest.raises(ValueError):
        bucket.window_sum_chunked(tuple(torch.zeros((24, 1, 40), dtype=torch.int32)
                                        for _ in range(3)), 3)


@pytest.mark.slow
def test_scans_plain_vs_pallas_scan_tiled():
    """Against the Pallas bucket scan's CPU path (interpret=True) with
    128-lane tiles, so a 200-lane row is two tiles joined by the carry:
    affine-equal, since the carry adds in another order than the loop
    scan.  `slow`: jitted, XLA:CPU compiles the tile body for over ten
    minutes, so the JAX side runs op by op (about two minutes)."""
    import jax
    from tpukzg.pallas.bucket import seg_scan_pallas, suffix_scan_pallas
    pts, seg = scan_inputs(1, 200, 4, nkeys=3)
    with jax.disable_jit():
        ref_seg = seg_scan_pallas(tuple(c.astype(np.uint32) for c in pts),
                                  seg, interpret=True, tile=128)
        ref_suf = suffix_scan_pallas(tuple(c.astype(np.uint32) for c in pts),
                                     interpret=True, tile=128)
    tp = tuple(torch.from_numpy(c) for c in pts)
    for got, ref in ((bucket.seg_scan(tp, torch.from_numpy(seg)), ref_seg),
                     (bucket.suffix_scan_plain(tp), ref_suf)):
        ref_t = tuple(torch.from_numpy(np.asarray(c).astype(np.int32))
                      for c in ref)
        assert bool(G1_LM_PLAIN.eq(got, ref_t).all())


@pytest.fixture(scope="module")
def fractree_case():
    """n=512, k=3 with an in-domain row (z = w^5): the inputs and the JAX
    fraction tree's y (interpret mode, then its _fraction_merge)."""
    import jax.numpy as jnp
    from tpukzg.ntt.ntt import get_plan as jplan
    from tpukzg.pallas import fractree as jft
    from tpukzg.poly.poly import _fraction_merge as jmerge
    from tpukzg_torch.ntt.ntt import get_plan
    n, k = 512, 3
    rng = random.Random(5)
    jp, plan = jplan(n), get_plan(n)
    evals = FR.to_mont_host([rng.randrange(FR.modulus)
                             for _ in range(k * n)]).reshape(k, n, 16)
    zs = [rng.randrange(FR.modulus), plan.roots_int[5], rng.randrange(FR.modulus)]
    z = FR.to_mont_host(zs)
    a, b = jft.fractree_partials(evals.astype(np.uint32), z.astype(np.uint32),
                                 jp.roots, tile=256, interpret=True)
    ref = np.asarray(JFR.mul(jmerge(jnp.asarray(a), jnp.asarray(b)),
                             jnp.asarray(jp.n_inv)))
    return plan, evals, z, ref


def test_fractree_plain_vs_pallas_fractree(fractree_case):
    """n=512, k=3 with an in-domain row: y exact against the JAX fraction
    tree (interpret mode) followed by its _fraction_merge."""
    from tpukzg_torch.poly.poly import barycentric_eval
    plan, evals, z, ref = fractree_case
    got = barycentric_eval(plan, torch.from_numpy(evals), torch.from_numpy(z))
    assert np.array_equal(got.numpy(), ref.astype(np.int32))
    assert np.array_equal(got.numpy()[1], evals[1, 5])


@pytest.mark.parametrize("parts,threads", [(1, 64), (2, 32), (8, 32),
                                           (8, 256), (64, 32)])
def test_fractree_strided_vs_pallas_fractree(fractree_case, parts, threads):
    """B4's order in tensor code (thread t folds elements t, t + T, ... of
    each of `parts` chunks, warps halve by shuffles, then the warps'
    fractions; the fold kernel's lanes fold the parts the same way):
    one pair a blob, whose y is exact against the JAX fraction tree, the
    in-domain row included.  (8, 256): chunks of 64 elements on 256
    threads, 192 of them holding the identity; (64, 32): two parts a
    lane of the fold."""
    from tpukzg_torch.field.mont import FR_PLAIN
    from tpukzg_torch.kernels import fractree
    from tpukzg_torch.poly.poly import _fraction_merge
    plan, evals, z, ref = fractree_case
    ev, zz = torch.from_numpy(evals), torch.from_numpy(z)
    a, b = fractree.fractree_partials_strided(
        ev, zz, torch.from_numpy(plan.roots), parts, threads)
    assert a.shape == b.shape == (3, 1, 16)
    got = FR_PLAIN.mul(_fraction_merge(a, b, FR_PLAIN),
                       torch.from_numpy(plan.n_inv))
    assert np.array_equal(got.numpy(), ref.astype(np.int32))


def test_fractree_launcher_grid():
    """The launcher's grid: k parts >= twice the SMs where chunks of a
    warp allow it, always a power of two, and 32 elements a thread; any
    other count of parts is refused before any launch (the chunks must
    divide n, a power of two)."""
    from tpukzg_torch.kernels import fractree
    assert [fractree.parts_for(k, 4096, 132) for k in (1, 3, 16, 256)] == [
        128, 128, 32, 2]
    assert fractree.parts_for(3, 256, 132) == 8
    assert fractree.parts_for(16, 16, 132) == 1
    assert [fractree.threads_for(c) for c in (1, 32, 256, 2048, 4096,
                                              8192, 1 << 14)] == [
        32, 32, 32, 64, 128, 256, 256]
    ev, z = torch.zeros((2, 256, 16), dtype=torch.int32), torch.zeros(
        (2, 16), dtype=torch.int32)
    for parts in (3, 6, 0):
        with pytest.raises(ValueError, match="power of two"):
            fractree._launch(ev, z, ev[0], parts)
