"""The port's multi-GPU paths (``tpukzg_torch.dist``) on the CPU: world
sizes 2 and 4, each rank a process that ``dist.launch.run`` spawned into
one gloo process group, against the JAX package's ``tpukzg.dist`` on
its 8 virtual CPU devices and the golden model: the butterfly and the
sharded MSM here; the four-step NTT, the sharded batch verify and the
launcher's failures in test_torch_dist_ntt.py, test_torch_dist_batch.py
and test_torch_dist_launch.py.

Tolerances: points equal in affine form (the sharded MSM adds in
another order than the JAX one); every rank's butterfly result equal
limb for limb."""

import random

import numpy as np
import pytest

import golden.model as gold
from tpukzg.curve import g1 as jg1
from tpukzg.curve.g1 import G1 as JG1
from tpukzg.dist import MeshConfig as JMeshConfig
from tpukzg.dist import ShardedMsm as JShardedMsm
from tpukzg.field.mont import FR as JFR

import torch_dist_cases as cases
from tpukzg_torch.dist import launch

N_MSM = 32


def run(fn, world, tmp_path, *args):
    return launch.run(cases.on_one_thread, world, "gloo",
                      init_file=str(tmp_path / f"rendezvous_{world}"),
                      args=(fn, *args), timeout=120)


def g1_affine(pts):
    return [gold.g1_affine(p) for p in pts]


def g2_sum(pts, ks):
    acc = gold.G2_INF
    for p, k in zip(pts, ks):
        acc = gold.g2_add(acc, gold.g2_mul(p, k))
    return acc


@pytest.fixture(scope="module")
def msm_case():
    rng = random.Random(0x5EED)
    ks = [rng.randrange(gold.R) for _ in range(N_MSM)]
    pts = [gold.g1_mul(gold.G1_GEN, rng.randrange(gold.R))
           for _ in range(N_MSM)]
    return pts, ks, gold.g1_affine(gold.g1_msm(pts, ks))


@pytest.fixture(scope="module")
def jax_msm(msm_case):
    """The JAX package's ShardedMsm on its 8 virtual devices, c = 4."""
    pts, ks, _ = msm_case
    aff = g1_affine(pts)
    jp = jg1.points_from_ints([a[0] for a in aff], [a[1] for a in aff],
                              [False] * N_MSM)
    sm = JShardedMsm(JG1, JMeshConfig(n_devices=8))
    x, y, inf = jg1.point_to_ints(sm.msm(jp, np.asarray(JFR.from_int(ks)),
                                         c=4))
    assert not bool(inf)
    return x, y


@pytest.mark.parametrize("world", [2, 4])
def test_allreduce_points(world, tmp_path):
    """Every rank ends with the sum of the ranks' points, in the same
    projective coordinates on every rank."""
    rng = random.Random(world)
    pts = [gold.g1_mul(gold.G1_GEN, rng.randrange(gold.R))
           for _ in range(world)]
    acc = gold.G1_INF
    for p in pts:
        acc = gold.g1_add(acc, p)
    out = run(cases.allreduce_case, world, tmp_path, g1_affine(pts))
    for ints, limbs in out:
        assert ints[:2] == gold.g1_affine(acc) and not ints[2]
        assert limbs == out[0][1]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_msm_vs_jax_and_golden(world, tmp_path, msm_case, jax_msm):
    pts, ks, want = msm_case
    assert jax_msm == want
    out = run(cases.sharded_msm_case, world, tmp_path, "G1", g1_affine(pts),
              ks, 4)
    for x, y, inf in out:
        assert (x, y) == want and not inf


def test_sharded_msm_g2_vs_golden(tmp_path):
    """Over G2 the local MSM is the generic Pippenger (tensor code)."""
    rng = random.Random(0x62)
    n = 16
    ks = [rng.randrange(gold.R) for _ in range(n)]
    pts = [gold.g2_mul(gold.G2_GEN, rng.randrange(gold.R)) for _ in range(n)]
    aff = [((a[0].c0, a[0].c1), (a[1].c0, a[1].c1))
           for a in map(gold.g2_affine, pts)]
    want = gold.g2_affine(g2_sum(pts, ks))
    for x, y, inf in run(cases.sharded_msm_case, 2, tmp_path, "G2", aff,
                         ks, 4):
        assert (x, y) == ((want[0].c0, want[0].c1), (want[1].c0, want[1].c1))
        assert not inf
