"""The rank functions of the port's multi-process tests
(test_torch_dist.py on the CPU with gloo, test_torch_cuda.py on a card
with NCCL): each runs in a process that ``tpukzg_torch.dist.launch.run``
spawned, so it lives in a module of its own that imports neither JAX
nor the JAX package, and it returns plain Python values."""

import torch

from tpukzg_torch.curve import g1 as g1m, g2 as g2m
from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.field.mont import FP, FR


def on_one_thread(rank, world, case, *args):
    """case(rank, world, *args) on one intra-op thread.  The launcher
    gives each gloo rank its share of the host's cores, which
    oversubscribes the host when other test processes (pytest-xdist
    workers) run beside the ranks; the cases' tensors are small."""
    torch.set_num_threads(1)
    return case(rank, world, *args)


def g1_points(affine, device):
    """[(x, y)] affine ints -> (X, Y, Z) of (n, 24) Montgomery."""
    n = len(affine)
    return tuple(torch.as_tensor(a, device=device) for a in (
        FP.to_mont_host([x for x, _ in affine]),
        FP.to_mont_host([y for _, y in affine]),
        FP.one_mont[None].repeat(n, 0)))


def g2_points(affine, device):
    """[((x0, x1), (y0, y1))] affine ints -> (X, Y, Z) of (n, 2, 24)."""
    pts = [g2m.point_from_ints(*x, *y) for x, y in affine]
    return tuple(torch.stack([torch.as_tensor(p[i]) for p in pts]).to(device)
                 for i in range(3))


def scalars(ks, device):
    return torch.as_tensor(FR.from_int(list(ks)), device=device)


def allreduce_case(rank, world, affine, device="cpu"):
    """Rank i holds point i of `affine`; the butterfly sums them -> the
    sum's affine ints and its projective limbs (equal on every rank:
    the complete add is symmetric)."""
    from tpukzg_torch.dist import MeshConfig, allreduce_points
    mesh = MeshConfig(device=device).build()
    p = tuple(c[rank] for c in g1_points(affine, mesh.device))
    out = allreduce_points(G1, p, mesh)
    limbs = torch.stack(out).cpu()
    return g1m.point_to_ints(out), limbs.tolist()


def sharded_msm_case(rank, world, curve, affine, ks, c, device="cpu"):
    """ShardedMsm over the whole list on every rank -> affine ints."""
    from tpukzg_torch.dist import MeshConfig, ShardedMsm
    mesh = MeshConfig(device=device).build()
    if curve == "G1":
        pts, cv, to_ints = g1_points(affine, mesh.device), G1, g1m.point_to_ints
    else:
        pts, cv, to_ints = g2_points(affine, mesh.device), G2, g2m.point_to_ints
    out = ShardedMsm(cv, mesh=mesh).msm(pts, scalars(ks, mesh.device), c=c)
    return to_ints(tuple(o.cpu() for o in out))


def dist_ntt_case(rank, world, n, n1, coeffs, device="cpu"):
    """This rank's blocks of DistNtt's ntt and of intt(ntt) -> limbs."""
    from tpukzg_torch.dist import DistNtt, MeshConfig
    mesh = MeshConfig(device=device).build()
    dn = DistNtt(n, mesh=mesh, n1=n1)
    m = n // world
    vec = torch.as_tensor(FR.to_mont_host(coeffs[rank * m:(rank + 1) * m]),
                          device=mesh.device)
    fwd = dn.ntt(vec)
    return dn.n1, dn.n2, fwd.cpu().tolist(), dn.intt(fwd).cpu().tolist()


def batch_verify_case(rank, world, n, agg_case, cases, device="cpu"):
    """ShardedBatchVerifier on the committed n-point SRS: the two
    aggregates of `agg_case` ((C, z, y, pi, rho powers) as affine and
    canonical ints) as affine ints, and the verdict of verify_batch on
    each of `cases`."""
    from tpukzg_torch.dist import MeshConfig, ShardedBatchVerifier
    from tpukzg_torch.kzg.setup import Setup
    mesh = MeshConfig(device=device).build()
    setup = Setup.generate_insecure(0xDEADBEEF, n, device=mesh.device)
    sbv = ShardedBatchVerifier(setup, mesh=mesh)
    pi_agg, lhs = sbv.aggregates(*batch_tensors(*agg_case, mesh.device))
    return (g1m.point_to_ints(tuple(c.cpu() for c in pi_agg)),
            g1m.point_to_ints(tuple(c.cpu() for c in lhs)),
            [bool(sbv.verify_batch(*batch_tensors(*c, mesh.device)).item())
             for c in cases])


def batch_tensors(cs, zs, ys, pis, rhos, device):
    """Kzg.verify_batch's arguments from ints: C and pi affine, z, y and
    the powers of rho as canonical limbs."""
    return (g1_points(cs, device), scalars(zs, device), scalars(ys, device),
            g1_points(pis, device), scalars(rhos, device))


def failing_case(rank, world, how):
    """Rank 1 raises ("raise") or hangs ("hang"); rank 0 returns."""
    import time
    if rank == 1 and how == "raise":
        raise ValueError("rank 1 fails")
    if rank == 1 and how == "hang":
        time.sleep(600)
    return rank
