"""The MSM data-parallel over the point axis (counterpart of
``tpukzg/dist/msm.py``): each rank runs the local MSM of its contiguous
block of n / N points, and the butterfly of ``dist/mesh.py`` sums the
partial results on every rank."""

from __future__ import annotations

from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.dist.mesh import MeshConfig, allreduce_points
from tpukzg_torch.msm import pippenger_lm
from tpukzg_torch.msm.pippenger import Pippenger, default_window


class ShardedMsm:
    def __init__(self, curve, cfg: MeshConfig | None = None,
                 window: int | None = None, mesh=None):
        self.curve = curve
        self.cfg = cfg or MeshConfig()
        self.mesh = mesh if mesh is not None else self.cfg.build()
        self.window = window
        self.pip = Pippenger(curve, window=window)

    def msm(self, points, scalars, c: int | None = None):
        """sum_i [k_i] P_i over every rank's points, returned on every
        rank.  points: the whole (X, Y, Z) list with a leading axis of n
        (a multiple of the ranks), scalars (n, 16) canonical, the same
        on every rank; each rank reads its block.  Over G1 the local MSM
        is ``pippenger_lm.msm`` (the bucket-scan, add and double
        kernels), over another curve the generic Pippenger."""
        n, N, r = scalars.shape[0], self.mesh.world, self.mesh.rank
        if n % N:
            raise ValueError(f"ShardedMsm: {n} points on {N} ranks")
        m, dev = n // N, self.mesh.device
        pts = tuple(p[r * m:(r + 1) * m].to(dev) for p in points)
        ks = scalars[r * m:(r + 1) * m].to(dev)
        if c is None:
            c = self.window or default_window(m)
        if self.curve is G1:
            local = pippenger_lm.msm(pts, ks, c)
        else:
            local = self.pip.msm(pts, ks, c)
        return allreduce_points(self.curve, local, self.mesh)
