"""The batch verify data-parallel over the openings (counterpart of
``tpukzg/dist/batch.py``): each rank folds its block of the k openings
into the two partial aggregates with one grouped MSM, the butterfly sums
them on every rank, and every rank runs the two-pairing check."""

from __future__ import annotations

from tpukzg_torch.curve.g1 import G1
from tpukzg_torch.dist.mesh import MeshConfig, allreduce_points
from tpukzg_torch.kzg.core import Kzg


class ShardedBatchVerifier:
    def __init__(self, setup, cfg: MeshConfig | None = None,
                 window: int | None = None, mesh=None):
        self.cfg = cfg or MeshConfig()
        self.mesh = mesh if mesh is not None else self.cfg.build()
        self.kzg = Kzg(setup)               # the setup on the rank's device
        self.window = window

    def aggregates(self, c_points, z_can, y_can, proof_points, rho_can,
                   c: int | None = None):
        """(sum rho^i pi_i, sum rho^i (C_i - [y_i] G1 + [z_i] pi_i)) over
        all k openings, on every rank.  The arguments are those of
        ``Kzg.verify_batch``, the whole batch on every rank; each rank
        folds its block of k / N openings: its rho z, and its own
        -sum rho y as the generator's scalar, so the butterfly counts
        each term once."""
        k, N, r = z_can.shape[0], self.mesh.world, self.mesh.rank
        if k % N:
            raise ValueError(f"ShardedBatchVerifier: {k} openings on {N} "
                             "ranks")
        m, dev = k // N, self.mesh.device

        def mine(t):
            return t[r * m:(r + 1) * m].to(dev)

        pi_agg, lhs = self.kzg.verify_batch_msm(
            tuple(mine(p) for p in c_points), mine(z_can), mine(y_can),
            tuple(mine(p) for p in proof_points), mine(rho_can),
            c=c or self.window)
        return (allreduce_points(G1, pi_agg, self.mesh),
                allreduce_points(G1, lhs, self.mesh))

    def verify_batch(self, c_points, z_can, y_can, proof_points, rho_can,
                     c: int | None = None):
        """The contract of ``Kzg.verify_batch``, sharded over the k axis
        (k a multiple of the ranks) -> a bool tensor, on every rank."""
        return self.kzg.verify_batch_pair(*self.aggregates(
            c_points, z_can, y_can, proof_points, rho_can, c))
