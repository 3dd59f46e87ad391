"""The process group the multi-GPU paths run over, and the EC-point
all-reduce (counterpart of ``tpukzg/dist/mesh.py``).

A mesh is one flat axis of ranks: the process group that
``torch.distributed`` was initialised with (NCCL on the cards, gloo on
the CPU), or a single process when none was.  Each rank runs on its own
device, ``cuda:<local rank>`` unless the caller names one.  Points never
cross ranks by ``all_reduce``: EC addition is a group operation, not a
sum of limbs, so `allreduce_points` is the recursive-doubling butterfly
of point swaps and complete adds.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    rank: int
    world: int
    group: object          # the process group; None for a single process
    device: torch.device


@dataclass(frozen=True)
class MeshConfig:
    """axis: the mesh axis's name, kept only so that a JAX package's
    MeshConfig(...) call reads the same; nothing reads it, since a mesh
    here is one flat axis of ranks; n_devices: the ranks expected (None:
    the process group's size); device: this rank's device (None: the card
    of its local rank)."""
    axis: str = "chips"
    n_devices: int | None = None
    device: str | None = None

    def build(self) -> Mesh:
        if dist.is_available() and dist.is_initialized():
            group = dist.group.WORLD
            rank, world = dist.get_rank(), dist.get_world_size()
        else:
            group, rank, world = None, 0, 1
        if self.n_devices is not None and self.n_devices != world:
            raise ValueError(f"MeshConfig: {self.n_devices} devices asked, "
                             f"the process group has {world} ranks")
        if world & (world - 1):
            raise ValueError(f"MeshConfig: {world} ranks, a power of two "
                             "is required")
        if self.device is not None:
            device = torch.device(self.device)
        elif torch.cuda.is_available():
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
        else:
            raise RuntimeError("tpukzg_torch.dist: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        return Mesh(rank, world, group, device)


def _swap(t, peer: int, mesh: Mesh):
    """t sent to rank `peer` and the same shape received from it."""
    t = t.contiguous()
    out = torch.empty_like(t)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, t, peer, mesh.group),
        dist.P2POp(dist.irecv, out, peer, mesh.group)])
    for r in reqs:
        r.wait()
    return out


def allreduce_points(curve, pt, mesh: Mesh):
    """The sum of every rank's point, on every rank: log2(N) steps; at
    step `shift` each rank swaps its point with rank ^ shift (the three
    coordinates stacked into one tensor) and adds (``dist/mesh.py:
    51-67``).  The complete add is symmetric, so every rank ends with
    the same coordinates."""
    shift = 1
    while shift < mesh.world:
        other = _swap(torch.stack(torch.broadcast_tensors(*pt)),
                     mesh.rank ^ shift, mesh)
        pt = curve.add(pt, tuple(other))
        shift <<= 1
    return pt
