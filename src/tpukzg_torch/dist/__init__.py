from tpukzg_torch.dist.mesh import MeshConfig, allreduce_points
from tpukzg_torch.dist.msm import ShardedMsm
from tpukzg_torch.dist.ntt import DistNtt
from tpukzg_torch.dist.batch import ShardedBatchVerifier

__all__ = ["MeshConfig", "allreduce_points", "ShardedMsm", "DistNtt",
           "ShardedBatchVerifier"]
