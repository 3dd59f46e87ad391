"""The port's mesh and process launcher (``tpukzg_torch.dist.mesh``,
``dist.launch``) on the CPU: a mesh without a process group, and a run
whose rank raises or hangs (gloo, world 2)."""

import pytest
import torch

import torch_dist_cases as cases
from tpukzg_torch.dist import MeshConfig, launch


def test_mesh_config_without_a_group():
    """One process, no process group: world 1 on the device asked for;
    another device count is refused, and no device is guessed."""
    mesh = MeshConfig(device="cpu").build()
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    with pytest.raises(ValueError):
        MeshConfig(n_devices=2, device="cpu").build()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            MeshConfig().build()


@pytest.mark.parametrize("how", ["raise", "hang"])
def test_launch_fails_on_a_rank(how, tmp_path):
    """A rank that raises, or that gives no result in time, fails the
    run, and no process is left."""
    with pytest.raises(RuntimeError, match="rank"):
        launch.run(cases.failing_case, 2, "gloo",
                   init_file=str(tmp_path / "rendezvous"), args=(how,),
                   timeout=8 if how == "hang" else 60)
