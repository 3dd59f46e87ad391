"""The port's four-step NTT across ranks (``tpukzg_torch.dist.DistNtt``)
on the CPU: world sizes 2 and 4 in one gloo process group each
(``dist.launch.run``), n = 64, at the square split and at n1 != n2 from
TPUKZG_NTT_ROWS, against the JAX package's ``DistNtt`` on its 8 virtual
CPU devices (itself checked against the golden model's NTT).
Tolerance: bit for bit, forward and inverse."""

import random

import numpy as np
import pytest

import golden.model as gold
from tpukzg.dist import DistNtt as JDistNtt
from tpukzg.dist import MeshConfig as JMeshConfig
from tpukzg.field.mont import FR as JFR

import torch_dist_cases as cases
from tpukzg_torch.dist import launch
from tpukzg_torch.field.mont import FR

N_NTT = 64


def run(fn, world, tmp_path, *args):
    return launch.run(cases.on_one_thread, world, "gloo",
                      init_file=str(tmp_path / f"rendezvous_{world}"),
                      args=(fn, *args), timeout=120)


@pytest.fixture(scope="module")
def ntt_case():
    """Coefficients and the JAX DistNtt's evaluations (8 devices, the
    square split), as canonical ints."""
    rng = random.Random(0x7)
    coeffs = [rng.randrange(gold.R) for _ in range(N_NTT)]
    coeffs[:3] = [0, 1, gold.R - 1]
    dn = JDistNtt(N_NTT, JMeshConfig(n_devices=8))
    out = np.asarray(JFR.from_mont(dn.ntt(np.asarray(JFR.to_mont(
        JFR.from_int(coeffs))))))
    evals = [JFR.to_int(r) for r in out]
    assert evals == gold.ntt(coeffs)
    return coeffs, evals


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("split", ["square", "rows_env"])
def test_dist_ntt_vs_jax(world, split, tmp_path, ntt_case, monkeypatch):
    """Forward equal to the JAX DistNtt bit for bit, inverse back to the
    input; at the square split (8 x 8) and at 16 x 4 from
    TPUKZG_NTT_ROWS (read in each rank)."""
    coeffs, evals = ntt_case
    n1 = 8
    if split == "rows_env":
        monkeypatch.setenv("TPUKZG_NTT_ROWS", "16")
        n1 = None
    out = run(cases.dist_ntt_case, world, tmp_path, N_NTT, n1, coeffs)
    fwd = np.concatenate([np.asarray(o[2], np.int32) for o in out])
    back = np.concatenate([np.asarray(o[3], np.int32) for o in out])
    assert {(o[0], o[1]) for o in out} == ({(8, 8)} if split == "square"
                                            else {(16, 4)})
    want = FR.to_mont_host(evals)
    assert np.array_equal(fwd, want)
    assert np.array_equal(back, FR.to_mont_host(coeffs))
