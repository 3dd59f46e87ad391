"""The port's entry points: no JAX anywhere in its import graph, no silent
move to the CPU, and the same setup arrays as the JAX package."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import golden.model as gold
import tpukzg_torch as tt
from tpukzg_torch.field.mont import FP, resolve_device
from tpukzg_torch.kernels import bucket, ec, fractree, montmul, ntt
from tpukzg_torch.kzg.setup import Setup

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
TAU = 0xDEADBEEF

torch.set_num_threads(1)


def test_setup_from_numpy_matches_jax_setup():
    """Both packages read the same npz; the port's tensors hold the JAX
    arrays' values, and load == from_numpy."""
    import tpukzg
    jts = tpukzg.generate_insecure_setup(TAU, N)
    s1 = Setup.generate_insecure(TAU, N, device="cpu")
    path = Setup._cache_path(os.path.join(REPO, ".srs_cache"), TAU, N)
    with np.load(path) as z:
        s2 = Setup.from_numpy({k: z[k] for k in z.files}, device="cpu")
    for ours, other, ref in ((s1.lagrange_g1, s2.lagrange_g1,
                              jts.setup.lagrange_g1),
                             (s1.lines_tau, s2.lines_tau, jts.setup.lines_tau)):
        for a, b, r in zip(ours, other, ref):
            assert a.dtype == torch.int32
            assert torch.equal(a, b)
            assert np.array_equal(a.numpy(), np.asarray(r).astype(np.int32))
    assert s1.n == jts.n and s1.device == torch.device("cpu")


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        tt.generate_insecure_setup(TAU, N)
    assert resolve_device("cpu") == torch.device("cpu")


def test_kernel_wrappers_never_fall_back():
    """A tensor that is neither on the CPU nor on a card is refused."""
    a = torch.zeros((24, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        montmul.montmul(a, a, FP, limb_dim=0)
    with pytest.raises(ValueError):
        ec.ec_add((a, a, a), (a, a, a))
    with pytest.raises(ValueError):
        bucket.seg_scan((a[:, None], a[:, None], a[:, None]),
                        torch.zeros((1, 4), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError):
        fractree.fractree_partials(
            torch.zeros((1, 8, 16), dtype=torch.int32, device="meta"),
            torch.zeros((1, 16), dtype=torch.int32, device="meta"),
            torch.zeros((8, 16), dtype=torch.int32, device="meta"))
    from tpukzg_torch.ntt.ntt import get_plan
    with pytest.raises(ValueError):
        ntt.ntt(torch.zeros((1, 16, 16), dtype=torch.int32, device="meta"),
                get_plan(16))


_CHILD = r"""
import sys
for name in ("jax", "jaxlib", "tpukzg", "golden"):
    sys.modules[name] = None          # any import of these now fails
sys.path.insert(0, sys.argv[1])
import numpy as np
import tpukzg_torch as tt
z = np.load(sys.argv[2])
ts = tt.generate_insecure_setup(0xDEADBEEF, 16, device="cpu")
ok = tt.verify_blob_kzg_proof_batch([z["blob"].tobytes()],
                                    [z["c"].tobytes()], [z["p"].tobytes()], ts)
same = tt.blob_to_kzg_commitment(z["blob"].tobytes(), ts) == z["c"].tobytes()
mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpukzg")
        and sys.modules[m] is not None]
print("VERDICT", ok, "COMMIT", same, "JAXMODS", mods)
"""


def test_port_runs_with_jax_blocked(tmp_path):
    gs = gold.GoldenSetup(TAU, N)
    blob = [(7 * i + 3) ** 5 % gold.R for i in range(N)]
    c = gold.g1_compress(gold.blob_to_kzg_commitment(gs, blob))
    p = gold.g1_compress(gold.compute_blob_kzg_proof(gs, blob, c)[0])
    path = tmp_path / "triple.npz"
    np.savez(path, blob=np.frombuffer(gold.blob_to_bytes(blob), np.uint8),
             c=np.frombuffer(c, np.uint8), p=np.frombuffer(p, np.uint8))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-c", _CHILD, os.path.join(REPO, "src"), str(path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "VERDICT True COMMIT True JAXMODS []" in out.stdout
