"""The port's entry points: no JAX anywhere in its import graph, no silent
move to the CPU, the same setup arrays as the JAX package, and the
single verify against the known-answer tests and the golden model."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import golden.model as gold
import tpukzg_torch as tt
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.curve.weierstrass_lm import G1_LM
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
for name in ("jax", "jaxlib", "tpukzg", "golden", "bench"):
    sys.modules[name] = None          # any import of these now fails
sys.path.insert(0, sys.argv[1])
import numpy as np
import tpukzg_torch as tt
import tpukzg_torch.bench
from tpukzg_torch.utils import checked, config, obs
from tpukzg_torch import dist
from tpukzg_torch.dist import launch
from tpukzg_torch.msm import pippenger
from tpukzg_torch.pairing.check import pairing
z = np.load(sys.argv[2])
ts = tt.generate_insecure_setup(0xDEADBEEF, 16, device="cpu")
pend = tt.verify_blob_kzg_proof_batch_pipeline(
    [z["blob"].tobytes()], [z["c"].tobytes()], [z["p"].tobytes()], ts)
pend.stage2()
ok = pend.result()
same = tt.blob_to_kzg_commitment(z["blob"].tobytes(), ts) == z["c"].tobytes()
mods = [m for m in sys.modules if m.split(".")[0] in ("jax", "tpukzg",
                                                     "bench")
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


with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as _fh:
    KAT = json.load(_fh)


@pytest.fixture(scope="module")
def ts16():
    return tt.generate_insecure_setup(TAU, N, device="cpu")


def _opening(case):
    o = KAT[case]
    return (bytes.fromhex(KAT["kzg"]["commitment"]), int(o["z"], 16),
            int(o["y"], 16), bytes.fromhex(o["proof"]))


def _golden_verify(c, z, y, pf):
    return gold.verify_kzg_proof(gold.GoldenSetup(TAU, N),
                                 gold.g1_decompress(c), z, y,
                                 gold.g1_decompress(pf))


def test_verify_kzg_proof_kat(ts16):
    """The public single verify accepts the KAT opening (z outside the
    domain), as the golden model does."""
    c, z, y, pf = _opening("kzg_open")
    assert tt.verify_kzg_proof(c, z.to_bytes(32, "big"), y.to_bytes(32, "big"),
                               pf, ts16) is True
    assert _golden_verify(c, z, y, pf)


@pytest.mark.parametrize("bad", ["commitment_flags", "proof_length",
                                 "z_ge_r", "y_length", "proof_off_curve"])
def test_verify_kzg_proof_rejects_bad_encodings(ts16, bad):
    """ValueError, as the JAX package raises on the same inputs."""
    c, z, y, pf = _opening("kzg_open")
    zb, yb = z.to_bytes(32, "big"), y.to_bytes(32, "big")
    if bad == "commitment_flags":          # tests/test_kzg.py:101-103
        c, zb, yb, pf = (b"\x00" * 48, b"\x00" * 32, b"\x00" * 32,
                         b"\xc0" + b"\x00" * 47)
        import tpukzg
        with pytest.raises(ValueError):
            tpukzg.verify_kzg_proof(c, zb, yb, pf,
                                    tpukzg.generate_insecure_setup(TAU, N))
    elif bad == "proof_length":
        pf = pf[:47]
    elif bad == "z_ge_r":
        zb = gold.R.to_bytes(32, "big")
    elif bad == "y_length":
        yb = yb[1:]
    else:
        x = 3
        while gold.fp_sqrt((x ** 3 + 4) % gold.P) is not None:
            x += 1
        pf = tg1.compress(x, 0, False)
    with pytest.raises(ValueError):
        tt.verify_kzg_proof(c, zb, yb, pf, ts16)


def test_repaired_helpers_need_a_device():
    """decompress_batch and CurveLM.inf take no default device: a caller
    that forgets it fails instead of running on the CPU."""
    enc = [gold.g1_compress(gold.G1_GEN)]
    with pytest.raises(TypeError):
        tg1.decompress_batch(enc)
    with pytest.raises(TypeError):
        G1_LM.inf((1,))
    pts, ok = tg1.decompress_batch(enc, "cpu")
    assert pts[0].device == torch.device("cpu") and ok.tolist() == [True]
    assert G1_LM.inf((2,), "cpu")[1].shape == (24, 2)


def test_cli_has_no_bench_yet(capsys):
    """The help lists every command of the JAX package's CLI, bench
    included, and no longer says that bench is missing (the note the
    test is named for); bench's arguments are checked in
    tests/test_torch_bench.py."""
    from tpukzg_torch import cli
    with pytest.raises(SystemExit):
        cli.main(["--help"])
    out = capsys.readouterr().out
    assert "gen-setup" in out and "selftest" in out and "verify" in out
    assert "bench" in out and "No bench command yet" not in out
    with pytest.raises(SystemExit):
        cli.main(["bench", "--help"])
    out = capsys.readouterr().out
    assert "--k" in out and "--reps" in out and "--device" in out
