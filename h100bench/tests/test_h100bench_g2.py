"""The G2 cell: its files resolve, its reference agrees with the
repository's known-answer vectors, and work_g2.py's counts.  (Its faults
and control run with every cell's in test_h100bench_faults.py and
test_h100bench_control.py; the reference is held against the golden
model by the tier-1 test tests/test_torch_g2_msm.py.)"""

import json
import os

import numpy as np

from h100bench.tests import tiny
from h100bench import harness, work, work_g2
from h100bench.reference import bls_g2, kzg

CELL = "g2-msm-2p20-groth16"

with open(os.path.join(tiny.REPO, "tests", "vectors", "kat.json")) as fh:
    KAT = json.load(fh)


def test_the_g2_cell_resolves_to_its_files(tmp_path):
    root = tiny.make_copy(str(tmp_path / "copy"), cut=False)
    cell = harness.Cell(root, CELL)
    assert cell.config["name"] == "groth16-bls12-381-g2-2p20"
    assert cell.config["points"] == 1 << 20 and cell.config["reduced"] == []
    assert cell.config["curve"] == "BLS12-381 G2"
    assert cell.traffic["kind"] == "msm_g2"
    assert cell.kind.Kind.__module__.endswith("msm_g2")
    assert set(cell.kind.faults()) == {"control", "half_batch",
                                       "answer_altered", "stale_answer"}
    assert {m["name"] for m in cell.end_to_end} == {"msm_points_per_s",
                                                    "setup_s"}
    assert set(cell.readers) == {"g2_msm_roofline", "tensor_ops_per_msm.g2",
                                 "device_idle.msm"}
    g1 = harness.Cell(root, "msm-2p20-commit")
    assert set(g1.readers) == {"msm_roofline", "device_idle.msm"}


def test_g2_reference_multiples_match_the_kat():
    for s, enc in KAT["g2_multiples"].items():
        assert bls_g2.compress(bls_g2.mul(bls_g2.GEN, int(s))).hex() == enc
        assert bls_g2.compress(bls_g2.mul_gen(int(s))).hex() == enc
    a = bls_g2.affine(bls_g2.mul_gen(0xDEADBEEF))
    assert bls_g2.on_curve(a)
    assert bls_g2.affine(bls_g2.add(bls_g2.mul_gen(5), bls_g2.neg(
        bls_g2.mul_gen(5)))) is None


def test_g2_output_limbs_decode():
    """A projective Montgomery point (x z R, y z R, z R) in 48 limbs a
    coordinate (c0's 24, then c1's) decodes to (x, y); Z = 0 to None; the
    MSM answer from logs alone."""
    (x, y) = bls_g2.affine(bls_g2.mul_gen(12345))
    z = (777, 3)
    R = 1 << 384

    def limbs(v):
        w = bls_g2.mul2(v, z)
        return np.concatenate([np.frombuffer((c * R % bls_g2.P).to_bytes(
            48, "little"), "<u2") for c in w])
    got = bls_g2.point_from_limbs(limbs(x), limbs(y), limbs((1, 0)))
    assert got == (x, y)
    assert bls_g2.point_from_limbs(limbs(x), limbs(y),
                                   np.zeros(48, "<u2")) is None
    k = np.array([[3] + [0] * 15, [5] + [0] * 15])
    s = kzg.limb_bytes(np.array([[7] + [0] * 15, [11] + [0] * 15]))
    assert bls_g2.msm_answer(k, s) == bls_g2.affine(bls_g2.mul_gen(76))


def test_g2_msm_work_2p20():
    w = work_g2.msm_g2_work(1, 1 << 20)
    assert w["adds"] == (1 << 20) - 1
    assert w["ops"] == ((1 << 20) - 1) * 6 * 3 * 144 * 4
    assert w["bytes"] == (1 << 20) * 192 + (1 << 20) * 32 + 192
    assert work.least_seconds(w) == w["ops"] / work.INT_OPS_S
    assert w["ops"] == 3 * work.msm_work(1, 1 << 20, False)["ops"]
