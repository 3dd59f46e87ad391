"""The port's utils (src/tpukzg_torch/utils) against the JAX package's
(src/tpukzg/utils), and the knobs they read where the JAX package reads
them: TPUKZG_CHECKED, TPUKZG_CHECK_SUBGROUP, TPUKZG_DEGREE,
TPUKZG_MSM_WINDOW and TPUKZG_MSM_WINDOW_CHUNK.  Tolerance: exact."""

import json
import logging
import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.utils import checked as jchecked, config as jconfig, obs as jobs
from tpukzg_torch.curve import g1 as tg1
from tpukzg_torch.field.mont import FP, FR, P_MOD
from tpukzg_torch.msm import pippenger_lm
from tpukzg_torch.utils import checked, config, obs

from torch_cases import srs_points

torch.set_num_threads(1)

ENVS = [{}, {"TPUKZG_DEGREE": "64", "TPUKZG_CHECK_SUBGROUP": "0",
             "TPUKZG_MSM_WINDOW": "7", "TPUKZG_MSM_WINDOW_CHUNK": "3",
             "TPUKZG_MSM_BUCKET_ALGO": "sort"}]


def _setenv(monkeypatch, env):
    for k in ("TPUKZG_DEGREE", "TPUKZG_CHECK_SUBGROUP", "TPUKZG_MSM_WINDOW",
              "TPUKZG_MSM_WINDOW_CHUNK", "TPUKZG_MSM_BUCKET_ALGO"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)


@pytest.mark.parametrize("env", ENVS, ids=["default", "set"])
def test_configs_from_env_match_jax(monkeypatch, env):
    _setenv(monkeypatch, env)
    ours = config.as_json_dict(config.KzgConfig.from_env(),
                               config.MsmConfig.from_env())
    ref = jconfig.as_json_dict(jconfig.KzgConfig.from_env(),
                               jconfig.MsmConfig.from_env())
    assert ours == ref
    assert ours["KzgConfig"]["check_subgroup"] is (not env)


def test_metric_record_matches_jax():
    kw = dict(config={"k": 256, "n": 4096}, chips=1, hosts=1, wall_s=1.5,
              verifications_per_s=170.6, sol_hbm=0.25)
    assert obs.metric_record(**kw) == jobs.metric_record(**kw)
    assert obs.metric_record(config={}, chips=1, hosts=1, wall_s=0.0) == \
        jobs.metric_record(config={}, chips=1, hosts=1, wall_s=0.0)


def test_obs_logger_trace_and_jsonl(tmp_path, caplog):
    log = obs.get_logger("msm")
    assert log.name == jobs.get_logger("msm").name == "tpukzg.msm"
    with caplog.at_level(logging.DEBUG, logger="tpukzg.msm"):
        with obs.trace("verify.stage1", log):
            pass
    assert any(r.getMessage().startswith("verify.stage1: ")
               for r in caplog.records)
    path = tmp_path / "m.jsonl"
    obs.dump_jsonl(str(path), {"a": 1})
    obs.dump_jsonl(str(path), {"b": 2})
    assert [json.loads(ln) for ln in path.read_text().splitlines()] == [
        {"a": 1}, {"b": 2}]


def test_check_limbs_only_when_checked(monkeypatch):
    ok = np.full((3, 16), 0xFFFF, np.int32)
    wide = ok.copy()
    wide[1, 5] = 1 << 16                       # a 17-bit limb
    monkeypatch.delenv("TPUKZG_CHECKED", raising=False)
    checked.check_limbs("z", wide)             # off: no check
    monkeypatch.setenv("TPUKZG_CHECKED", "1")
    assert checked.enabled() and jchecked.enabled()
    checked.check_limbs("z", ok)
    checked.check_limbs("z", torch.from_numpy(ok))
    for fn, arr in ((checked.check_limbs, wide),
                    (checked.check_limbs, torch.from_numpy(wide)),
                    (jchecked.check_limbs, wide.astype(np.uint32))):
        with pytest.raises(AssertionError, match="exceeds 16-bit bound"):
            fn("z", arr)


@pytest.mark.parametrize("name", ["Fp", "Fr"])
def test_montmul_golden_matches_jax(name):
    from tpukzg.field.mont import FP as JFP, FR as JFR
    ours, ref = (FP, JFP) if name == "Fp" else (FR, JFR)
    rng = random.Random(17)
    vals = [rng.randrange(ours.modulus) for _ in range(8)] + [ours.modulus - 1]
    for a, b in zip(vals, vals[::-1]):
        la, lb = ours.from_int(a), ours.from_int(b)
        got = checked.montmul_golden(la, lb, ours)
        assert np.array_equal(got, jchecked.montmul_golden(
            la.astype(np.uint32), lb.astype(np.uint32), ref))
        R = 1 << (16 * ours.L)
        assert ours.to_int(got) == a * b * pow(R, -1, ours.modulus) % \
            ours.modulus


def test_cios_bound_certificates():
    assert checked.cios_bound_certificate() == jchecked.cios_bound_certificate()
    words = checked.cios_bound_certificate(32, 64)   # the CUDA sources'
    assert words["worst_intermediate"] == (1 << 64) - 1
    with pytest.raises(AssertionError):
        checked.cios_bound_certificate(32, 63)


def test_check_subgroup_off_accepts_a_point_outside_g1(monkeypatch):
    """TPUKZG_CHECK_SUBGROUP=0: the on-curve point outside G1 passes, as
    in the JAX package's decompress_batch; the point off the curve is
    still refused, and the coordinates equal the JAX package's."""
    from tpukzg.curve import g1 as jg1
    x = 3
    while True:
        x += 1
        y = gold.fp_sqrt((x ** 3 + 4) % P_MOD)
        if y is not None and not gold.g1_in_subgroup(
                gold.g1_from_affine((x, y))):
            break
    off = 3
    while gold.fp_sqrt((off ** 3 + 4) % P_MOD) is not None:
        off += 1
    enc = [gold.g1_compress(gold.G1_GEN), tg1.compress(x, y, False),
           tg1.compress(off, 0, False)]
    monkeypatch.setenv("TPUKZG_CHECK_SUBGROUP", "1")
    _, ok = tg1.decompress_batch(enc, "cpu")
    assert ok.tolist() == [True, False, False]
    monkeypatch.setenv("TPUKZG_CHECK_SUBGROUP", "0")
    got, ok = tg1.decompress_batch(enc, "cpu")
    ref, ok_ref = jg1.decompress_batch(enc)
    assert ok.tolist() == np.asarray(ok_ref).tolist() == [True, True, False]
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r).astype(np.int32))


def test_cli_gen_setup_degree_from_env(monkeypatch, tmp_path):
    from tpukzg_torch import cli
    monkeypatch.setenv("TPUKZG_DEGREE", "16")
    out = tmp_path / "srs.npz"
    cli.main(["gen-setup", "--out", str(out), "--device", "cpu"])
    with np.load(out) as z:
        assert z["lag_0"].shape == (16, 24)


def test_msm_window_and_chunk_from_env(monkeypatch):
    """The public MSM's window follows TPUKZG_MSM_WINDOW (the point is
    the same), and a bucket-scan chunk's rows TPUKZG_MSM_WINDOW_CHUNK."""
    pts = tuple(torch.from_numpy(c[:, :6].T.copy()) for c in srs_points())
    k = torch.from_numpy(FR.from_int([3, 5, 7, 11, 13, 2 ** 200 + 1]))
    seen = []
    real = pippenger_lm.msm_grouped

    def spy(points, scalars, groups, c, curve=pippenger_lm.G1_LM):
        seen.append(c)
        return real(points, scalars, groups, c, curve)

    monkeypatch.setattr(pippenger_lm, "msm_grouped", spy)
    monkeypatch.delenv("TPUKZG_MSM_WINDOW", raising=False)
    want = pippenger_lm.msm(pts, k)
    monkeypatch.setenv("TPUKZG_MSM_WINDOW", "5")
    got = pippenger_lm.msm(pts, k)
    assert seen == [pippenger_lm.default_window(6), 5]
    assert tg1.compress_points(tuple(c[None] for c in got)) == \
        tg1.compress_points(tuple(c[None] for c in want))
    monkeypatch.delenv("TPUKZG_MSM_WINDOW_CHUNK", raising=False)
    assert pippenger_lm._chunk(16, 100) == 100
    monkeypatch.setenv("TPUKZG_MSM_WINDOW_CHUNK", "3")
    assert pippenger_lm._chunk(16, 100) == 3
    assert pippenger_lm._chunk(16, 2) == 2
