"""The port's setup path on the CPU: the G1 ladder, the Lagrange scalars,
`Setup.generate_insecure` (and the npz it writes), `from_compressed`,
the cache-write rule and the public chunked MSM, against the JAX
package, the golden model and the committed SRS files (the JAX
package's own output).  Tolerances: scalars, lines and saved arrays
exact; points compared in affine form (the committed points may come
from another ladder)."""

import json
import os
import random

import numpy as np
import pytest
import torch

import golden.model as gold
from tpukzg.kzg import setup as jsetup
from tpukzg_torch import cli
import tpukzg_torch as tt
from tpukzg_torch.curve import g1 as tg1, g2 as tg2
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.field.mont import FR
from tpukzg_torch.kzg.setup import Setup, _lagrange_scalars
from tpukzg_torch.msm.pippenger_lm import msm
from tpukzg_torch.ntt.ntt import get_plan

from torch_cases import REPO, SRS16

torch.set_num_threads(1)

TAU = 0xDEADBEEF
with open(os.path.join(REPO, "tests", "vectors", "kat.json")) as _fh:
    KAT = json.load(_fh)


def _gen(lanes):
    return tuple(torch.as_tensor(c)[:, None].expand(24, lanes).contiguous()
                 for c in tg1.GEN_NP)


def _compress_lm(pts):
    return tg1.compress_points(tuple(c.movedim(0, -1) for c in pts))


def _same_points(a, b):
    """Equal in affine form, lane by lane (projective cross-products)."""
    return bool(G1_LM.eq(tuple(c.movedim(-1, 0) for c in a),
                         tuple(c.movedim(-1, 0) for c in b)).all())


def _compressed(setup):
    mono = tg1.compress_points(setup.monomial_g1)
    lag = tg1.compress_points(setup.lagrange_g1)
    return mono, lag, tg2.compress_point(setup.g2_tau)


@pytest.fixture(scope="module")
def committed():
    return Setup.load(SRS16, device="cpu")


@pytest.fixture(scope="module")
def compressed(committed):
    return _compressed(committed)


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    """(setup, seconds of each step, its directory): generated from
    scratch as `generate_insecure` does on a miss."""
    d = tmp_path_factory.mktemp("srs")
    s, secs = Setup._generate(TAU, 16, "cpu", Setup._cache_path(str(d), TAU,
                                                                16))
    return s, secs, d


def _no_generate(monkeypatch):
    """From here on, a cache miss fails the test instead of generating."""
    def refuse(*args):
        raise AssertionError("the setup was generated, not found in a cache")
    monkeypatch.setattr(Setup, "_generate", classmethod(refuse))


def test_g1_ladder_vs_kat_and_golden():
    """KAT g1_multiples (0, 1, 2, 3, 7, 0xdeadbeef, r - 1) and scalars with
    the top bits set, in one batched ladder."""
    kat = KAT["g1_multiples"]
    keys = [int(k) for k in kat]
    rng = random.Random(23)
    extra = [(1 << 255) + rng.randrange(1 << 200), gold.R - 2,
             rng.randrange(gold.R), (1 << 254) | 1]
    ks = torch.as_tensor(FR.from_int(keys + extra))
    got = _compress_lm(G1_LM.scalar_mul(_gen(len(ks)), ks))
    assert got[:len(keys)] == [bytes.fromhex(kat[str(k)]) for k in keys]
    assert got[len(keys):] == [gold.g1_compress(gold.g1_mul(gold.G1_GEN, k))
                               for k in extra]


def test_g1_ladder_broadcasts():
    """Points (24, 3) against scalars (2, 1, 16) -> (24, 2, 3), each lane
    [k_i] P_j."""
    rng = random.Random(29)
    ps = [gold.g1_mul(gold.G1_GEN, rng.randrange(1, gold.R)) for _ in range(3)]
    pts = tg1.decompress_batch([gold.g1_compress(p) for p in ps], "cpu")[0]
    ks = [rng.randrange(gold.R), gold.R - 1]
    out = G1_LM.scalar_mul(tuple(c.movedim(-1, 0) for c in pts),
                           torch.as_tensor(FR.from_int(ks)).reshape(2, 1, 16))
    assert out[0].shape == (24, 2, 3)
    got = _compress_lm(tuple(c.reshape(24, 6) for c in out))
    assert got == [gold.g1_compress(gold.g1_mul(p, k)) for k in ks
                   for p in ps]


@pytest.mark.parametrize("n", [8, 16])
@pytest.mark.parametrize("where", ["outside", "in_domain"])
def test_lagrange_scalars_vs_jax(n, where):
    roots = get_plan(n).roots_int
    tau = TAU if where == "outside" else roots[3]
    got = _lagrange_scalars(tau, n, roots)
    assert got == jsetup._lagrange_scalars(tau, n, roots)
    if where == "in_domain":
        assert got == [int(i == 3) for i in range(n)]
    else:
        assert got == gold.GoldenSetup(tau, n).lagrange_scalars()


def test_generate_insecure_vs_committed(generated, committed):
    """Generated from scratch: the Lagrange and monomial points and [tau]_2
    equal the committed n = 16 SRS in affine form, and the lines bit
    for bit."""
    s, secs, _ = generated
    assert set(secs) == {"scalars_host", "g1_ladder", "g2_ladder", "lines",
                         "save"}
    for name in ("lagrange_g1", "monomial_g1"):
        assert _same_points(getattr(s, name), getattr(committed, name))
    assert G2.eq(s.g2_tau, committed.g2_tau).item()
    assert G2.eq(s.g2_gen, committed.g2_gen).item()
    for a, b in zip(s.lines_gen + s.lines_tau,
                    committed.lines_gen + committed.lines_tau):
        assert torch.equal(a, b)
    assert all(c.dtype == torch.int32 and c.shape == (2, 24)
               for c in s.g2_tau)


def test_generated_file_loads_in_jax(generated, monkeypatch):
    """The npz the port writes is layout v2: the JAX package's
    `Setup.load` reads it, with equal arrays."""
    s, _, d = generated
    path = Setup._cache_path(str(d), TAU, 16)
    j = jsetup.Setup.load(path)
    assert j.n == 16
    for ours, ref in ((s.lagrange_g1, j.lagrange_g1),
                      (s.monomial_g1, j.monomial_g1), (s.g2_tau, j.g2_tau),
                      (s.g2_gen, j.g2_gen), (s.lines_gen, j.lines_gen),
                      (s.lines_tau, j.lines_tau)):
        for a, r in zip(ours, ref):
            assert np.asarray(r).dtype == np.uint32
            assert np.array_equal(a.numpy(), np.asarray(r).astype(np.int32))
    # and the port reads it back as it was
    _no_generate(monkeypatch)
    again = Setup.generate_insecure(TAU, 16, cache_dir=str(d), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(again.lagrange_g1,
                                                 s.lagrange_g1))


def test_cli_gen_setup_writes_outside_the_repository(tmp_path, monkeypatch):
    """With no cache directory given, a generated setup is written to
    ~/.cache/tpukzg (and to --out), never into the repository; the next
    lookup finds it there."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.delenv("TPUKZG_CACHE_DIR", raising=False)
    repo_cache = sorted(os.listdir(os.path.join(REPO, ".srs_cache")))
    out = tmp_path / "srs4.npz"
    cli.main(["gen-setup", "--tau", "0x1234", "--n", "4", "--out", str(out),
              "--device", "cpu"])
    user = tmp_path / "home" / ".cache" / "tpukzg"
    assert os.listdir(user) == [os.path.basename(
        Setup._cache_path(str(user), 0x1234, 4))]
    assert sorted(os.listdir(os.path.join(REPO, ".srs_cache"))) == repo_cache
    ts = tt.load_setup_file(str(out), device="cpu")
    _no_generate(monkeypatch)
    again = tt.generate_insecure_setup(0x1234, 4, device="cpu")
    for a, b in zip(ts.setup.monomial_g1, again.setup.monomial_g1):
        assert torch.equal(a, b)
    assert tg1.compress_points(tuple(c[1:2] for c in ts.setup.monomial_g1)) \
        == [gold.g1_compress(gold.g1_mul(gold.G1_GEN, 0x1234))]


def test_cache_dir_from_environment_is_read_before_the_user_cache(
        tmp_path, monkeypatch, committed):
    """With TPUKZG_CACHE_DIR set, a miss there and in ~/.cache/tpukzg
    generates once and writes to ~/.cache/tpukzg only; the next call finds
    it there and generates nothing."""
    env, home = tmp_path / "env", tmp_path / "home"
    env.mkdir()
    monkeypatch.setenv("TPUKZG_CACHE_DIR", str(env))
    monkeypatch.setenv("HOME", str(home))
    made = []

    def fake(cls, tau, n, device, path):                 # no 256-step ladder
        made.append(path)
        committed.save(path)
        return committed, {}
    monkeypatch.setattr(Setup, "_generate", classmethod(fake))
    first = tt.generate_insecure_setup(0x5678, 16, device="cpu")
    user = home / ".cache" / "tpukzg"
    assert made == [Setup._cache_path(str(user), 0x5678, 16)]
    assert os.listdir(env) == []
    _no_generate(monkeypatch)
    again = tt.generate_insecure_setup(0x5678, 16, device="cpu")
    for a, b in zip(first.setup.lagrange_g1 + first.setup.lines_tau,
                    again.setup.lagrange_g1 + again.setup.lines_tau):
        assert torch.equal(a, b)


def test_from_compressed_round_trip(committed, compressed):
    ts = tt.load_trusted_setup(*compressed, device="cpu")
    s = ts.setup
    assert s.n == 16 and s.device == torch.device("cpu")
    for name in ("lagrange_g1", "monomial_g1"):
        assert _same_points(getattr(s, name), getattr(committed, name))
    assert G2.eq(s.g2_tau, committed.g2_tau).item()
    for a, b in zip(s.lines_gen + s.lines_tau,
                    committed.lines_gen + committed.lines_tau):
        assert torch.equal(a, b)


def _off_subgroup_g1():
    x = 3
    while True:
        x += 1
        y = gold.fp_sqrt((x ** 3 + 4) % gold.P)
        if y is not None and not gold.g1_in_subgroup(
                gold.g1_from_affine((x, y))):
            return tg1.compress(x, y, False)


def _off_subgroup_g2():
    """An on-curve [tau]_2 outside the subgroup, built as the JAX
    package's test builds it (x = (v, 1))."""
    v = 5
    while True:
        v += 1
        y = tg2._fp2_sqrt_ints((v ** 3 - 3 * v + 4) % gold.P,
                               (3 * v * v - 1 + 4) % gold.P)
        if y is not None and not tg2.in_subgroup_host(v, 1, *y):
            return tg2.compress(v, 1, y[0], y[1], False)


@pytest.mark.parametrize("bad", ["g2_outside_subgroup", "g2_infinity",
                                 "g1_outside_subgroup", "g1_off_curve",
                                 "g1_bad_flags", "count_mismatch"])
def test_from_compressed_rejects(compressed, bad):
    mono, lag, tau_b = list(compressed[0]), list(compressed[1]), compressed[2]
    if bad == "g2_outside_subgroup":
        tau_b = _off_subgroup_g2()
    elif bad == "g2_infinity":
        tau_b = bytes([0xC0]) + bytes(95)
    elif bad == "g1_outside_subgroup":
        lag[5] = _off_subgroup_g1()
    elif bad == "g1_off_curve":
        x = 3
        while gold.fp_sqrt((x ** 3 + 4) % gold.P) is not None:
            x += 1
        mono[2] = tg1.compress(x, 0, False)
    elif bad == "g1_bad_flags":
        mono[0] = bytes([mono[0][0] & 0x7F]) + mono[0][1:]
    else:
        lag = lag[:-1]
    with pytest.raises(ValueError):
        Setup.from_compressed(mono, lag, tau_b, device="cpu")


@pytest.mark.parametrize("chunk", [8, 32])
def test_msm_chunked_vs_golden(committed, chunk):
    """12 SRS points (8 monomial [tau^i] G, 4 Lagrange) with seeded
    scalars; chunks of 8 leave a ragged pad of 4 zero scalars, 32 is the
    one-chunk path.  The result is [sum k_i d_i] G for the points' known
    logs d_i."""
    rng = random.Random(31)
    logs = [pow(TAU, i, gold.R) for i in range(8)]
    logs += jsetup._lagrange_scalars(TAU, 16, get_plan(16).roots_int)[:4]
    ks = [rng.randrange(gold.R) for _ in range(12)]
    ks[3] = 0
    pts = tuple(torch.cat([a[:8], b[:4]]) for a, b in zip(
        committed.monomial_g1, committed.lagrange_g1))
    got = msm(pts, torch.as_tensor(FR.from_int(ks)), point_chunk=chunk)
    s = sum(k * d for k, d in zip(ks, logs)) % gold.R
    assert tg1.compress_points(tuple(c[None] for c in got)) == \
        [gold.g1_compress(gold.g1_mul(gold.G1_GEN, s))]


def test_from_compressed_without_validation(compressed):
    """validate=False skips both subgroup checks (the caller trusts the
    file); the encodings and the curve are still checked."""
    mono, lag, _ = list(compressed[0]), list(compressed[1]), compressed[2]
    lag[5] = _off_subgroup_g1()
    s = Setup.from_compressed(mono, lag, _off_subgroup_g2(), validate=False,
                              device="cpu")
    assert tg1.compress_points(tuple(c[5:6] for c in s.lagrange_g1)) == \
        [lag[5]]
    mono[0] = bytes([mono[0][0] & 0x7F]) + mono[0][1:]
    with pytest.raises(ValueError):
        Setup.from_compressed(mono, lag, compressed[2], validate=False,
                              device="cpu")
