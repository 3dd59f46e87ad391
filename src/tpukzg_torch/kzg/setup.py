"""SRS / trusted setup (counterpart of ``tpukzg/kzg/setup.py``).

A `Setup` holds, on one torch device, the Lagrange and monomial G1
points ((n, 24) int32 Montgomery coords), the two G2 points [1]_2 and
[tau]_2 ((2, 24) coords each) and their precomputed Miller lines
((63, 3, 2, 24) each), so a verify touches no G2 arithmetic.

Three ways to make one:
- `load` / `from_numpy`: a layout-v2 npz (the JAX package's format;
  `save` writes it), or a layout-v1 one, whose lines are computed;
- `generate_insecure(tau, n)`: the cached dev SRS of (tau, n), made on
  a cache miss by ONE batched G1 ladder over the 2n scalars, a G2
  ladder and the lines — INSECURE, tau is known;
- `from_compressed`: c-kzg-4844-shaped compressed points, validated.

Cache lookup: an explicit `cache_dir`; else TPUKZG_CACHE_DIR, then
~/.cache/tpukzg; else the repository's committed `.srs_cache/`, then
~/.cache/tpukzg.  A generated setup is written only to the explicit
`cache_dir` or to ~/.cache/tpukzg, never into the repository, so the
lookup always ends where the write goes.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from tpukzg_torch.curve import g1 as g1m, g2 as g2m
from tpukzg_torch.curve.g2 import G2
from tpukzg_torch.curve.weierstrass_lm import G1_LM
from tpukzg_torch.field.mont import FR, R_MOD, resolve_device
from tpukzg_torch.ntt.ntt import NttPlan, get_plan
from tpukzg_torch.pairing.lines import precompute_lines

_LAYOUT_VERSION = 2
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
_REPO_CACHE = os.path.join(_REPO, ".srs_cache")


def _user_cache() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache", "tpukzg")


def _lagrange_scalars(tau: int, n: int, roots) -> list[int]:
    """[L_i(tau)] over Fr for a known tau (golden/model.py:853); a tau
    in the domain gives the one-hot row."""
    if tau % R_MOD in roots:
        return [1 if r == tau % R_MOD else 0 for r in roots]
    zn = (pow(tau, n, R_MOD) - 1) % R_MOD
    ninv = pow(n, -1, R_MOD)
    return [zn * ninv % R_MOD * roots[i] % R_MOD
            * pow((tau - roots[i]) % R_MOD, -1, R_MOD) % R_MOD
            for i in range(n)]


def _gen_multiples(scalars, device):
    """[k_i] G1 for a list of scalars: one batched ladder (B2 adds on the
    card) -> (X, Y, Z) of (len, 24)."""
    ks = torch.as_tensor(FR.from_int(list(scalars)), device=device)
    gen = tuple(torch.as_tensor(c, device=device)[:, None]
                for c in g1m.GEN_NP)                       # (24, 1)
    pts = G1_LM.scalar_mul(gen, ks)                         # (24, len)
    return tuple(c.movedim(0, -1).contiguous() for c in pts)


class Setup:
    def __init__(self, n: int, lagrange_g1, monomial_g1, g2_gen, g2_tau,
                 lines_gen=None, lines_tau=None, device=None):
        assert n & (n - 1) == 0
        dev = resolve_device(device)

        def t(a):
            if torch.is_tensor(a):
                return a.to(device=dev, dtype=torch.int32)
            return torch.as_tensor(np.asarray(a).astype(np.int32),
                                   device=dev)

        self.n = n
        self.device = dev
        self.plan: NttPlan = get_plan(n)
        self.lagrange_g1 = tuple(t(c) for c in lagrange_g1)
        self.monomial_g1 = tuple(t(c) for c in monomial_g1)
        self.g2_gen = tuple(t(c) for c in g2_gen)
        self.g2_tau = tuple(t(c) for c in g2_tau)
        if lines_gen is None or lines_tau is None:
            # both points' lines in one batched pass
            both = tuple(torch.stack([a, b])
                         for a, b in zip(self.g2_gen, self.g2_tau))
            d, a = precompute_lines(both)
            lines_gen = (d[0], a[0]) if lines_gen is None else lines_gen
            lines_tau = (d[1], a[1]) if lines_tau is None else lines_tau
        self.lines_gen = tuple(t(c) for c in lines_gen)   # (dbl, add)
        self.lines_tau = tuple(t(c) for c in lines_tau)

    # -- npz (layout v2) -------------------------------------------------

    @classmethod
    def from_numpy(cls, arrays: dict, device=None):
        """Build from the JAX package's setup arrays (uint32 numpy):
        lag_i / mono_i (n, 24), g2g_i / g2t_i (2, 24), lng_i / lnt_i
        (63, 3, 2, 24); a layout-v1 file has no lines."""
        n = int(np.asarray(arrays["lag_0"]).shape[0])
        pts = {name: tuple(arrays[f"{name}_{i}"] for i in range(3))
               for name in ("lag", "mono", "g2g", "g2t")}
        # layout v1 has no lines: __init__ computes them
        lines = {name: tuple(arrays[f"{name}_{i}"] for i in range(2))
                 if f"{name}_0" in arrays else None
                 for name in ("lng", "lnt")}
        return cls(n, pts["lag"], pts["mono"], pts["g2g"], pts["g2t"],
                   lines["lng"], lines["lnt"], device=device)

    @classmethod
    def load(cls, path: str, device=None):
        with np.load(path) as z:
            return cls.from_numpy({k: z[k] for k in z.files}, device)

    def save(self, path: str) -> None:
        """Write layout v2: uint32 arrays of 16-bit limbs, the JAX
        package's `Setup.load` format."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        arrs = {"n": np.asarray(self.n)}
        for name, pt in (("lag", self.lagrange_g1), ("mono", self.monomial_g1),
                         ("g2g", self.g2_gen), ("g2t", self.g2_tau),
                         ("lng", self.lines_gen), ("lnt", self.lines_tau)):
            for i, c in enumerate(pt):
                arrs[f"{name}_{i}"] = c.cpu().numpy().astype(np.uint32)
        tmp = path + ".tmp.npz"
        np.savez_compressed(tmp, **arrs)
        os.replace(tmp, path)

    # -- insecure dev setup ------------------------------------------------

    @staticmethod
    def _cache_path(cache_dir: str, tau: int, n: int) -> str:
        key = hashlib.sha256(
            f"v{_LAYOUT_VERSION}:{tau % R_MOD}:{n}".encode()).hexdigest()[:16]
        return os.path.join(cache_dir, f"srs_{n}_{key}.npz")

    @classmethod
    def generate_insecure(cls, tau: int, n: int, cache_dir: str | None = None,
                          device=None):
        """The dev SRS of (tau, n), INSECURE: from the first cache that
        holds it, else generated on `device` and written to `cache_dir`
        (or ~/.cache/tpukzg when none is given; best effort)."""
        if cache_dir is not None:
            lookup = [cache_dir]
        elif os.environ.get("TPUKZG_CACHE_DIR"):
            lookup = [os.environ["TPUKZG_CACHE_DIR"], _user_cache()]
        else:
            lookup = [_REPO_CACHE, _user_cache()]
        for d in lookup:
            path = cls._cache_path(d, tau, n)
            if os.path.exists(path):
                return cls.load(path, device)
        # the last place looked is the one a generated setup is written to
        return cls._generate(tau, n, device, path)[0]

    @classmethod
    def _generate(cls, tau: int, n: int, device, path: str):
        """Generate the dev SRS of (tau, n) on `device` and write it to
        `path` (best effort) -> (setup, seconds of each step)."""
        dev = resolve_device(device)
        secs = {}

        def mark(name, t0):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t = time.perf_counter()
            secs[name] = t - t0
            return t

        t = time.perf_counter()
        plan = get_plan(n)
        tau = tau % R_MOD
        scalars = ([pow(tau, i, R_MOD) for i in range(n)]
                   + _lagrange_scalars(tau, n, plan.roots_int))
        t = mark("scalars_host", t)
        pts = _gen_multiples(scalars, dev)                 # mono, then lag
        mono = tuple(c[:n] for c in pts)
        lag = tuple(c[n:] for c in pts)
        t = mark("g1_ladder", t)
        g2_gen = G2.gen((), dev)
        g2_tau = G2.scalar_mul(g2_gen, torch.as_tensor(FR.from_int(tau),
                                                       device=dev))
        t = mark("g2_ladder", t)
        setup = cls(n, lag, mono, g2_gen, g2_tau, device=dev)
        t = mark("lines", t)
        try:
            setup.save(path)
        except OSError:
            pass                                  # the cache is best effort
        mark("save", t)
        return setup, secs

    # -- c-kzg-4844-shaped loader -----------------------------------------

    @classmethod
    def from_compressed(cls, g1_monomial_bytes, g1_lagrange_bytes,
                        g2_tau_bytes: bytes, validate: bool = True,
                        device=None):
        """A setup from compressed points (the shape of c-kzg-4844's
        `load_trusted_setup`).  Raises ValueError on a malformed encoding
        or a G1 x off the curve; with `validate`, also when [tau]_2 fails
        the psi check (host integers) or a G1 point is outside G1 (one
        batched GLV check on the device)."""
        dev = resolve_device(device)
        n = len(g1_lagrange_bytes)
        if len(g1_monomial_bytes) != n or n == 0 or n & (n - 1):
            raise ValueError("the setup needs 2^k monomial and as many "
                             "Lagrange points")
        x0, x1, y0, y1, tau_inf = g2m.decompress(g2_tau_bytes)
        if validate and (tau_inf or not g2m.in_subgroup_host(x0, x1, y0,
                                                             y1)):
            raise ValueError("[tau]_2 not in the G2 subgroup")
        x_l, sign, inf = g1m.parse_compressed(list(g1_monomial_bytes)
                                              + list(g1_lagrange_bytes))
        pts, ok_curve = g1m._decompress_sqrt(
            torch.as_tensor(x_l, device=dev), torch.as_tensor(sign, device=dev),
            torch.as_tensor(inf, device=dev))
        if not bool((ok_curve | torch.as_tensor(inf, device=dev)).all()):
            raise ValueError("G1 x not on curve")
        if validate and not bool(g1m.in_subgroup_fast(pts).all()):
            raise ValueError("G1 SRS point not in subgroup")
        mono = tuple(c[:n] for c in pts)
        lag = tuple(c[n:] for c in pts)
        g2_tau = g2m.point_from_ints(x0, x1, y0, y1, tau_inf)
        return cls(n, lag, mono, G2.gen((), dev), g2_tau, device=dev)
