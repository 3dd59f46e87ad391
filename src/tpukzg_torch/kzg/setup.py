"""SRS / trusted setup (counterpart of ``tpukzg/kzg/setup.py``).

A `Setup` holds, on an explicit torch device, the Lagrange and monomial
G1 points ((n, 24) int32 Montgomery coords) and the precomputed Miller
lines of [1]_2 and [tau]_2 ((63, 3, 2, 24) each), read from the layout-v2
npz files the JAX package writes.  Generating an SRS (G2 arithmetic)
is not part of this package: `generate_insecure` only finds the cached
file of (tau, n) and raises when it is missing.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from tpukzg_torch.field.mont import R_MOD, resolve_device
from tpukzg_torch.ntt.ntt import NttPlan, get_plan

_LAYOUT_VERSION = 2
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


class Setup:
    def __init__(self, n: int, lagrange_g1, monomial_g1, g2_gen, g2_tau,
                 lines_gen, lines_tau, device):
        assert n & (n - 1) == 0
        self.n = n
        self.device = torch.device(device)
        self.plan: NttPlan = get_plan(n)
        self.lagrange_g1 = lagrange_g1
        self.monomial_g1 = monomial_g1
        self.g2_gen = g2_gen
        self.g2_tau = g2_tau
        self.lines_gen = lines_gen          # (dbl_lines, add_lines)
        self.lines_tau = lines_tau

    @classmethod
    def from_numpy(cls, arrays: dict, device=None):
        """Build from the JAX package's setup arrays (uint32 numpy):
        lag_i / mono_i (n, 24), g2g_i / g2t_i (2, 24), lng_i / lnt_i
        (63, 3, 2, 24)."""
        dev = resolve_device(device)

        def t(a):
            return torch.as_tensor(np.asarray(a).astype(np.int32), device=dev)

        n = int(np.asarray(arrays["lag_0"]).shape[0])
        pts = {name: tuple(t(arrays[f"{name}_{i}"]) for i in range(3))
               for name in ("lag", "mono")}
        g2 = {name: tuple(np.asarray(arrays[f"{name}_{i}"]).astype(np.int32)
                          for i in range(3)) for name in ("g2g", "g2t")}
        lines = {}
        for name in ("lng", "lnt"):
            if f"{name}_0" not in arrays:
                raise ValueError("SRS file has no Miller lines (layout v1): "
                                 "regenerate it with the JAX package")
            lines[name] = tuple(t(arrays[f"{name}_{i}"]) for i in range(2))
        return cls(n, pts["lag"], pts["mono"], g2["g2g"], g2["g2t"],
                   lines["lng"], lines["lnt"], dev)

    @classmethod
    def load(cls, path: str, device=None):
        with np.load(path) as z:
            return cls.from_numpy({k: z[k] for k in z.files}, device)

    @staticmethod
    def _cache_path(cache_dir: str, tau: int, n: int) -> str:
        key = hashlib.sha256(
            f"v{_LAYOUT_VERSION}:{tau % R_MOD}:{n}".encode()).hexdigest()[:16]
        return os.path.join(cache_dir, f"srs_{n}_{key}.npz")

    @classmethod
    def generate_insecure(cls, tau: int, n: int, cache_dir: str | None = None,
                          device=None):
        """The dev SRS of (tau, n) from its cache file (the repository's
        committed `.srs_cache/` unless TPUKZG_CACHE_DIR says otherwise)."""
        if cache_dir is None:
            cache_dir = os.environ.get("TPUKZG_CACHE_DIR",
                                       os.path.join(_REPO, ".srs_cache"))
        path = cls._cache_path(cache_dir, tau, n)
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no cached SRS for n={n} at {path}; generating one needs G2 "
                "arithmetic, which this package does not have yet")
        return cls.load(path, device)
