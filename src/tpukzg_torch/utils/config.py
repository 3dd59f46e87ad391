"""Frozen config dataclasses read from ``TPUKZG_*`` environment variables
(counterpart of ``tpukzg/utils/config.py``).

Only the knobs that mean something on the port are here: the blob degree
and the subgroup check of deserialized points (`KzgConfig`), the
Pippenger window and chunk (`MsmConfig`) and the four-step NTT's split
(`NttConfig`).  The JAX package's XLA lowering knobs (``FieldConfig``,
``ScanConfig``, ``FieldImplConfig``, ``NttConfig.impl``) have no
counterpart here.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass


def _env(name: str, default, cast=int):
    v = os.environ.get(f"TPUKZG_{name}")
    return default if v is None else cast(v)


@dataclass(frozen=True)
class MsmConfig:
    """Pippenger tuning: `window` is the public MSM's c (None: the
    default window of n); `window_chunk` the rows of sorted digits a
    bucket-scan chunk takes (None: a 2^28-byte budget)."""
    window: int | None = None
    window_chunk: int | None = None
    bucket_algo: str = "sort"

    @classmethod
    def from_env(cls):
        return cls(window=_env("MSM_WINDOW", None),
                   window_chunk=_env("MSM_WINDOW_CHUNK", None),
                   bucket_algo=os.environ.get("TPUKZG_MSM_BUCKET_ALGO", "sort"))


@dataclass(frozen=True)
class NttConfig:
    """`four_step_rows`: n1 of the distributed NTT's (n1, n2) split
    (None: 2^floor(log2(n) / 2))."""
    four_step_rows: int | None = None

    @classmethod
    def from_env(cls):
        return cls(four_step_rows=_env("NTT_ROWS", None))


@dataclass(frozen=True)
class KzgConfig:
    degree: int = 4096                 # blob size n
    check_subgroup: bool = True        # validate deserialized points

    @classmethod
    def from_env(cls):
        return cls(degree=_env("DEGREE", 4096),
                   check_subgroup=_env("CHECK_SUBGROUP", 1) == 1)


def as_json_dict(*cfgs) -> dict:
    out = {}
    for c in cfgs:
        out[type(c).__name__] = dataclasses.asdict(c)
    return out
