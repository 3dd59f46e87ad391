"""The statistics the end-to-end metrics are made of."""

from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The nearest-rank q-th percentile (0 < q <= 100) of all values."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100.0 * len(v)) - 1)]
