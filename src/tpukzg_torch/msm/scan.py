"""Segmented and suffix EC-sum scans, ``loop`` mode (counterpart of
``tpukzg/msm/scan.py:82-95, 122-135``): Hillis-Steele over the lane
axis, one full-width complete add per step.  These are the plain
versions of the bucket-scan kernel (``kernels/bucket.py``).
"""

from __future__ import annotations

import math

import torch


def _ceil_log2(n: int) -> int:
    return max(1, math.ceil(math.log2(max(n, 2))))


def seg_scan(curve, pts, seg):
    """Inclusive segmented scan: pts (X, Y, Z) of (L, g, n); seg (g, n)
    sorted segment ids (equal ids contiguous)."""
    n = seg.shape[-1]
    pos = torch.arange(n, device=seg.device)
    cur = tuple(pts)
    for j in range(_ceil_log2(n)):
        d = 1 << j
        shifted = tuple(torch.roll(c, d, dims=2) for c in cur)
        valid = (pos >= d) & (seg == torch.roll(seg, d, dims=1))
        cur = curve.select(valid, curve.add(cur, shifted), cur)
    return cur


def suffix_scan(curve, pts):
    """Inclusive suffix scan out[i] = sum_{j >= i} pts[j] along the last
    axis of (L, g, n) coords."""
    rev = tuple(torch.flip(c, dims=[2]) for c in pts)
    n = rev[0].shape[-1]
    pos = torch.arange(n, device=rev[0].device)
    cur = rev
    for j in range(_ceil_log2(n)):
        d = 1 << j
        shifted = tuple(torch.roll(c, d, dims=2) for c in cur)
        valid = (pos >= d).expand(rev[0].shape[1:])
        cur = curve.select(valid, curve.add(cur, shifted), cur)
    return tuple(torch.flip(c, dims=[2]) for c in cur)
