"""Segmented and suffix EC-sum scans, ``loop`` mode (counterpart of
``tpukzg/msm/scan.py:82-95, 122-135``): Hillis-Steele over the lane
axis, one full-width complete add per step.  `seg_scan_axis` and
`suffix_scan_axis` take any curve's coords with the scan axis named
(the trailing layout of the generic Pippenger, G2 among them);
`seg_scan` and `suffix_scan` are their limb-major G1 forms, the plain
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
    return seg_scan_axis(curve.add, curve.select, pts, seg, coord_axis=2,
                         seg_axis=1)


def suffix_scan(curve, pts):
    """Inclusive suffix scan out[i] = sum_{j >= i} pts[j] along the last
    axis of (L, g, n) coords."""
    return suffix_scan_axis(curve.add, curve.select, pts, coord_axis=2,
                            batch_shape=pts[0].shape[1:],
                            scan_axis_in_batch=1)


def seg_scan_axis(add_fn, select_fn, pts, seg, *, coord_axis: int,
                  seg_axis: int):
    """Inclusive segmented scan along `coord_axis` of each coord of pts;
    seg holds sorted segment ids along `seg_axis`, and select_fn(mask,
    a, b) broadcasts a seg-shaped mask over the coords."""
    n = seg.shape[seg_axis]
    shape = [1] * seg.dim()
    shape[seg_axis] = n
    pos = torch.arange(n, device=seg.device).reshape(shape)
    cur = tuple(pts)
    for j in range(_ceil_log2(n)):
        d = 1 << j
        shifted = tuple(torch.roll(c, d, dims=coord_axis) for c in cur)
        valid = (pos >= d) & (seg == torch.roll(seg, d, dims=seg_axis))
        cur = select_fn(valid, add_fn(cur, shifted), cur)
    return cur


def suffix_scan_axis(add_fn, select_fn, pts, *, coord_axis: int,
                     batch_shape, scan_axis_in_batch: int):
    """Inclusive suffix scan out[i] = sum_{j >= i} along `coord_axis`;
    batch_shape is the coords' batch shape (what select_fn masks over),
    scan_axis_in_batch the scan axis's place in it."""
    rev = tuple(torch.flip(c, dims=[coord_axis]) for c in pts)
    n = batch_shape[scan_axis_in_batch]
    shape = [1] * len(batch_shape)
    shape[scan_axis_in_batch] = n
    pos = torch.arange(n, device=rev[0].device).reshape(shape)
    cur = rev
    for j in range(_ceil_log2(n)):
        d = 1 << j
        shifted = tuple(torch.roll(c, d, dims=coord_axis) for c in cur)
        valid = (pos >= d).expand(tuple(batch_shape))
        cur = select_fn(valid, add_fn(cur, shifted), cur)
    return tuple(torch.flip(c, dims=[coord_axis]) for c in cur)
