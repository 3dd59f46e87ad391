"""Grouped Pippenger MSM in the limb-major layout (counterpart of
``tpukzg/msm/pippenger.py:36-58`` and ``msm/pippenger_lm.py:53-174``).

Sort-by-digit, then the segmented bucket scan (kernel B3 on the card),
one gather of each bucket's last lane, the suffix scan over buckets
(B3 again), a tree sum over buckets, and the Horner fold over windows.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.curve.weierstrass_lm import G1_LM, CurveLM
from tpukzg_torch.kernels import bucket


def default_window(n: int) -> int:
    if n <= 32:
        return 4
    ln = max(int(np.log2(n)), 1)
    return int(min(16, max(4, ln - max(int(np.log2(ln)), 1) + 2)))


def _digits(scalars, c: int):
    """(..., 16) canonical 16-bit limbs -> (W, ...) int32 window digits."""
    W = -(-256 // c)
    starts = np.arange(W) * c
    limb_idx = torch.as_tensor(starts // 16, device=scalars.device)
    sh = torch.as_tensor(starts % 16, device=scalars.device)
    padded = torch.nn.functional.pad(scalars.to(torch.int64), (0, 2))
    lo = padded[..., limb_idx]
    hi = padded[..., limb_idx + 1]
    d = (lo >> sh) | torch.where(sh > 0, hi << (16 - sh), 0)
    d = d & ((1 << c) - 1)
    return d.movedim(-1, 0).to(torch.int32)


def _bucket_totals(curve, scanned, sorted_dg, c: int):
    """Last lane of each digit segment -> bucket sums S_1..S_{B-1}:
    coords (L, g, B-1)."""
    g, n = sorted_dg.shape
    vals = torch.arange(1, 1 << c, dtype=sorted_dg.dtype,
                        device=sorted_dg.device).expand(g, (1 << c) - 1)
    pos = torch.searchsorted(sorted_dg, vals.contiguous(), right=True)
    last = (pos - 1).clamp(0, n - 1)
    hit = (torch.gather(sorted_dg, 1, last) == vals) & (pos > 0)
    idx = last.unsqueeze(0).expand(scanned[0].shape[0], g, last.shape[1])
    picked = tuple(torch.gather(c_, 2, idx) for c_ in scanned)
    return curve.select(hit, picked, curve.inf(tuple(hit.shape),
                                                hit.device))


def _window_sums(curve, buckets):
    """sum_b b * S_b: suffix scan over the bucket axis, then a tree sum."""
    suffix = bucket.suffix_scan(buckets)
    return curve.reduce_sum_lanes(suffix, axis=1)


def _chunk(n: int, rows: int, budget: int = 1 << 28) -> int:
    per_row = n * 3 * 24 * 4 * 3
    return max(1, min(rows, budget // max(per_row, 1)))


def msm_grouped(points, scalars, groups, c: int, curve: CurveLM = G1_LM):
    """G independent MSMs over consecutive slices of the point axis.

    points: (X, Y, Z) of (n_total, 24); scalars (n_total, 16) canonical;
    groups: slice lengths summing to n_total.  Returns G points, each an
    (X, Y, Z) tuple of (24,) tensors.  Pads are zero scalars -> digit 0,
    which no bucket picks."""
    G = len(groups)
    nmax = max(groups)
    dev = scalars.device
    pts_g, scal_g, start = [], [], 0
    for g in groups:
        pts_g.append(tuple(torch.nn.functional.pad(
            c_[start:start + g], (0, 0, 0, nmax - g)) for c_ in points))
        scal_g.append(torch.nn.functional.pad(
            scalars[start:start + g], (0, 0, 0, nmax - g)))
        start += g
    pts_flat = tuple(torch.cat([p[i].movedim(-1, 0) for p in pts_g], -1)
                     for i in range(3))                      # (L, G*nmax)
    scal = torch.stack(scal_g)                               # (G, nmax, 16)
    digits = _digits(scal.reshape(G * nmax, 16), c)          # (W, G*nmax)
    W = digits.shape[0]
    rows = digits.reshape(W * G, nmax)
    offs = (torch.arange(W * G, device=dev, dtype=torch.int64) % G) * nmax
    gch = _chunk(nmax, W * G)
    wres = []
    for r0 in range(0, W * G, gch):
        dg = rows[r0:r0 + gch]
        sorted_dg, perm = torch.sort(dg, dim=1, stable=True)
        flat_idx = perm + offs[r0:r0 + gch, None]
        pts = tuple(c_[:, flat_idx] for c_ in pts_flat)      # (L, gch, nmax)
        scanned = bucket.seg_scan(pts, sorted_dg)
        buckets = _bucket_totals(curve, scanned, sorted_dg, c)
        wres.append(_window_sums(curve, buckets))            # (L, gch)
    wres = tuple(torch.cat([w[i] for w in wres], -1).reshape(-1, W, G)
                 for i in range(3))                          # (L, W, G)
    acc = curve.inf((G,), dev)
    for i in range(W):
        for _ in range(c if i else 0):     # doubling infinity returns it
            acc = curve.double(acc)
        acc = curve.add(acc, tuple(c_[:, W - 1 - i] for c_ in wres))
    return [tuple(c_[:, i] for c_ in acc) for i in range(G)]
