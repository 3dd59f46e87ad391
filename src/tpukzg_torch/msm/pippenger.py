"""The generic Pippenger MSM over any curve in the trailing layout
(counterpart of ``tpukzg/msm/pippenger.py``): G2, and G1 as ``curve/
g1.py``'s ``G1``.

For each window: the points permuted into digit order (one stable
sort), an inclusive segmented EC-sum scan over the sorted digits
(``msm/scan.py:seg_scan_axis``), each bucket's total gathered from its
segment's last slot, sum_b b S_b by a suffix scan over the buckets and a
tree sum, then a Horner fold R = [2^c] R + R_w over the windows, most
significant first.  Windows run in chunks of `_chunk` rows.

This is tensor code over the curve's ops: the JAX package has no kernel
for G2 either (its Pallas scan takes limb-major G1 only,
``msm/scan.py:46-53``).  Over ``G1`` the adds and doubling runs are the
EC kernels; the G1 MSMs of the library run ``msm/pippenger_lm.py``.
"""

from __future__ import annotations

import torch

from tpukzg_torch.msm.pippenger_lm import _digits, default_window
from tpukzg_torch.msm.scan import seg_scan_axis, suffix_scan_axis


def _bucket_totals(curve, scanned, sorted_digits, c: int):
    """The last slot of each digit segment -> bucket sums S_1..S_{B-1}.
    scanned: coords (g, n, *sfx); sorted_digits (g, n) -> coords
    (g, B-1, *sfx)."""
    g, n = sorted_digits.shape
    vals = torch.arange(1, 1 << c, dtype=sorted_digits.dtype,
                        device=sorted_digits.device).expand(g, (1 << c) - 1)
    pos = torch.searchsorted(sorted_digits.contiguous(), vals.contiguous(),
                           right=True)
    last = (pos - 1).clamp(0, n - 1)
    hit = (torch.gather(sorted_digits, 1, last) == vals) & (pos > 0)
    sfx = tuple(scanned[0].shape[2:])
    idx = last.reshape(last.shape + (1,) * len(sfx)).expand(last.shape + sfx)
    picked = tuple(torch.gather(c_, 1, idx) for c_ in scanned)
    return curve.select(hit, picked, curve.inf(tuple(hit.shape), hit.device))


def _window_sums(curve, buckets):
    """sum_b b S_b: coords (g, B-1, *sfx) -> (g, *sfx)."""
    suffix = suffix_scan_axis(curve.add, curve.select, buckets, coord_axis=1,
                              batch_shape=tuple(buckets[0].shape[:2]),
                              scan_axis_in_batch=1)
    return curve.reduce_sum(suffix, axis=1)


class Pippenger:
    """The MSM engine of one curve (``CurveOps``)."""

    def __init__(self, curve, window: int | None = None,
                 window_chunk: int | None = None,
                 chunk_budget_bytes: int = 1 << 28):
        self.curve = curve
        self.window = window
        self.window_chunk = window_chunk      # None -> from the budget
        self.chunk_budget_bytes = chunk_budget_bytes

    def _chunk(self, n: int, W: int) -> int:
        """Windows a chunk takes: `window_chunk`, else as many as the
        byte budget holds, at least one."""
        if self.window_chunk is not None:
            return min(self.window_chunk, W)
        per_window = n * 3 * 24 * 4 * 3
        return max(1, min(W, self.chunk_budget_bytes // max(per_window, 1)))

    def msm(self, points, scalars, c: int | None = None):
        """sum_i [k_i] P_i: points (X, Y, Z) with a leading axis of n;
        scalars (n, 16) canonical Fr limbs on the points' device."""
        n = scalars.shape[0]
        if c is None:
            c = self.window or default_window(n)
        return self._msm(points, scalars, c=c)

    def _msm_grouped(self, points, scalars, *, groups, c: int):
        """One MSM for each consecutive slice of `groups` points."""
        out, start = [], 0
        for g in groups:
            out.append(self._msm(tuple(c_[start:start + g] for c_ in points),
                                 scalars[start:start + g], c=c))
            start += g
        return tuple(out)

    def _msm(self, points, scalars, *, c: int):
        curve = self.curve
        dev = scalars.device
        if scalars.shape[0] == 0:
            return curve.inf((), dev)
        digits = _digits(scalars, c)                     # (W, n)
        W, n = digits.shape
        g = self._chunk(n, W)
        wres = []
        for w0 in range(0, W, g):
            sorted_dg, perm = torch.sort(digits[w0:w0 + g], dim=1,
                                         stable=True)
            pts = tuple(c_[perm] for c_ in points)        # (g, n, *sfx)
            scanned = seg_scan_axis(curve.add, curve.select, pts, sorted_dg,
                                    coord_axis=1, seg_axis=1)
            wres.append(_window_sums(curve, _bucket_totals(
                curve, scanned, sorted_dg, c)))           # (g, *sfx)
        wres = tuple(torch.cat([w[i] for w in wres]) for i in range(3))
        acc = curve.inf((), dev)
        for i in range(W):
            acc = curve.double_n(acc, c if i else 0)
            acc = curve.add(acc, tuple(c_[W - 1 - i] for c_ in wres))
        return acc
