"""Pippenger MSMs in the limb-major layout (counterpart of
``tpukzg/msm/pippenger.py:36-58`` and ``msm/pippenger_lm.py``).

Sort-by-digit, then the segmented bucket scan (kernel B3 on the card),
one gather of each bucket's last lane, the suffix scan over buckets
(B3 again) and a tree sum over buckets.  The grouped MSM (batch verify)
then folds its windows by Horner; the fixed-base MSM (commit, open) has
them folded into a table of [2^(c w)] P_i, so one sorted row of W n keys
per MSM needs no doublings at all.  The public `msm` cuts a long point
list into chunks of `POINT_CHUNK` points, runs them as the groups of one
grouped MSM and adds the partial results.  `msm_batch` runs k MSMs over
one shared point list as W k rows of sorted digits and one Horner fold
over k lanes.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.curve.weierstrass_lm import G1_LM, CurveLM
from tpukzg_torch.field.mont import upload
from tpukzg_torch.kernels import bucket
from tpukzg_torch.utils.config import MsmConfig


def default_window(n: int) -> int:
    if n <= 32:
        return 4
    ln = max(int(np.log2(n)), 1)
    return int(min(16, max(4, ln - max(int(np.log2(ln)), 1) + 2)))


def _digits(scalars, c: int):
    """(..., 16) canonical 16-bit limbs -> (W, ...) int32 window digits."""
    W = -(-256 // c)
    starts = np.arange(W) * c
    limb_idx = upload(starts // 16, scalars.device)
    sh = upload(starts % 16, scalars.device)
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
    """Rows of n sorted digits a bucket-scan chunk takes: MsmConfig's
    window_chunk, else as many as `budget` bytes hold."""
    fixed = MsmConfig.from_env().window_chunk
    if fixed is not None:
        return min(fixed, rows)
    per_row = n * 3 * 24 * 4 * 3
    return max(1, min(rows, budget // max(per_row, 1)))


def _window_rows(pts_flat, rows, offs, c: int, curve: CurveLM):
    """The window sums of R rows of n digits: each row sorts its digits
    and scans the points pts_flat[:, offs[r] + perm] (offs None: 0) by
    bucket, in chunks of rows -> coords (L, R)."""
    R, n = rows.shape
    gch = _chunk(n, R)
    wres = []
    for r0 in range(0, R, gch):
        sorted_dg, perm = torch.sort(rows[r0:r0 + gch], dim=1, stable=True)
        idx = perm if offs is None else perm + offs[r0:r0 + gch, None]
        pts = tuple(c_[:, idx] for c_ in pts_flat)           # (L, gch, n)
        scanned = bucket.seg_scan(pts, sorted_dg)
        buckets = _bucket_totals(curve, scanned, sorted_dg, c)
        wres.append(_window_sums(curve, buckets))            # (L, gch)
    return tuple(torch.cat([w[i] for w in wres], -1) for i in range(3))


def _horner(wres, c: int, curve: CurveLM):
    """Window sums, coords (L, W, G) -> coords (L, G): R = [2^c] R + R_w,
    most significant window first; each run of c doublings is one
    launch."""
    W, G = wres[0].shape[1:]
    acc = curve.inf((G,), wres[0].device)
    for i in range(W):
        acc = curve.double_n(acc, c if i else 0)
        acc = curve.add(acc, tuple(c_[:, W - 1 - i] for c_ in wres))
    return acc


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
    offs = (torch.arange(W * G, device=dev, dtype=torch.int64) % G) * nmax
    wres = _window_rows(pts_flat, digits.reshape(W * G, nmax), offs, c,
                        curve)
    acc = _horner(tuple(w.reshape(-1, W, G) for w in wres), c, curve)
    return [tuple(c_[:, i] for c_ in acc) for i in range(G)]


def msm_batch(points, scalars, c: int | None = None,
              curve: CurveLM = G1_LM):
    """k MSMs over one shared point list (``pippenger_lm.py:279-329``):
    points (X, Y, Z) of (n, 24); scalars (k, n, 16) canonical -> (X, Y,
    Z) of (k, 24).  The W k rows of n digits (window-major) go through
    one chunked sort and bucket scan, and one Horner fold runs over the
    k lanes.  c defaults to MsmConfig's window, else the window of n."""
    k, n = scalars.shape[:2]
    if any(p.shape[0] != n for p in points):
        raise ValueError(f"msm_batch: {n} scalars a row for "
                         f"{points[0].shape[0]} points")
    if k == 0:
        return tuple(p.new_zeros((0, p.shape[1])) for p in points)
    if c is None:
        c = MsmConfig.from_env().window or default_window(n)
    pts = tuple(p.movedim(-1, 0).contiguous() for p in points)   # (L, n)
    digits = _digits(scalars, c)                                 # (W, k, n)
    W = digits.shape[0]
    wres = _window_rows(pts, digits.reshape(W * k, n), None, c, curve)
    acc = _horner(tuple(w.reshape(-1, W, k) for w in wres), c, curve)
    return tuple(a.movedim(0, -1) for a in acc)


def build_fixed_table(points, c: int, curve: CurveLM = G1_LM):
    """points (X, Y, Z) of (n, 24) -> coords (24, W, n) with
    table[:, w] = [2^(c w)] P_i: W - 1 runs of c doublings (one launch
    each), built once per SRS basis (28.3 MB at n = 4096, c = 11)."""
    W = -(-256 // c)
    cur = tuple(p.movedim(-1, 0).contiguous() for p in points)   # (24, n)
    tabs = [cur]
    for _ in range(W - 1):
        cur = curve.double_n(cur, c)
        tabs.append(cur)
    return tuple(torch.stack([t[i] for t in tabs], 1) for i in range(3))


def msm_fixed(table, scalars, c: int, curve: CurveLM = G1_LM):
    """k MSMs against one fixed-base table: scalars (k, n, 16) canonical
    -> (X, Y, Z) of (k, 24).  Each MSM is one row of W n keys (its digits
    of every window; the table holds the window weights), sorted once and
    scanned by B3 in chunks of rows (the reference's 2^28-byte budget)."""
    W, n = table[0].shape[1:]
    k = scalars.shape[0]
    if k == 0:
        return tuple(t.new_zeros((0, t.shape[0])) for t in table)
    keys = _digits(scalars, c).movedim(1, 0).reshape(k, W * n)  # (k, W n)
    flat = tuple(t.reshape(t.shape[0], W * n) for t in table)
    res = []
    g = _chunk(W * n, k)
    for r0 in range(0, k, g):
        sorted_dg, perm = torch.sort(keys[r0:r0 + g], dim=1, stable=True)
        pts = tuple(c_[:, perm] for c_ in flat)               # (24, g, W n)
        scanned = bucket.seg_scan(pts, sorted_dg)
        buckets = _bucket_totals(curve, scanned, sorted_dg, c)
        res.append(_window_sums(curve, buckets))              # (24, g)
    return tuple(torch.cat([r[i] for r in res], 1).movedim(0, -1)
                 for i in range(3))


# Points a chunk of the public MSM (``pippenger_lm.py:184-209``): each
# chunk's rows of this many lanes go through B3; partial results add.
POINT_CHUNK = 1 << 17


def msm(points, scalars, c: int | None = None,
        point_chunk: int = POINT_CHUNK, curve: CurveLM = G1_LM):
    """sum_i [k_i] P_i: points (X, Y, Z) of (n, 24); scalars (n, 16)
    canonical -> (X, Y, Z) of (24,).  c defaults to MsmConfig's window,
    else the window of n.  The
    list is padded with zero scalars (digit 0: no bucket picks a pad) to
    whole chunks of `point_chunk` points; the chunks are the groups of
    one grouped MSM (rows of at most `point_chunk` lanes, one Horner fold
    for all), and their partial results add, one EC add a chunk."""
    n = scalars.shape[0]
    if any(p.shape[0] != n for p in points):
        raise ValueError(f"msm: {n} scalars for {points[0].shape[0]} points")
    if n == 0:
        return curve.inf((), scalars.device)
    if c is None:
        c = MsmConfig.from_env().window or default_window(n)
    m = min(n, point_chunk)
    npad = -(-n // m) * m
    points = tuple(torch.nn.functional.pad(p, (0, 0, 0, npad - n))
                   for p in points)
    scalars = torch.nn.functional.pad(scalars, (0, 0, 0, npad - n))
    parts = msm_grouped(points, scalars, (m,) * (npad // m), c, curve)
    acc = parts[0]
    for part in parts[1:]:
        acc = curve.add(acc, part)
    return acc
