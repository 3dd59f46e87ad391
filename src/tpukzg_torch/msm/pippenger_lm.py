"""Pippenger MSMs in the limb-major layout (counterpart of
``tpukzg/msm/pippenger.py:36-58`` and ``msm/pippenger_lm.py``).

Sort-by-digit, then the segmented bucket scan (kernel B3 on the card),
one gather of each bucket's last lane, and the window sum over buckets
(the window-sum kernel on the card; the suffix scan and a tree sum on
the CPU).  Every MSM here goes through one core, `_msm_rows`: its rows
of digits make slots of G rows; each pass's bucket totals add into one
accumulator of the slots' buckets (buckets are linear in the points),
and one window sum runs over the slots a call.  `msm` has a slot a
window of G chunks of `POINT_CHUNK` points, `msm_grouped` (batch verify)
and `msm_batch` a slot of one row a window and MSM, and each folds its
windows by Horner; `msm_fixed` (commit, open) has a slot of W n keys an
MSM, the window weights in a table of [2^(c w)] P_i: no doublings.

Every MSM here takes the curve: G1_LM (points (n, 24)) by default, or
G2_LM (points (n, 48): c0's 24 limbs, then c1's).  The kernels pick
their G1 or G2 instance by the coordinates' limb axis, so a G2 MSM runs
the same route as a G1 one: the sort, B3, the window sum, the Horner
fold.
"""

from __future__ import annotations

import numpy as np
import torch

from tpukzg_torch.curve.weierstrass_lm import G1_LM, CurveLM
from tpukzg_torch.field.mont import upload
from tpukzg_torch.kernels import bucket, ec
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


def _chunk(n: int, rows: int, limbs: int = 24,
           budget: int = 1 << 28) -> int:
    """Rows of n sorted digits a bucket-scan chunk takes: MsmConfig's
    window_chunk, else as many as `budget` bytes hold (three copies of a
    row's points, `limbs` int32 limbs a coordinate: 24 G1, 48 G2)."""
    fixed = MsmConfig.from_env().window_chunk
    if fixed is not None:
        return min(fixed, rows)
    per_row = n * 3 * limbs * 4 * 3
    return max(1, min(rows, budget // max(per_row, 1)))


def _bucket_rows(pts_flat, rows, offs, c: int, curve: CurveLM):
    """The bucket totals of R rows of n digits: each row sorts its digits
    and scans the points pts_flat[:, offs[r] + perm] (offs None: 0) by
    bucket, in chunks of rows -> yields (r0, coords (L, g, 2^c - 1)) for
    rows r0 .. r0 + g - 1."""
    R, n = rows.shape
    gch = _chunk(n, R, curve.F.L)
    for r0 in range(0, R, gch):
        sorted_dg, perm = torch.sort(rows[r0:r0 + gch], dim=1, stable=True)
        idx = perm if offs is None else perm + offs[r0:r0 + gch, None]
        pts = tuple(c_[:, idx] for c_ in pts_flat)           # (L, gch, n)
        scanned = bucket.seg_scan(pts, sorted_dg)
        yield r0, _bucket_totals(curve, scanned, sorted_dg, c)


def _fold(acc, run, buckets, r0: int, G: int):
    """Adds the bucket totals of rows r0 .. r0 + g - 1 (coords (L, g,
    B - 1); row r is chunk r % G of slot r // G) into acc (coords (L,
    slots, B - 1)): the pass's whole slots by one tree (a bucket_fold
    launch a level) and one write; a slot it splits by a tree, then into
    its running sum in `run`, which the slot's last rows write."""
    e = r0 + buckets[0].shape[1]
    a = min(-(-r0 // G) * G, e)               # the first whole slot's row
    b = max(e // G * G, a)                    # the last whole slot's end
    for lo, hi in ((r0, a), (a, b), (b, e)):
        if lo == hi:
            continue
        s, t = lo // G, -(-hi // G)
        seg = buckets if hi - lo == e - r0 else tuple(
            c[:, lo - r0:hi - r0] for c in buckets)
        if t > s + 1:                             # (L, t - s, G, B - 1)
            seg = tuple(c.unflatten(1, (t - s, G)) for c in seg)
        while seg[0].shape[-2] > 1:
            m = seg[0].shape[-2]
            h = m // 2
            sums = ec.ec_add(tuple(c[..., :h, :] for c in seg),
                             tuple(c[..., h:2 * h, :] for c in seg),
                             counted_as="bucket_fold")
            seg = sums if m % 2 == 0 else tuple(
                torch.cat([u, c[..., 2 * h:, :]], -2)
                for u, c in zip(sums, seg))
        if s in run:
            seg = ec.ec_add(run.pop(s), seg, counted_as="bucket_fold")
        if hi % G:
            run[s] = seg
        else:
            for dst, c in zip(acc, seg):
                dst[:, s:t] = c.flatten(1, -2)


def _msm_rows(pts_flat, rows, offs, c: int, curve: CurveLM, G: int = 1):
    """The window sums of R // G slots of G rows of n digits (row r is
    chunk r % G of slot r // G; `_bucket_rows`' rows): each pass's bucket
    totals add into their slots' buckets (`_fold`), then one window sum
    runs over the slots -> coords (L, R // G)."""
    acc = tuple(p.new_empty((p.shape[0], rows.shape[0] // G, (1 << c) - 1))
                for p in pts_flat)                     # (L, slots, B - 1)
    run = {}
    for r0, b in _bucket_rows(pts_flat, rows, offs, c, curve):
        _fold(acc, run, b, r0, G)
    return bucket.window_sum(acc)


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

    points: (X, Y, Z) of (n_total, L); scalars (n_total, 16) canonical;
    groups: slice lengths summing to n_total.  Returns G points, each an
    (X, Y, Z) tuple of (L,) tensors (L: the curve's limbs).  Pads are
    zero scalars -> digit 0, which no bucket picks."""
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
    wres = _msm_rows(pts_flat, digits.reshape(W * G, nmax), offs, c, curve)
    acc = _horner(tuple(w.reshape(-1, W, G) for w in wres), c, curve)
    return [tuple(c_[:, i] for c_ in acc) for i in range(G)]


def msm_batch(points, scalars, c: int | None = None,
              curve: CurveLM = G1_LM):
    """k MSMs over one shared point list (``pippenger_lm.py:279-329``):
    points (X, Y, Z) of (n, L); scalars (k, n, 16) canonical -> (X, Y,
    Z) of (k, L).  The W k rows of n digits (window-major) go through
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
    wres = _msm_rows(pts, digits.reshape(W * k, n), None, c, curve)
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
    return tuple(w.movedim(0, -1)
                 for w in _msm_rows(flat, keys, None, c, curve))


# Points a chunk of the public MSM (``pippenger_lm.py:184-209``): each
# chunk's rows of this many lanes go through B3.
POINT_CHUNK = 1 << 17


def msm(points, scalars, c: int | None = None,
        point_chunk: int = POINT_CHUNK, curve: CurveLM = G1_LM):
    """sum_i [k_i] P_i: points (X, Y, Z) of (n, L) (L = curve.F.L: 24
    on G1, 48 on G2); scalars (n, 16) canonical -> (X, Y, Z) of (L,).
    c defaults to MsmConfig's window, else the window of n.  The
    list is padded with zero scalars (digit 0: no bucket picks a pad) to
    G whole chunks of `point_chunk` points, one row of digits a chunk
    and window (W G rows, window-major): `_msm_rows` adds the chunks'
    bucket totals by window (G - 1 adds a bucket of a window) before its
    one window sum, then one Horner fold runs over one lane."""
    n = scalars.shape[0]
    if any(p.shape[0] != n for p in points):
        raise ValueError(f"msm: {n} scalars for {points[0].shape[0]} points")
    if n == 0:
        return curve.inf((), scalars.device)
    if c is None:
        c = MsmConfig.from_env().window or default_window(n)
    m = min(n, point_chunk)
    G = -(-n // m)
    pts = tuple(torch.nn.functional.pad(p, (0, 0, 0, G * m - n)).movedim(
        -1, 0).contiguous() for p in points)                 # (L, G m)
    digits = _digits(torch.nn.functional.pad(scalars, (0, 0, 0, G * m - n)),
                     c)                                      # (W, G m)
    W = digits.shape[0]
    offs = (torch.arange(W * G, device=scalars.device,
                         dtype=torch.int64) % G) * m
    wres = _msm_rows(pts, digits.reshape(W * G, m), offs, c, curve, G)
    acc = _horner(tuple(w[..., None] for w in wres), c, curve)
    return tuple(c_[:, 0] for c_ in acc)
