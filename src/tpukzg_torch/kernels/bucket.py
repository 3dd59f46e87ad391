"""B3: inclusive segmented EC-sum scan over sorted bucket keys, and the
window sum over a row of bucket totals.

The scan replaces ``tpukzg/pallas/bucket.py::_scan_kernel`` (entered
through ``seg_scan_pallas``).  The TPU's sequential grid carried a
tile's trailing segment into the next; Hopper blocks have no order, so a
row is cut into chunks of ``THREADS * runs`` lanes, one block each, and
up to three device kernels run per call:

1. local: each thread scans a run of ``runs`` lanes in order, the block
   scans its run totals (segmented by each run's last key) and adds them
   into the runs' leading segments; it writes each chunk's total and
   last key;
2. carry (rows of several chunks): a segmented scan over each row's
   chunk totals, keyed by their last keys;
3. fix-up: each chunk adds the scanned total of the chunk before it into
   its leading segment, where that chunk ends with the key it begins
   with.

``seg_scan_chunked`` runs the same passes in tensor code; the tests hold
it against the plain scan, it is on no path.

The window sum, sum_b b S_b over the bucket totals S_1..S_{B-1} of a
row, replaces ``suffix_scan_pallas`` and the tree sum of
``msm/pippenger_lm.py``: one kernel set of two launches (the header of
``csrc/bucket.cu`` sets out its design), ``window_sum_chunked`` its
decomposition in tensor code, and the suffix scan then the tree sum its
plain version.  The plain scans are the ``loop`` scans of
``msm/scan.py``.

Every function here takes G1 coordinates (24, ...) or G2 coordinates
(48, ...: c0's 24 limbs, then c1's) and picks the curve by the limb
axis: the kernels' G2 instances (``csrc/bucket.cu``, ``*_g2``) are
counted as ``bucket_scan_g2`` and ``window_sum_g2``, the plain versions
run over G2_LM_PLAIN.
"""

from __future__ import annotations

import ctypes

import torch

from tpukzg_torch.curve.weierstrass_lm import PLAIN_CURVE
from tpukzg_torch.field.mont import I32
from tpukzg_torch.kernels import _build
from tpukzg_torch.msm import scan as _scan

SENTINEL = 0x7FFFFFF0
THREADS = 128          # threads a block; a chunk is THREADS * runs lanes

KERNELS = ("scan_local", "scan_carry", "scan_fixup")
WS_KERNELS = ("window_sum", "window_sum_join")
# The blocks of each device kernel the last launch ran (those it ran only).
last_grid: dict = {}


def plain_curve(pts):
    """G1_LM_PLAIN or G2_LM_PLAIN, by the limb axis of the coords."""
    L = pts[0].shape[0]
    if L not in PLAIN_CURVE:
        raise ValueError(f"limb axis {L} is neither 24 (G1) nor 48 (G2)")
    return PLAIN_CURVE[L]


def seg_scan_plain(pts, seg):
    return _scan.seg_scan(plain_curve(pts), pts, seg)


def suffix_scan_plain(pts):
    return _scan.suffix_scan(plain_curve(pts), pts)


def window_sum_plain(buckets):
    """sum_b b S_b of each row of (L, g, B - 1) bucket coords -> (L, g):
    the suffix scan over the buckets, then a tree sum."""
    return plain_curve(buckets).reduce_sum_lanes(suffix_scan_plain(buckets),
                                                 axis=1)


def seg_scan_chunked(pts, seg, sizes, curve=None):
    """The kernel's decomposition in tensor code, for the tests.  sizes =
    (chunk,) scans each chunk of `chunk` lanes with the plain scan;
    (chunk, run, ...) scans each chunk by the same decomposition with
    sizes[1:], as the kernel's block scans its threads' runs."""
    curve = curve or plain_curve(pts)
    chunk, rest = sizes[0], tuple(sizes[1:])
    L, g, n = pts[0].shape
    nch = -(-n // chunk)
    pad = nch * chunk - n
    # pad lanes: infinity under a key above every real key
    inf = curve.inf((g, pad), seg.device)
    P = tuple(torch.cat([c, i], 2).reshape(L, g * nch, chunk)
              for c, i in zip(pts, inf))
    K = torch.cat([seg, torch.full((g, pad), SENTINEL, dtype=seg.dtype,
                                   device=seg.device)], 1)
    K = K.reshape(g * nch, chunk)
    local = (seg_scan_chunked(P, K, rest, curve) if rest
             else seg_scan_plain(P, K))
    # carry pass: chunk totals scanned by their last keys
    tot = tuple(c[:, :, -1].reshape(L, g, nch) for c in local)
    first, last = K[:, 0].reshape(g, nch), K[:, -1].reshape(g, nch)
    S = seg_scan_plain(tot, last)
    # fix-up: the leading segment of chunk c takes S[c - 1] where chunk
    # c - 1 ends with the key chunk c begins with
    prev = tuple(torch.roll(c, 1, dims=2)[..., None].expand(-1, -1, -1, chunk)
                 for c in S)
    takes = (torch.arange(nch, device=seg.device) >= 1) & (
        torch.roll(last, 1, dims=1) == first)
    mask = takes[..., None] & (K.reshape(g, nch, chunk) == first[..., None])
    local = tuple(c.reshape(L, g, nch, chunk) for c in local)
    out = curve.select(mask, curve.add(prev, local), local)
    return tuple(c.reshape(L, g, nch * chunk)[..., :n] for c in out)


def runs_for(g: int, n: int, sms: int) -> int:
    """Lanes a thread scans in order: the largest of 8, 4 and 2 whose
    chunks still give two waves of 4 blocks an SM, else 1."""
    for r in (8, 4, 2):
        if g * -(-n // (THREADS * r)) >= 8 * sms:
            return r
    return 1


def _launch(pts, seg, runs=None):
    dev = pts[0].device
    L, g, n = pts[0].shape
    if L not in (24, 48) or seg.shape != (g, n) or any(
            c.shape != (L, g, n) for c in pts):
        raise ValueError(f"bucket scan: shapes {[tuple(c.shape) for c in pts]}"
                         f", keys {tuple(seg.shape)}")
    if any(c.device != dev for c in pts) or seg.device != dev:
        raise ValueError("bucket scan: tensors on several devices")
    ins = [c.to(I32).contiguous() for c in pts]
    keys = seg.to(I32).contiguous()
    out = [torch.empty((L, g, n), dtype=I32, device=dev) for _ in range(3)]
    if g == 0 or n == 0:
        return tuple(out)
    if runs is None:
        runs = runs_for(g, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    m = g * -(-n // (THREADS * runs))
    words = 3 * L // 2                                  # a point's words
    agg = torch.empty((words, m), dtype=I32, device=dev)    # chunk totals
    agg_key = torch.empty(m, dtype=I32, device=dev)     # their last keys
    fn, name = (("tpukzg_seg_scan", "bucket_scan") if L == 24 else
                ("tpukzg_seg_scan_g2", "bucket_scan_g2"))
    blocks = (ctypes.c_int * 3)()
    err = _build.fn(fn, "pppppppppllipp")(
        *[o.data_ptr() for o in out], *[c.data_ptr() for c in ins],
        keys.data_ptr(), agg.data_ptr(), agg_key.data_ptr(), g, n, runs,
        ctypes.addressof(blocks), _build.stream_ptr(dev))
    _build.check(err, fn)
    _build.launches[name] += 1
    last_grid.clear()
    last_grid.update((k, b) for k, b in zip(KERNELS, blocks) if b)
    return tuple(out)


def seg_scan(pts, seg):
    """pts (X, Y, Z) of (24, g, n) (G1) or (48, g, n) (G2) Montgomery
    limbs; seg (g, n) sorted keys.  CPU -> plain loop scan; CUDA ->
    kernel."""
    dev = pts[0].device
    if dev.type == "cpu":
        return seg_scan_plain(pts, seg)
    if dev.type != "cuda":
        raise ValueError(f"bucket scan: unsupported device {dev}")
    return _launch(pts, seg)


def _ceil_log2(n: int) -> int:
    return max(0, (n - 1).bit_length())


def _window_join(P, Q, levels: int, lg: int, curve):
    """The kernels' block_join on items (L, m, >= 2^levels): item t, the
    range of 2^lg buckets from t 2^lg, holds (P[..., t], Q[..., t]) =
    (its total, its sum weighted 1..2^lg) -> the pair of items 0..2^levels
    - 1 joined, add for add as the kernel (each level's adds at once)."""
    P, Q = [c.clone() for c in P], [c.clone() for c in Q]
    dev = P[0].device

    def join(X, idx, h):
        new = curve.add(tuple(c[..., idx] for c in X),
                        tuple(c[..., idx + h] for c in X))
        for c, v in zip(X, new):
            c[..., idx] = v

    for j in range(levels):
        t0 = torch.arange(0, 1 << levels, 2 << j, device=dev)
        offs = torch.tensor([0] + [1 << k for k in range(j)], device=dev)
        join(Q, t0, 1 << j)
        join(P, (t0[:, None] + offs).reshape(-1), 1 << j)
    terms = [tuple(c[..., 0] for c in Q)] + [
        curve.double_n(tuple(c[..., 1 << k] for c in P), lg + k)
        for k in range(levels)]
    h = 1
    while h <= levels:
        for i in range(0, levels + 1 - h, 2 * h):
            terms[i] = curve.add(terms[i], terms[i + h])
        h *= 2
    return tuple(c[..., 0] for c in P), terms[0]


def window_sum_chunked(buckets, s: int, threads: int = THREADS):
    """The window-sum kernels' decomposition in tensor code, for the
    tests: segments of s buckets walked from the top (R += S; A += R),
    blocks of `threads` segments joined by ``_window_join``, then each
    row's blocks joined the same way.  With threads = THREADS and s a
    power of two it gives the kernels' limbs."""
    L, g, nb = buckets[0].shape
    lg, tl = s.bit_length() - 1, threads.bit_length() - 1
    segs = -(-nb // s)
    nblk = -(-segs // threads)
    if s != 1 << lg or threads != 1 << tl or nblk > threads:
        raise ValueError(f"window sum: s {s}, threads {threads}, "
                         f"{nblk} blocks a row")
    dev, curve = buckets[0].device, plain_curve(buckets)
    pad = segs * s - nb
    S = tuple(torch.cat([c, i], 2).reshape(L, g, segs, s) for c, i in
              zip(buckets, curve.inf((g, pad), dev)))
    lane = torch.arange(segs * s, device=dev).reshape(segs, s)
    top = (torch.arange(1, segs + 1, device=dev) * s).clamp(max=nb) - 1
    R = A = curve.inf((g, segs), dev)
    for i in range(s - 1, -1, -1):
        Si = tuple(c[..., i] for c in S)
        live, first = lane[:, i] < nb, lane[:, i] == top
        R1 = curve.select(first, Si, curve.add(R, Si))
        A1 = curve.select(first, Si, curve.add(A, R1))
        R, A = curve.select(live, R1, R), curve.select(live, A1, A)
    # the blocks: segments past the row's end are infinity
    inf = curve.inf((g, nblk * threads - segs), dev)
    items = [tuple(torch.cat([c, i], 2).reshape(L, g * nblk, threads)
                   for c, i in zip(X, inf)) for X in (R, A)]
    T, A = _window_join(*items, _ceil_log2(min(segs, threads)), lg, curve)
    # the join: one block a row over its nblk block pairs
    inf = curve.inf((g, threads - nblk), dev)
    items = [tuple(torch.cat([c.reshape(L, g, nblk), i], 2) for c, i in
                   zip(X, inf)) for X in (T, A)]
    return _window_join(*items, _ceil_log2(nblk), lg + tl, curve)[1]


def window_segment_for(g: int, nb: int, sms: int) -> int:
    """Buckets a thread of the window sum walks: the largest of 16, 8, 4
    and 2 that still gives two blocks an SM, else 1; then doubled until a
    row has at most THREADS blocks (the join takes one a thread)."""
    s = next((c for c in (16, 8, 4, 2)
              if g * -(-nb // (THREADS * c)) >= 2 * sms), 1)
    while -(-nb // (THREADS * s)) > THREADS:
        s *= 2
    return s


def _launch_window(buckets, s=None):
    dev = buckets[0].device
    L, g, nb = buckets[0].shape
    if L not in (24, 48) or any(c.shape != (L, g, nb) for c in buckets):
        raise ValueError("window sum: shapes "
                         f"{[tuple(c.shape) for c in buckets]}")
    if any(c.device != dev for c in buckets):
        raise ValueError("window sum: tensors on several devices")
    if g == 0 or nb == 0:
        return plain_curve(buckets).inf((g,), dev)
    if s is None:
        s = window_segment_for(g, nb, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    lg = s.bit_length() - 1
    nblk = -(-nb // (s * THREADS))            # blocks a row
    if s != 1 << lg or nblk > THREADS:
        raise ValueError(f"window sum: s {s} for {nb} buckets")
    ins = [c.to(I32).contiguous() for c in buckets]
    out = [torch.empty((L, g), dtype=I32, device=dev) for _ in range(3)]
    agg = torch.empty((3 * L, g * nblk), dtype=I32, device=dev)  # block pairs
    fn, name = (("tpukzg_window_sum", "window_sum") if L == 24 else
                ("tpukzg_window_sum_g2", "window_sum_g2"))
    blocks = (ctypes.c_int * 2)()
    err = _build.fn(fn, "pppppppllipp")(
        *[o.data_ptr() for o in out], *[c.data_ptr() for c in ins],
        agg.data_ptr(), g, nb, lg, ctypes.addressof(blocks),
        _build.stream_ptr(dev))
    _build.check(err, fn)
    _build.launches[name] += 1
    last_grid.clear()
    last_grid.update(zip(WS_KERNELS, blocks))
    return tuple(out)


def window_sum(buckets):
    """sum_b b S_b of each row of (L, g, B - 1) bucket coords (lane i
    holds S_{i+1}; L = 24 on G1, 48 on G2) -> (L, g).  CPU -> plain
    version; CUDA -> kernel."""
    dev = buckets[0].device
    if dev.type == "cpu":
        return window_sum_plain(buckets)
    if dev.type != "cuda":
        raise ValueError(f"window sum: unsupported device {dev}")
    return _launch_window(buckets)
