"""B3: inclusive segmented EC-sum scan over sorted bucket keys.

Replaces ``tpukzg/pallas/bucket.py::_scan_kernel`` (entered through
``seg_scan_pallas`` and ``suffix_scan_pallas``).  One kernel set
(``csrc/bucket.cu``) serves both scans.  The TPU's sequential grid
carried a tile's trailing segment into the next; Hopper blocks have no
order, so a row is cut into chunks of ``THREADS * runs`` lanes, one
block each, and up to three device kernels run per call:

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
it against the plain scan, it is on no path.  The suffix scan keeps the
flip -> single segment -> flip structure.  The plain versions are the
``loop`` scans of ``msm/scan.py``.
"""

from __future__ import annotations

import ctypes

import torch

from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.field.mont import I32
from tpukzg_torch.kernels import _build
from tpukzg_torch.msm import scan as _scan

SENTINEL = 0x7FFFFFF0
THREADS = 128          # threads a block; a chunk is THREADS * runs lanes

_fn = None
KERNELS = ("scan_local", "scan_carry", "scan_fixup")
# The blocks of each device kernel the last launch ran (those it ran only).
last_grid: dict = {}


def seg_scan_plain(pts, seg):
    return _scan.seg_scan(G1_LM_PLAIN, pts, seg)


def suffix_scan_plain(pts):
    return _scan.suffix_scan(G1_LM_PLAIN, pts)


def seg_scan_chunked(pts, seg, sizes, curve=G1_LM_PLAIN):
    """The kernel's decomposition in tensor code, for the tests.  sizes =
    (chunk,) scans each chunk of `chunk` lanes with the plain scan;
    (chunk, run, ...) scans each chunk by the same decomposition with
    sizes[1:], as the kernel's block scans its threads' runs."""
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
    if L != 24 or seg.shape != (g, n) or any(c.shape != (L, g, n)
                                             for c in pts):
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
    agg = torch.empty((36, m), dtype=I32, device=dev)   # chunk totals
    agg_key = torch.empty(m, dtype=I32, device=dev)     # their last keys
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_seg_scan", "pppppppppllipp")
    blocks = (ctypes.c_int * 3)()
    err = _fn(*[o.data_ptr() for o in out], *[c.data_ptr() for c in ins],
              keys.data_ptr(), agg.data_ptr(), agg_key.data_ptr(), g, n,
              runs, ctypes.addressof(blocks), _build.stream_ptr(dev))
    _build.check(err, "tpukzg_seg_scan")
    _build.launches["bucket_scan"] += 1
    last_grid.clear()
    last_grid.update((k, b) for k, b in zip(KERNELS, blocks) if b)
    return tuple(out)


def seg_scan(pts, seg):
    """pts (X, Y, Z) of (24, g, n) Montgomery limbs; seg (g, n) sorted
    keys.  CPU -> plain loop scan; CUDA -> kernel."""
    dev = pts[0].device
    if dev.type == "cpu":
        return seg_scan_plain(pts, seg)
    if dev.type != "cuda":
        raise ValueError(f"bucket scan: unsupported device {dev}")
    return _launch(pts, seg)


def suffix_scan(pts):
    """out[i] = sum_{j >= i} pts[j] along the lanes of (24, g, n) coords."""
    dev = pts[0].device
    if dev.type == "cpu":
        return suffix_scan_plain(pts)
    rev = tuple(torch.flip(c, dims=[2]) for c in pts)
    zeros = torch.zeros(rev[0].shape[1:], dtype=I32, device=dev)
    out = seg_scan(rev, zeros)
    return tuple(torch.flip(c, dims=[2]) for c in out)
