"""B3: inclusive segmented EC-sum scan over sorted bucket keys.

Replaces ``tpukzg/pallas/bucket.py::_scan_kernel`` (entered through
``seg_scan_pallas`` and ``suffix_scan_pallas``).  One kernel
(``csrc/bucket.cu``) serves both scans.  Hopper blocks run in no fixed
order, so the TPU's sequential grid carry becomes a loop inside the
block: one block per row walks its row's tiles in order, keeping the
trailing segment's point and key in shared memory; within a tile a
segmented Hillis-Steele runs on points held in shared memory (two
buffers of 144-byte points, 32-bit words).  A row of up to 768 lanes is
one tile, so at the main-path shapes (513 and 255 lanes) the kernel adds
in exactly the order of the ``loop`` scan.

Lanes are not padded: the TPU padded each row to its lane tile with
sentinel-keyed pad lanes that sit above every real lane and so never
reach one; here the kernel simply stops at the row's length.  The
suffix scan keeps the flip -> single segment -> flip structure.

The plain versions are the ``loop`` scans of ``msm/scan.py``.
"""

from __future__ import annotations

import torch

from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
from tpukzg_torch.field.mont import I32
from tpukzg_torch.kernels import _build
from tpukzg_torch.msm import scan as _scan

SENTINEL = 0x7FFFFFF0
MAX_TILE = 768

_fn = None


def seg_scan_plain(pts, seg):
    return _scan.seg_scan(G1_LM_PLAIN, pts, seg)


def suffix_scan_plain(pts):
    return _scan.suffix_scan(G1_LM_PLAIN, pts)


def _launch(pts, seg):
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
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_seg_scan", "pppppppllp")
    err = _fn(*[o.data_ptr() for o in out], *[c.data_ptr() for c in ins],
              keys.data_ptr(), g, n, _build.stream_ptr(dev))
    _build.check(err, "tpukzg_seg_scan")
    _build.launches["bucket_scan"] += 1
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
