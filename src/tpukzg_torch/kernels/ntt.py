"""B5: an Fr NTT / iNTT as a few passes of stages, with the inverse's 1/n.

Replaces ``tpukzg/pallas/ntt.py::_ntt_kernel`` (entered through
``NttPallas.ntt``/``intt``).  The TPU kernel kept one polynomial in a
VMEM tile, paired lanes with rolls and a parity mask, multiplied all n
lanes by per-lane twiddle tables (twice the work a butterfly needs) and
left the bit-reversal to a gather outside.

``csrc/ntt.cu`` runs the log2 n DIT stages as passes: a pass takes the
stages [s0, s1), which pair only indices differing in bits s0 .. s1-1,
so the 2^(s1-s0) elements agreeing on every other bit form an
independent group at stride 2^s0.  A block runs its pass on G groups of
consecutive low bits in shared memory, one butterfly a thread a stage.
The first pass applies the bit-reversal in its load, the last the
inverse's 1/n.  ``passes_for`` picks the split (one pass up to n = 64,
two of 6 stages at n = 4096, two of 9 at 2^18) and G: the fewest groups
that fill a warp, so that the grid has as many blocks as it can (1,024
in the first pass at the prover's (16, 4096), 7.8 an SM).  On the H100
G = 1, 2 and 4 came within 3 % of each other there (PERF.md).

Twiddles come from one table of n/2 roots per direction (stage s takes
root j * (n >> (s+1))), kept on the device by the plan.  Field results
are canonical, so any correct butterfly order gives the plain version's
bits exactly.  ``ntt_passes`` runs the kernel's passes, with its index
arithmetic, in tensor code for the tests; it is on no path.

The plain version is the stage loop of ``tpukzg/ntt/ntt.py:112-124``.
"""

from __future__ import annotations

import ctypes

import torch

from tpukzg_torch.field.mont import FR_PLAIN, I32
from tpukzg_torch.kernels import _build

ONE_PASS = 6        # up to 2^6 elements, all stages in one pass
MAX_STAGES = 12     # stages a pass: G m <= 4096 elements a block (128 KB)
WARP_ELEMS = 64     # G m >= 64: a block's butterflies fill a warp

_fn = None
# The passes the last launch ran: stages [s0, s1), groups a block, and
# the blocks the launcher reported.
last_grid: list = []


def ntt_plain(x, plan, inverse: bool = False):
    """(..., n, 16) Montgomery natural order -> the same shape."""
    F = FR_PLAIN
    n = plan.n
    batch = x.shape[:-2]
    a = x.index_select(-2, plan.on(x.device, "brp"))
    for s in range(plan.log_n):
        half = 1 << s
        y = a.reshape(batch + (n // (2 * half), 2, half, 16))
        tw = torch.as_tensor(plan.stage_twiddles(s, inverse), device=x.device)
        u = y[..., 0, :, :]
        v = F.mul(y[..., 1, :, :], tw)
        a = torch.stack([F.add(u, v), F.sub(u, v)], -3).reshape(
            batch + (n, 16))
    if inverse:
        a = F.mul(a, plan.on(x.device, "n_inv"))
    return a


def split_stages(log_n: int) -> tuple:
    """Stages of each pass: one pass up to ONE_PASS stages, else the
    fewest passes (at least two) of at most MAX_STAGES, as even as can
    be, the longer first."""
    if log_n <= ONE_PASS:
        return (log_n,)
    p = max(2, -(-log_n // MAX_STAGES))
    q, r = divmod(log_n, p)
    return tuple(q + 1 if i < r else q for i in range(p))


def passes_for(k: int, n: int, sms: int) -> list:
    """[(s0, s1, log2 G)] for k NTTs of size n on `sms` SMs: G is the
    fewest groups of 2^(s1 - s0) elements that fill a warp's butterflies,
    within the groups a pass has side by side, and fewer where the grid
    would not give every SM a block."""
    log_n = n.bit_length() - 1
    out, s0 = [], 0
    for st in split_stages(log_n):
        s1 = s0 + st
        room = min((log_n - s1) if s0 == 0 else s0, MAX_STAGES - st)
        lg = min(room, max(0, (WARP_ELEMS >> st).bit_length() - 1))
        while lg and (k * n) >> (st + lg) < sms:
            lg -= 1
        out.append((s0, s1, lg))
        s0 = s1
    return out


def _pass_positions(log_n: int, s0: int, s1: int, log_g: int):
    """The kernel's index arithmetic: for block b, group position jj and
    group g, the DIT position the element takes (dst) and the position
    it is read from (src; bit-reversed in the first pass), each
    (blocks, m, G) int64; and the group's low bits (blocks, 1, G), 0 in
    the first pass."""
    m, G = 1 << (s1 - s0), 1 << log_g
    b = torch.arange((1 << log_n) // (m * G))[:, None, None]
    jj = torch.arange(m)[None, :, None]
    g = torch.arange(G)[None, None, :]
    if s0 == 0:
        h = b * G + g
        dst = (_brev(h, log_n - s1) << s1) | jj
        src = (_brev(jj, s1) << (log_n - s1)) | h
        lo = torch.zeros_like(h)
    else:
        per = (1 << s0) // G
        lo = (b % per) * G + g
        dst = ((b // per) << s1) | (jj << s0) | lo
        src = dst
    return dst, src, lo


def _brev(i, bits: int):
    out = torch.zeros_like(i)
    for t in range(bits):
        out |= ((i >> t) & 1) << (bits - 1 - t)
    return out


def ntt_passes(x, plan, splits, inverse: bool = False, groups=None,
               F=FR_PLAIN):
    """B5's passes in tensor code: x (k, n, 16) natural order; splits =
    the stages of each pass (summing to log2 n); groups = log2 G of each
    pass (default 0).  Same result as ``ntt_plain``."""
    log_n = plan.log_n
    if sum(splits) != log_n:
        raise ValueError(f"splits {splits} do not sum to {log_n}")
    groups = groups or (0,) * len(splits)
    tab = torch.as_tensor(plan.tw_inv if inverse else plan.tw_fwd,
                          device=x.device)
    k = x.shape[0]
    cur, s0 = x, 0
    out = torch.empty_like(x)
    for p, (st, lg) in enumerate(zip(splits, groups)):
        s1 = s0 + st
        dst, src, lo = _pass_positions(log_n, s0, s1, lg)
        nb, m, G = dst.shape
        a = cur[:, src.reshape(-1)].reshape(k, nb, m, G, 16)
        for t in range(st):
            half = 1 << t
            y = a.reshape(k, nb, m // (2 * half), 2, half, G, 16)
            j = torch.arange(half)[None, :, None]
            # twiddle index of stage s0 + t: (nb, half, G)
            ti = ((j << s0) | lo) << (log_n - (s0 + t) - 1)
            w = tab[ti][:, None]
            u, v = y[:, :, :, 0], F.mul(y[:, :, :, 1], w)
            a = torch.stack([F.add(u, v), F.sub(u, v)], 3).reshape(
                k, nb, m, G, 16)
        if inverse and p == len(splits) - 1:
            a = F.mul(a, plan.on(x.device, "n_inv"))
        out[:, dst.reshape(-1)] = a.reshape(k, -1, 16)
        cur, s0 = out, s1
    return out


def _launch(x, plan, inverse: bool = False, passes=None):
    """The kernel on a CUDA tensor; `passes` [(s0, s1, log2 G)] overrides
    ``passes_for`` (for experiments)."""
    dev = x.device
    n = plan.n
    xin = _build.aligned(x.reshape((-1, n, 16)).to(I32).contiguous())
    k = xin.shape[0]
    out = torch.empty_like(xin)
    if k == 0:
        return out.reshape(x.shape)
    if passes is None:
        passes = passes_for(k, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    tw = plan.on(dev, "tw_inv" if inverse else "tw_fwd")
    scale = plan.on(dev, "n_inv")
    stream = _build.stream_ptr(dev)
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_ntt_pass", "pppplliiiipp")
    grid = []
    blocks = ctypes.c_int()
    for i, (s0, s1, lg) in enumerate(passes):
        src = xin if i == 0 else out
        err = _fn(out.data_ptr(), src.data_ptr(), tw.data_ptr(),
                  scale.data_ptr(), k, n, s0, s1, lg,
                  int(inverse and i == len(passes) - 1),
                  ctypes.addressof(blocks), stream)
        _build.check(err, "tpukzg_ntt_pass")
        _build.launches["ntt"] += 1
        grid.append({"stages": [s0, s1], "groups": 1 << lg,
                     "blocks": blocks.value})
    last_grid[:] = grid
    return out.reshape(x.shape)


def ntt(x, plan, inverse: bool = False):
    """CPU tensor -> plain version; CUDA tensor -> kernel B5."""
    dev = x.device
    if dev.type == "cpu":
        return ntt_plain(x, plan, inverse)
    if dev.type != "cuda":
        raise ValueError(f"ntt: unsupported device {dev}")
    n = plan.n
    if x.dim() < 2 or tuple(x.shape[-2:]) != (n, 16):
        raise ValueError(f"ntt: shape {tuple(x.shape)} is not (..., {n}, 16)")
    if x.is_floating_point():
        raise TypeError("ntt: limbs must be an integer tensor")
    return _launch(x, plan, inverse)
