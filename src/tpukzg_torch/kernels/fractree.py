"""B4: fraction-tree bottom of the barycentric evaluation.

Replaces ``tpukzg/pallas/fractree.py::_fractree_kernel``.  Per blob,
a_i = e_i * w^i and b_i = z - w^i, merged pairwise by
    (a, b) + (a', b') = (a b' + a' b, b b')
The kernel (``csrc/fractree.cu``) cuts each blob into ``parts`` chunks,
one block each, with ``parts`` chosen here from k and the SM count so
that the grid of k * parts blocks fills the card (two blocks an SM) at
k = 16 as at k = 256.  Thread t of a block folds elements t, t + T, ...
of its chunk serially in registers; each warp merges its threads'
fractions by shuffles, and one warp the warps'.  The kernel takes no
leaf product: as w^i = z - b_i, a blob's numerator is z A' - S B, with
A' the numerator of the fractions e_i / b_i and S = sum e_i, so it
folds (e_i, b_i) and sums S (3 products an element where the reference
takes 4).  A second kernel, one warp a blob, folds the blob's parts the
same way and converts once, so a blob leaves ONE (A, B) pair, whatever
the parts, and ``poly._fraction_merge`` has nothing left to fold.  The
chunks must divide n, so ``parts`` must be a power of two.  Fraction
addition is exact in the field, so every merge order gives the same
numerator bit for bit, and the in-domain case z = w^m (b_m = 0) needs
no branch.  ``fractree_partials_strided`` runs the kernels' order in
tensor code for the tests; it is on no path.

The plain version is the leaf level of ``poly/poly.py:91-94``; the same
``_fraction_merge`` then folds all n leaves.
"""

from __future__ import annotations

import ctypes

import torch

from tpukzg_torch.field.mont import FR_PLAIN, I32
from tpukzg_torch.kernels import _build

THREADS = 256       # threads a block at most
WARP = 32
RUN = 32            # elements a thread folds, where the chunk allows
BLOCKS_PER_SM = 2

_fn = None
# The grid of the last launch: parts a blob, threads a block, and the
# blocks of the two kernels as the launcher reported them.
last_grid: dict = {}


def fractree_partials_plain(evals, z, roots, F=FR_PLAIN):
    """Leaves (a, b) = (e * w, z - w): (k, n, 16) each."""
    a = F.mul(evals, roots)
    b = F.sub(z[..., None, :], roots)
    return a, b


def parts_for(k: int, n: int, sms: int) -> int:
    """Chunks a blob: the least power of two p with k p >= BLOCKS_PER_SM
    sms, but no chunk under a warp's 32 elements (p <= n / 32) and at
    least 1: 32 at the prover's k = 16, 2 at the verifier's k = 256 on
    132 SMs."""
    p = 1
    while k * p < BLOCKS_PER_SM * sms and n // (2 * p) >= WARP:
        p *= 2
    return p


def threads_for(chunk: int) -> int:
    """Threads a block: chunk / RUN (each thread folds RUN elements, so
    the shuffle tree's 15 products are a small share of its 4 RUN), at
    least a warp and at most THREADS."""
    return max(WARP, min(THREADS, chunk // RUN))


def _merge(A, B, S, a, b, s, F):
    """(A', B, S) + (a, b, s) = (A' b + a B, B b, S + s)."""
    return F.add(F.mul(A, b), F.mul(a, B)), F.mul(B, b), F.add(S, s)


def _halve(A, B, S, F):
    """Lane l merges lane l + w/2 along axis -2 (width w) -> width w/2."""
    h = A.shape[-2] // 2
    return _merge(A[..., :h, :], B[..., :h, :], S[..., :h, :],
                  A[..., h:, :], B[..., h:, :], S[..., h:, :], F)


def _fold(A, B, S, F):
    """Fold (..., m, 16) triples to (..., 16) by halving along axis -2
    (m a power of two)."""
    while A.shape[-2] > 1:
        A, B, S = _halve(A, B, S, F)
    return A[..., 0, :], B[..., 0, :], S[..., 0, :]


def fractree_partials_strided(evals, z, roots, parts: int, threads: int,
                              F=FR_PLAIN):
    """The kernels' order and arithmetic in tensor code: one (k, 1, 16)
    pair a blob.  In each of `parts` chunks, thread t folds (e_i, z - w^i)
    for elements t, t + T, ... and sums S = sum e_i (the identity
    (0, 1, 0) where it has none); each warp halves its lanes five times,
    and the warps' triples are halved the same way.  Then lane l of the
    fold folds the triples of parts l, l + 32, ..., the lanes are halved,
    and A = z A' - S B."""
    k, n, _ = evals.shape
    chunk, T = n // parts, threads
    one = torch.as_tensor(F.one_mont, dtype=evals.dtype, device=evals.device)
    zero = torch.zeros_like(one)

    def lay(x, fill, group, width):
        """(k, g group, 16) -> (k, g, runs, width, 16): element c of a
        group goes to run c // width, lane c % width; `fill` pads."""
        runs = -(-group // width)
        x = x.reshape(k, -1, group, 16)
        pad = fill.expand(k, x.shape[1], runs * width - group, 16)
        return torch.cat([x, pad], 2).reshape(k, -1, runs, width, 16)

    def serial(A, B, S):
        """Each lane folds its runs (axis 2) in order."""
        a, b, s = A[:, :, 0], B[:, :, 0], S[:, :, 0]
        for r in range(1, A.shape[2]):
            a, b, s = _merge(a, b, s, A[:, :, r], B[:, :, r], S[:, :, r], F)
        return a, b, s

    e = lay(evals, zero, chunk, T)
    A, B, S = serial(e, lay(F.sub(z[..., None, :], roots), one, chunk, T), e)
    A, B, S = _fold(*(x.reshape(k, parts, T // WARP, WARP, 16)
                      for x in (A, B, S)), F)        # each warp
    A, B, S = _fold(A, B, S, F)                      # (k, parts, 16)
    width = min(parts, WARP)
    A, B, S = serial(*(lay(x, f, parts, width)
                       for x, f in ((A, zero), (B, one), (S, zero))))
    A, B, S = _fold(A, B, S, F)                      # (k, 1, 16)
    A = F.sub(F.mul(A, z[:, None, :]), F.mul(S, B))
    return A, B


def _launch(evals, z, roots, parts=None, threads=None):
    """The kernels on CUDA tensors -> (k, 1, 16) pairs; `parts` and
    `threads` override ``parts_for`` and ``threads_for`` (for
    experiments)."""
    k, n, _ = evals.shape
    dev = evals.device
    if parts is None:
        parts = parts_for(k, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
    # the chunks must divide n, a power of two
    if parts < 1 or parts & (parts - 1) or n % parts:
        raise ValueError(f"fractree: parts={parts} must be a power of two "
                         f"dividing n={n}")
    chunk = n // parts
    threads = threads or threads_for(chunk)
    if dev.type != "cuda":
        raise ValueError(f"fractree: the kernel needs CUDA tensors, not {dev}")
    e = _build.aligned(evals.to(I32).contiguous())
    w = _build.aligned(roots.to(I32).contiguous())
    zz = _build.aligned(z.to(I32).contiguous())
    a = torch.empty((k, 1, 16), dtype=I32, device=dev)
    b = torch.empty_like(a)
    if k == 0:
        return a, b
    part = torch.empty((k, parts, 24), dtype=I32, device=dev)
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_fractree", "pppppplllipp")
    blocks = (ctypes.c_int * 2)()
    err = _fn(a.data_ptr(), b.data_ptr(), part.data_ptr(),
              e.data_ptr(), w.data_ptr(), zz.data_ptr(), k, n, chunk,
              threads, ctypes.addressof(blocks), _build.stream_ptr(dev))
    _build.check(err, "tpukzg_fractree")
    _build.launches["fractree"] += 1
    last_grid.clear()
    last_grid.update(parts=parts, threads=threads, blocks=blocks[0],
                     fold_blocks=blocks[1])
    return a, b


def fractree_partials(evals, z, roots):
    """evals (k, n, 16) Montgomery natural order, z (k, 16), roots (n, 16).
    CPU tensors -> the plain leaves (k, n, 16); CUDA tensors -> the
    kernels' one pair a blob (k, 1, 16).  Either way `_fraction_merge` of
    the result is the same numerator."""
    devs = {evals.device, z.device, roots.device}
    if devs == {torch.device("cpu")}:
        return fractree_partials_plain(evals, z, roots)
    dev = evals.device
    if dev.type != "cuda" or len(devs) != 1:
        raise ValueError(f"fractree: tensors on {devs}")
    k, n, L = evals.shape
    if L != 16 or roots.shape != (n, 16) or z.shape != (k, 16):
        raise ValueError(f"fractree: shapes {tuple(evals.shape)}, "
                         f"{tuple(z.shape)}, {tuple(roots.shape)}")
    if n < 1 or n & (n - 1):
        raise ValueError(f"fractree: n={n} must be a power of two")
    return _launch(evals, z, roots)
