"""B4: fraction-tree bottom of the barycentric evaluation.

Replaces ``tpukzg/pallas/fractree.py::_fractree_kernel``.  Per blob,
a_i = e_i * w^i and b_i = z - w^i, merged pairwise by
    (a, b) + (a', b') = (a b' + a' b, b b')
The kernel (``csrc/fractree.cu``) gives each block a chunk of
CHUNK = 1024 elements of one blob: every thread folds RUN = 8
consecutive elements serially in registers, then the block merges its
threads' fractions in a shared-memory tree and writes one (a, b) pair.
A blob of n elements leaves n / CHUNK partials; ``poly._fraction_merge``
finishes the tail.  Fraction addition is exact in the field, so every
merge order gives the same numerator bit for bit, and the in-domain
case z = w^m (b_m = 0) needs no branch.

The plain version is the leaf level of ``poly/poly.py:91-94``; the same
``_fraction_merge`` then folds all n leaves.
"""

from __future__ import annotations

import torch

from tpukzg_torch.field.mont import FR_PLAIN, I32
from tpukzg_torch.kernels import _build

RUN = 8
CHUNK = 1024


def fractree_partials_plain(evals, z, roots, F=FR_PLAIN):
    """Leaves (a, b) = (e * w, z - w): (k, n, 16) each."""
    a = F.mul(evals, roots)
    b = F.sub(z[..., None, :], roots)
    return a, b


_fn = None


def fractree_partials(evals, z, roots):
    """evals (k, n, 16) Montgomery natural order, z (k, 16), roots (n, 16).
    CPU tensors -> the plain leaves (k, n, 16); CUDA tensors -> the kernel's
    partials (k, n / CHUNK, 16).  Either way `_fraction_merge` of the
    result is the same numerator."""
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
    if n < RUN or n & (n - 1):
        raise ValueError(f"fractree: n={n} must be a power of two >= {RUN}")
    chunk = min(n, CHUNK)
    e = evals.to(I32).contiguous()
    w = roots.to(I32).contiguous()
    zz = z.to(I32).contiguous()
    a = torch.empty((k, n // chunk, 16), dtype=I32, device=dev)
    b = torch.empty_like(a)
    if k == 0:
        return a, b
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_fractree", "ppppplllp")
    err = _fn(a.data_ptr(), b.data_ptr(), e.data_ptr(), w.data_ptr(),
              zz.data_ptr(), k, n, chunk, _build.stream_ptr(dev))
    _build.check(err, "tpukzg_fractree")
    _build.launches["fractree"] += 1
    return a, b
