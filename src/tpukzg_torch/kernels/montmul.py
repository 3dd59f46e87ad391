"""B1: elementwise Montgomery product a*b*R^-1 mod p, kernel and plain version.

Replaces ``tpukzg/pallas/montmul.py::_montmul_kernel`` (the standalone
lane-tiled kernel) and carries its core ``_montmul_lm_core`` as the
``__device__`` function ``mont_mul`` of ``csrc/field.cuh`` that the
bucket-scan and fraction-tree kernels share.

The kernel (``csrc/montmul.cu``) takes 16-bit limbs in int32, in either
layout: trailing (..., L) or limb-major (L, ...).  On a CUDA tensor every
field product of the port's plain tensor code comes here (one launch per
batched product instead of ~100 tensor ops); on a CPU tensor the plain
version below runs.

Plain version: the separated reduction of ``pallas/montmul.py:114-122``
    T = a*b;  m = (T mod R) * mu mod R;  t = (T + m*p) / R;  t -= p if >= p
with int64 column sums and prefix carries (``field/mont.py``).  Both
return the same canonical bits: CIOS on 32-bit words computes the same
t = (T + m p)/R, since the word-by-word m is the unique m < R with
T + m p = 0 mod R.
"""

from __future__ import annotations

import torch

from tpukzg_torch.field.mont import I32, I64, carry, cols
from tpukzg_torch.kernels import _build

FIELD_ID = {"Fp": 0, "Fr": 1}


def montmul_plain(a, b, field, limb_dim: int = -1):
    """Plain tensor Montgomery product; limb axis `limb_dim` (-1 or 0)."""
    if limb_dim == 0:
        return montmul_plain(a.movedim(0, -1), b.movedim(0, -1),
                             field).movedim(-1, 0)
    L = field.L
    a = a.to(I64)
    b = b.to(I64)
    dev = a.device
    t, _ = carry(cols(a, b, 2 * L), rounds=2)            # T, 2L limbs
    m, _ = carry(cols(t[..., :L], field.const("mu_limbs", dev), L),
                 rounds=2)                               # T*mu mod R
    s, c = carry(t + cols(m, field.const("mod_limbs", dev), 2 * L),
                 rounds=2)                               # T + m*p
    return field._cond_sub(s[..., L:], c).to(I32)


_fn = None


def montmul(a, b, field, limb_dim: int = -1):
    """Dispatch: CPU tensors -> plain version; CUDA tensors -> kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return montmul_plain(a, b, field, limb_dim)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"montmul: tensors on {a.device} and {b.device}")
    if a.is_floating_point() or b.is_floating_point():
        raise TypeError("montmul: limbs must be an integer tensor")
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    L = field.L
    if shape[limb_dim] != L:
        raise ValueError(f"montmul: limb axis {limb_dim} of {tuple(shape)} "
                         f"is not {L}")
    a = a.to(I32).contiguous()
    b = b.to(I32).contiguous()
    out = torch.empty(shape, dtype=I32, device=a.device)
    n = a.numel() // L
    if n == 0:
        return out
    if limb_dim in (-1, len(shape) - 1):
        es, ls = L, 1
    elif limb_dim == 0:
        es, ls = 1, n
    else:
        raise ValueError("montmul: limb axis must be first or last")
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_montmul", "ppplllip")
    err = _fn(out.data_ptr(), a.data_ptr(), b.data_ptr(), n, es, ls,
              FIELD_ID[field.name], _build.stream_ptr(a.device))
    _build.check(err, "tpukzg_montmul")
    _build.launches["montmul_" + field.name.lower()] += 1
    return out
