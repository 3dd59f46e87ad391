"""B1: elementwise Montgomery product a*b*R^-1 mod p, and the chain launch
a^e (a whole square-and-multiply chain in one launch), kernels and plain
versions.

Replaces ``tpukzg/pallas/montmul.py::_montmul_kernel`` (the standalone
lane-tiled kernel) and carries its core ``_montmul_lm_core`` as the
``__device__`` function ``mont_mul`` of ``csrc/field.cuh`` that the
bucket-scan and fraction-tree kernels share.

The kernel (``csrc/montmul.cu``) takes 16-bit limbs in int32, in either
layout: trailing (..., L) or limb-major (L, ...).  On a CUDA tensor every
field product of the port's plain tensor code comes here (one launch per
batched product instead of ~100 tensor ops); on a CPU tensor the plain
version below runs.

``montmul_pow`` runs a pow chain (a Fermat inversion, the square root)
as one launch of the same source's chain kernel; its plain version,
``montmul_pow_plain``, runs the chain's products one by one with
``montmul_plain``.

Plain version: the separated reduction of ``pallas/montmul.py:114-122``
    T = a*b;  m = (T mod R) * mu mod R;  t = (T + m*p) / R;  t -= p if >= p
with int64 column sums and prefix carries (``field/mont.py``).  Both
return the same canonical bits: CIOS on 32-bit words computes the same
t = (T + m p)/R, since the word-by-word m is the unique m < R with
T + m p = 0 mod R.
"""

from __future__ import annotations

import ctypes

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


def exp_bits(e: int):
    """e's bits, most significant first, the top one dropped: a chain
    starts from acc = a, then squares at each bit and multiplies where
    it is 1 (e >= 1)."""
    return [int(c) for c in bin(e)[3:]]


def montmul_pow_plain(a, e: int, field, limb_dim: int = -1):
    """a^e, e >= 1, by the products of the chain kernel in its order, each
    a plain tensor product."""
    acc = a
    for bit in exp_bits(e):
        acc = montmul_plain(acc, acc, field, limb_dim)
        if bit:
            acc = montmul_plain(acc, a, field, limb_dim)
    return acc


_fn_pow = None
_words: dict = {}


def _exp_words(e: int):
    w = _words.get(e)
    if w is None:
        w = _words[e] = (ctypes.c_uint32 * 12)(
            *[(e >> (32 * k)) & 0xFFFFFFFF for k in range(12)])
    return w


def _element_rows(a, L: int):
    """a (..., L) as an (n, L) view whose rows are elements, read in place
    when its layout is trailing or limb-major (a moved view of (L, ...)),
    else a contiguous copy."""
    n = a.numel() // L
    try:
        v = a.view(n, L)
    except RuntimeError:
        v = None
    if v is None or v.stride() not in ((L, 1), (1, n)):
        v = a.contiguous().view(n, L)
    return v


def montmul_pow(a, e: int, field):
    """a^e (1 <= e < 2^384) on the trailing limb axis, in a's layout (a
    limb-major tensor moved to a trailing view stays in place).  CPU
    tensors -> plain version; CUDA tensors -> the chain kernel, one
    launch."""
    if not 1 <= e < 1 << 384:
        raise ValueError(f"montmul_pow: exponent of {e.bit_length()} bits")
    if a.device.type == "cpu":
        return montmul_pow_plain(a, e, field)
    if a.device.type != "cuda":
        raise ValueError(f"montmul_pow: tensor on {a.device}")
    if a.is_floating_point():
        raise TypeError("montmul_pow: limbs must be an integer tensor")
    L = field.L
    if a.shape[-1] != L:
        raise ValueError(f"montmul_pow: limb axis of {tuple(a.shape)} is "
                         f"not {L}")
    v = _element_rows(a.to(I32), L)
    n = v.shape[0]
    out = torch.empty_strided(v.shape, v.stride(), dtype=I32,
                              device=a.device)
    if n == 0:
        return out.view(a.shape)
    global _fn_pow
    if _fn_pow is None:
        _fn_pow = _build.fn("tpukzg_montmul_pow", "pplllpiip")
    es, ls = v.stride()
    err = _fn_pow(out.data_ptr(), v.data_ptr(), n, es, ls,
                  ctypes.addressof(_exp_words(e)), e.bit_length(),
                  FIELD_ID[field.name], _build.stream_ptr(a.device))
    _build.check(err, "tpukzg_montmul_pow")
    _build.launches["montmul_pow_" + field.name.lower()] += 1
    return out.view(a.shape)
