"""B5: all radix-2 stages of an Fr NTT / iNTT, with the inverse's 1/n.

Replaces ``tpukzg/pallas/ntt.py::_ntt_kernel`` (entered through
``NttPallas.ntt``/``intt``).  The TPU kernel kept one polynomial in a
VMEM tile, paired lanes with rolls and a parity mask, multiplied all n
lanes by per-lane twiddle tables (twice the work a butterfly needs) and
left the bit-reversal to a gather outside.  ``csrc/ntt.cu`` instead:

* ``tpukzg_ntt_block``: one block per chunk of m = min(n, BLOCK_N)
  elements, words in shared memory (32 B per element; 128 KB at
  m = 4096).  The bit-reversal is folded into the load; stages 0 ..
  log2(m) - 1 run there, n/2 butterflies a stage, one barrier between
  stages.  When m = n that is the whole transform, the inverse's 1/n
  applied on the way out.
* ``tpukzg_ntt_stage``: each remaining stage (n > BLOCK_N) as one pass
  over device memory, one thread per butterfly; the last pass applies
  the inverse's 1/n.

Twiddles come from one table of n/2 roots per direction (stage s takes
root j * (n >> (s+1))), kept on the device by the plan.  Field results
are canonical, so any correct butterfly order gives the plain version's
bits exactly.

The plain version is the stage loop of ``tpukzg/ntt/ntt.py:112-124``.
"""

from __future__ import annotations

import torch

from tpukzg_torch.field.mont import FR_PLAIN, I32
from tpukzg_torch.kernels import _build

BLOCK_N = 4096

_fns: dict = {}


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


def _fn(name, sig):
    f = _fns.get(name)
    if f is None:
        f = _fns[name] = _build.fn(name, sig)
    return f


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
    xin = x.reshape((-1, n, 16)).to(I32).contiguous()
    k = xin.shape[0]
    out = torch.empty_like(xin)
    if k == 0:
        return out.reshape(x.shape)
    tw = plan.on(dev, "tw_inv" if inverse else "tw_fwd")
    scale = plan.on(dev, "n_inv")
    m = min(n, BLOCK_N)
    log_m = m.bit_length() - 1
    stream = _build.stream_ptr(dev)
    err = _fn("tpukzg_ntt_block", "pppplllip")(
        out.data_ptr(), xin.data_ptr(), tw.data_ptr(), scale.data_ptr(),
        k, n, m, int(inverse and m == n), stream)
    _build.check(err, "tpukzg_ntt_block")
    _build.launches["ntt"] += 1
    for s in range(log_m, plan.log_n):
        err = _fn("tpukzg_ntt_stage", "ppplliip")(
            out.data_ptr(), tw.data_ptr(), scale.data_ptr(), k, n, s,
            int(inverse and s == plan.log_n - 1), stream)
        _build.check(err, "tpukzg_ntt_stage")
        _build.launches["ntt"] += 1
    return out.reshape(x.shape)
