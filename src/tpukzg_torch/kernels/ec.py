"""B2: complete projective G1 add (RCB15 Alg. 7, a = 0, b3 = 12), and
B6: complete projective G1 double (RCB15 Alg. 9).

B2 replaces the device function ``tpukzg/pallas/ec.py::ec_add`` (used
inside the bucket-scan kernel).  Here it is the ``__device__`` function
``ec_add`` of ``csrc/ec.cuh``, shared by the bucket-scan kernel, plus a
thin elementwise launcher (``csrc/ec.cu``) so every lane can be checked
alone and so the curve code's adds on the card take one launch.

B6 replaces ``tpukzg/pallas/ec.py::ec_double``: the ``__device__``
functions ``ec_double`` (one thread a point) and ``ec_double_quad`` (four
threads a point, one product of each of the formula's two layers of four
products a thread) of ``csrc/ec.cuh``, and a launcher that doubles each
point t times in a row in one launch (a Horner fold's run of c, a table
window's, a run of the subgroup check's chain).  ``ec_double`` takes the
quad kernel up to ``QUAD_MAX_LANES`` lanes and the one-thread kernel
above (``double_group``); its ``group`` argument forces either.

The plain versions are the same formulas on tensors: 12 (8) field
products issued as two batched products of 6 (4), and the add_mod /
sub_mod / mul_small_mod steps of ``pallas/ec.py:22-68``.  Field results
are canonical, so kernels and plain versions agree bit for bit.
"""

from __future__ import annotations

import torch

from tpukzg_torch.field.limb_major import FP_LM_PLAIN
from tpukzg_torch.field.mont import I32
from tpukzg_torch.kernels import _build


def _bmul(F, pairs):
    lhs = torch.stack(torch.broadcast_tensors(*[a for a, _ in pairs]), 1)
    rhs = torch.stack(torch.broadcast_tensors(*[b for _, b in pairs]), 1)
    prod = F.mul(lhs, rhs)
    return [prod[:, i] for i in range(len(pairs))]


def ec_add_plain(p, q, F):
    """RCB15 Alg. 7 on limb-major coords (L, *batch) over field ops F."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    t0, t1, t2, t3, t4, t5 = _bmul(F, [
        (X1, X2), (Y1, Y2), (Z1, Z2),
        (F.add(X1, Y1), F.add(X2, Y2)),
        (F.add(Y1, Z1), F.add(Y2, Z2)),
        (F.add(X1, Z1), F.add(X2, Z2)),
    ])
    t3 = F.sub(t3, F.add(t0, t1))
    t4 = F.sub(t4, F.add(t1, t2))
    t5 = F.sub(t5, F.add(t0, t2))
    t0 = F.mul_small(t0, 3)
    t2 = F.mul_small(t2, 12)
    z3 = F.add(t1, t2)
    t1 = F.sub(t1, t2)
    y3 = F.mul_small(t5, 12)
    m0, m1, m2, m3, m4, m5 = _bmul(F, [
        (t4, y3), (t3, t1), (y3, t0), (t1, z3), (t0, t3), (z3, t4),
    ])
    return (F.sub(m1, m0), F.add(m3, m2), F.add(m5, m4))


def ec_double_plain(p, F, times: int = 1):
    """RCB15 Alg. 9 (a = 0, b3 = 12) applied `times` times, limb-major
    coords (L, *batch) over field ops F."""
    for _ in range(times):
        X, Y, Z = p
        t0, t1, t2, t3 = _bmul(F, [(Y, Y), (Y, Z), (Z, Z), (X, Y)])
        z8 = F.mul_small(t0, 8)
        t2 = F.mul_small(t2, 12)
        t6 = F.sub(t0, F.mul_small(t2, 3))
        y3t = F.add(t0, t2)
        m0, m1, m2, m3 = _bmul(F, [(t2, z8), (t1, z8), (t6, y3t),
                                   (t6, t3)])
        p = (F.add(m3, m3), F.add(m2, m0), m1)
    return p


def _device_of(name, coords):
    devs = {c.device for c in coords}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _limb_major(name, coords):
    """Contiguous int32 (24, *batch) copies, their shape and lane count;
    raises on another limb axis."""
    shape = coords[0].shape
    if shape[0] != 24:
        raise ValueError(f"{name}: limb axis of {tuple(shape)} is not 24")
    return ([c if c.dtype == I32 and c.is_contiguous()
             else c.to(I32).contiguous() for c in coords], shape,
            coords[0].numel() // 24)


_fn = None
_fn_double = None

# Lane counts up to which B6 runs four threads a point: there a run is
# bound by its chain of dependent products, which the quad kernel cuts
# from 8 to 2 a doubling; above it the card is full either way and the
# one-thread kernel does less work a point.  Set from the times of both
# kernels on the card (PERF.md section 6, B6 rows).
QUAD_MAX_LANES = 1 << 14


def double_group(n: int) -> int:
    """Threads a point B6 runs on n lanes: 4 (quad kernel) or 1."""
    return 4 if n <= QUAD_MAX_LANES else 1


def ec_add(p, q):
    """p + q on limb-major (X, Y, Z) coords of (24, *batch); the batch
    axes broadcast.  CPU tensors -> plain version; CUDA tensors -> the
    elementwise kernel."""
    dev = _device_of("ec_add", list(p) + list(q))
    coords = torch.broadcast_tensors(*p, *q)
    if dev.type == "cpu":
        return ec_add_plain(tuple(coords[:3]), tuple(coords[3:]), FP_LM_PLAIN)
    coords, shape, n = _limb_major("ec_add", coords)
    out = [torch.empty(shape, dtype=I32, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(out)
    es, ls = 1, n                                  # element i, limb j: i + j n
    global _fn
    if _fn is None:
        _fn = _build.fn("tpukzg_ec_add", "ppppppppplllp")
    err = _fn(*[o.data_ptr() for o in out], *[c.data_ptr() for c in coords],
              n, es, ls, _build.stream_ptr(dev))
    _build.check(err, "tpukzg_ec_add")
    _build.launches["ec_add"] += 1
    return tuple(out)


def ec_double(p, times: int = 1, group: int | None = None):
    """[2^times] P on limb-major (X, Y, Z) coords of (24, *batch); the
    batch axes broadcast.  CPU tensors -> plain version; CUDA tensors ->
    one launch for the whole run of doublings, by `group` threads a point
    (1 or 4; None: what ``double_group`` picks for the lane count)."""
    if times < 0:
        raise ValueError(f"ec_double: times={times} < 0")
    if group not in (None, 1, 4):
        raise ValueError(f"ec_double: {group} threads a point")
    dev = _device_of("ec_double", p)
    coords = p if p[0].shape == p[1].shape == p[2].shape else \
        torch.broadcast_tensors(*p)
    if dev.type == "cpu":
        return ec_double_plain(tuple(coords), FP_LM_PLAIN, times)
    coords, shape, n = _limb_major("ec_double", coords)
    if times == 0:
        return tuple(coords)
    out = [torch.empty(shape, dtype=I32, device=dev) for _ in range(3)]
    if n == 0:
        return tuple(out)
    group = double_group(n) if group is None else group
    global _fn_double
    if _fn_double is None:
        _fn_double = _build.fn("tpukzg_ec_double", "ppppppllliip")
    err = _fn_double(*[o.data_ptr() for o in out],
                     *[c.data_ptr() for c in coords], n, 1, n, times, group,
                     _build.stream_ptr(dev))
    _build.check(err, "tpukzg_ec_double")
    _build.launches["ec_double"] += 1
    return tuple(out)
