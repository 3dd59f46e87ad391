"""TPUKZG_CHECKED mode: limb-overflow checks (counterpart of
``tpukzg/utils/checked.py``).

* ``enabled()`` — the gate, env ``TPUKZG_CHECKED=1``.
* ``check_limbs(name, arr, bits)`` — every lane of a host array (or
  tensor) is a ``bits``-bit limb.  Called at the API edges when the mode
  is on; on a device tensor it costs a sync, so it is a debug mode.
* ``montmul_golden(a, b, params)`` — the exact Montgomery product by host
  bignums, the oracle the kernels are tested against.
* ``cios_bound_certificate(limb_bits, acc_bits)`` — an executable proof
  that every CIOS intermediate fits its accumulator.  The JAX package's
  CIOS runs on 16-bit limbs in 32-bit lanes; the CUDA sources
  (``csrc/field.cuh``, ``csrc/ec.cuh``) on 32-bit words with 64-bit
  accumulators (``cios_bound_certificate(32, 64)``).

The JAX package's ``shadow_montmul_lm`` replays its Pallas core's 16-bit
column sums in 32-bit lanes; the port's plain product sums whole 32-bit
limb products in int64 columns (``field/mont.py::cols``), which has no
such 32-bit intermediate to audit, so it has no counterpart here.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def enabled() -> bool:
    return os.environ.get("TPUKZG_CHECKED", "0") == "1"


def check_limbs(name: str, arr, bits: int = 16) -> None:
    """Boundary assert: every lane of `arr` is a canonical `bits`-bit
    limb.  No-op unless TPUKZG_CHECKED=1."""
    if not enabled():
        return
    a = np.asarray(arr.cpu() if torch.is_tensor(arr) else arr)
    hi = int(a.max()) if a.size else 0
    if hi >> bits:
        raise AssertionError(
            f"TPUKZG_CHECKED: {name}: limb value {hi:#x} exceeds "
            f"{bits}-bit bound")


def montmul_golden(a, b, params):
    """Exact Montgomery product a*b*R^-1 mod p via host bignums.
    a, b: (L,) limb arrays (16-bit limbs, little-endian) -> (L,) uint32."""
    L = params.L
    ai = sum(int(x) << (16 * i) for i, x in enumerate(np.asarray(a)))
    bi = sum(int(x) << (16 * i) for i, x in enumerate(np.asarray(b)))
    r_inv = pow(1 << (16 * L), params.modulus - 2, params.modulus)
    v = (ai * bi * r_inv) % params.modulus
    return np.array([(v >> (16 * i)) & 0xFFFF for i in range(L)],
                    dtype=np.uint32)


def cios_bound_certificate(limb_bits: int = 16,
                           acc_bits: int = 32) -> dict:
    """Executable static proof of the CIOS accumulator bound: with
    b-bit limbs, every inner-loop intermediate is
        a_j * b_i + t_j + c  <=  (2^b-1)^2 + (2^b-1) + (2^b-1)
                              =  2^(2b) - 1  <  2^acc_bits,
    so the product scan never overflows a 2^acc_bits accumulator.
    Returns the bound facts; raises AssertionError if the invariant
    fails for the given widths."""
    m = (1 << limb_bits) - 1
    worst = m * m + m + m
    assert worst < (1 << acc_bits), (
        f"CIOS bound violated: {worst:#x} >= 2^{acc_bits} "
        f"for {limb_bits}-bit limbs")
    carry_max = worst >> limb_bits
    assert carry_max <= m + 1, "carry bound exceeds one limb + 1"
    return {"limb_bits": limb_bits, "acc_bits": acc_bits,
            "worst_intermediate": worst, "carry_max": carry_max}
