"""Host plan of the size-n evaluation domain (counterpart of the host part
of ``tpukzg/ntt/ntt.py``): roots of unity in Montgomery form, the
bit-reversal permutation and 1/n.  The butterflies themselves are not
part of the verify path."""

from __future__ import annotations

import functools

import numpy as np

from tpukzg_torch.field.mont import FR, R_MOD

TWO_ADICITY = 32
OMEGA_2_32 = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B


def omega_for(n: int) -> int:
    assert n & (n - 1) == 0 and 0 < n <= (1 << TWO_ADICITY)
    w, m = OMEGA_2_32, 1 << TWO_ADICITY
    while m > n:
        w = (w * w) % R_MOD
        m >>= 1
    return w


def bit_reverse_indices(n: int) -> np.ndarray:
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class NttPlan:
    def __init__(self, n: int):
        assert n & (n - 1) == 0 and n >= 2
        self.n = n
        self.omega = omega_for(n)
        self.log_n = n.bit_length() - 1
        r, w = [], 1
        for _ in range(n):
            r.append(w)
            w = (w * self.omega) % R_MOD
        self.roots_int = r
        self.roots = FR.to_mont_host(r)                      # (n, 16)
        self.brp = bit_reverse_indices(n)
        self.n_inv = FR.to_mont_host(pow(n, R_MOD - 2, R_MOD))


@functools.lru_cache(maxsize=None)
def get_plan(n: int) -> NttPlan:
    return NttPlan(n)
