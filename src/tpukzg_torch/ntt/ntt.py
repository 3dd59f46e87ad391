"""Radix-2 NTT / iNTT over Fr on the size-n subgroup (counterpart of
``tpukzg/ntt/ntt.py``).

The plan holds the roots of unity in Montgomery form, the bit-reversal
permutation, 1/n, one twiddle table of n/2 roots per direction (stage s
takes root j * (n >> (s+1)), so no per-stage or per-lane tables) and
the coset tables of g = 7.  Its tensors are put on a device once and
kept there (``on``).

``ntt``/``intt``/``coset_ntt``/``coset_intt`` take (..., n, 16)
Montgomery natural-order limbs.  On the card the butterflies are kernel
B5 (``kernels/ntt.py``); on the CPU its plain version, the stage loop of
``tpukzg/ntt/ntt.py:112-124``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpukzg_torch.field.mont import FR, R_MOD
from tpukzg_torch.kernels import ntt as _kernel

TWO_ADICITY = 32
OMEGA_2_32 = 0x16A2A19EDFE81F20D09B681922C813B4B63683508C2280B93829971F439F0D2B
COSET_GEN = 7   # multiplicative generator of Fr*


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


def _powers(g: int, n: int) -> list[int]:
    out, w = [], 1
    for _ in range(n):
        out.append(w)
        w = (w * g) % R_MOD
    return out


class NttPlan:
    def __init__(self, n: int):
        assert n & (n - 1) == 0 and n >= 2
        self.n = n
        self.omega = omega_for(n)
        self.log_n = n.bit_length() - 1
        self.roots_int = _powers(self.omega, n)
        self.roots = FR.to_mont_host(self.roots_int)         # (n, 16)
        self.brp = bit_reverse_indices(n)
        self.n_inv = FR.to_mont_host(pow(n, R_MOD - 2, R_MOD))
        # w^j and w^-j = w^(n-j) for j < n/2: the twiddles of every stage
        half = np.arange(n // 2)
        self.tw_fwd = self.roots[half]
        self.tw_inv = self.roots[(n - half) % n]
        self._dev: dict = {}

    @functools.cached_property
    def coset_pow(self) -> np.ndarray:
        """g^i, Montgomery (n, 16)."""
        return FR.to_mont_host(_powers(COSET_GEN, self.n))

    @functools.cached_property
    def coset_pow_inv(self) -> np.ndarray:
        """g^-i, Montgomery (n, 16)."""
        return FR.to_mont_host(_powers(pow(COSET_GEN, R_MOD - 2, R_MOD),
                                       self.n))

    def stage_twiddles(self, s: int, inverse: bool) -> np.ndarray:
        """(2^s, 16): the twiddles w^(+-j n / 2^(s+1)) of stage s."""
        tab = self.tw_inv if inverse else self.tw_fwd
        return tab[::self.n >> (s + 1)]

    def on(self, device, name: str):
        """The plan's table `name` (tw_fwd, tw_inv, n_inv, brp, coset_pow,
        coset_pow_inv) as a tensor on `device`, put there once."""
        key = (name, str(torch.device(device)))
        t = self._dev.get(key)
        if t is None:
            t = self._dev[key] = torch.as_tensor(
                np.ascontiguousarray(getattr(self, name)), device=device)
        return t

    def ntt(self, coeffs):
        """Coefficients -> evaluations at w^0..w^(n-1)."""
        return _kernel.ntt(coeffs, self, inverse=False)

    def intt(self, evals):
        return _kernel.ntt(evals, self, inverse=True)

    def coset_ntt(self, coeffs):
        """Evaluations on the coset {g w^i}: coefficient i times g^i,
        then the NTT."""
        return self.ntt(FR.mul(coeffs, self.on(coeffs.device, "coset_pow")))

    def coset_intt(self, evals):
        return FR.mul(self.intt(evals), self.on(evals.device, "coset_pow_inv"))


@functools.lru_cache(maxsize=None)
def get_plan(n: int) -> NttPlan:
    return NttPlan(n)
