"""Multi-limb Montgomery arithmetic for Fp/Fr on torch tensors.

Counterpart of ``tpukzg/field/mont.py``.  A field element is a tensor of
L little-endian 16-bit limbs on the trailing axis, dtype ``int32`` at
every function boundary (the same values as the JAX package's uint32
arrays).  Fp: L=24 (R = 2^384), Fr: L=16 (R = 2^256).  Mul-heavy values
live in Montgomery form.

The plain ops compute in ``int64`` (torch on the CPU has no uint32 add or
shift) and keep each op to a couple of dozen tensor ops: carries resolve
by one split-and-add followed by a prefix over the limb axis, never by a
Python loop over limbs, because the same code runs eagerly on the card.

Carry prefix.  After the split every limb holds s < 2^16 plus a carry
g in {0, 1}.  Position i passes its incoming carry on only when it
neither generates (g = 1) nor kills (s != 0xFFFF); so the carry out of
position i is g[J] with J the last "decisive" position at or below i —
one ``cummax`` over the limb axis (the Kogge-Stone prefix of
``pallas/montmul.py:_carry_resolve`` in a form torch has as one op).

Every op returns the canonical representative, so any exact formula
gives bit-identical results to the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

B = 16
MASK = (1 << B) - 1

P_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

I32 = torch.int32
I64 = torch.int64


def int_to_limbs(x: int, n_limbs: int) -> np.ndarray:
    return np.array([(x >> (B * i)) & MASK for i in range(n_limbs)],
                    dtype=np.int32)


def ints_to_limbs(xs, n_limbs: int) -> np.ndarray:
    """Non-negative ints below 2^(16 n_limbs) -> (len, n_limbs) int32 limbs
    (through their little-endian bytes: fast for 2^18 values)."""
    buf = b"".join(int(x).to_bytes(2 * n_limbs, "little") for x in xs)
    return np.frombuffer(buf, "<u2").reshape(-1, n_limbs).astype(np.int32)


def limbs_to_int(limbs) -> int:
    out = 0
    for i, v in enumerate(np.asarray(limbs).tolist()):
        out |= int(v) << (B * i)
    return out


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller names a device.
    With no card present and no device given, raise — never fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "tpukzg_torch: no CUDA device; pass device='cpu' to run the "
                "plain tensor path on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def upload(arr, device, dtype=None) -> torch.Tensor:
    """A host array as a tensor on `device`.  To a card it goes through
    pinned memory by a non-blocking copy, so the host does not wait for
    the device (a copy from pageable memory synchronizes the stream)."""
    t = torch.as_tensor(np.require(arr, requirements=("C", "W")),
                        dtype=dtype)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


# ---------------------------------------------------------------------------
# limb primitives (trailing limb axis, int64)
# ---------------------------------------------------------------------------


def carry(x, rounds: int = 1):
    """Canonicalize non-negative int64 limbs to base 2^16.

    rounds = number of split-and-add passes needed before every limb is
    below 2^17: 1 for limbs < 2^32, 2 for limbs < 2^48.
    Returns (limbs (..., K) in [0, 2^16), carry_out (...))."""
    cout = None
    for _ in range(rounds):
        hi = x >> B
        top = hi[..., -1]
        cout = top if cout is None else cout + top
        x = x & MASK
        x[..., 1:] += hi[..., :-1]
    g = x >> B
    s = x
    s &= MASK
    decisive = (g != 0) | (s != MASK)
    # last decisive position at or below i; where there is none, 0 is
    # not decisive either, so g[0] = 0 is the right carry
    last = torch.cummax(torch.where(decisive,
                                    _index("pos", x.shape[-1], x.device), 0),
                        dim=-1).values
    co = torch.gather(g, -1, last)
    s[..., 1:] += co[..., :-1]
    s &= MASK
    return s, cout + co[..., -1]


_INDEX: dict = {}


def _index(kind: str, k: int, device):
    """Cached index tensors: "pos" = arange(k); "diag" = i + j over the
    flattened (i, j) of a k x k outer product; "toeplitz" = the flat
    position of (i, i + j) in a k x (2k - 1) matrix."""
    key = (kind, k, str(device))
    t = _INDEX.get(key)
    if t is None:
        r = torch.arange(k, device=device, dtype=I64)
        if kind == "pos":
            t = r
        elif kind == "diag":
            t = (r[:, None] + r[None, :]).reshape(-1)
        else:
            t = (r[:, None] * (2 * k - 1) + r[:, None] + r[None, :]).reshape(-1)
        t = _INDEX[key] = t
    return t


def cols(a, b, n_cols: int):
    """Column sums of the schoolbook product a*b (int64, trailing limbs):
    (..., L) x (..., L) -> (..., n_cols).  Products are < 2^32 and a column
    holds at most L of them, so sums stay below 2^37: every partial sum is
    an integer below 2^53, exact in float64 and in any order.

    A constant b (one (L,) row: mu, p) is a product with its (L, 2L-1)
    Toeplitz matrix, one float64 matmul.  Otherwise the anti-diagonal sums
    come from one outer product and one ``index_add_`` of its flattened
    (i, j) onto column i + j."""
    L = a.shape[-1]
    if b.dim() == 1:
        t = torch.zeros(L * (2 * L - 1), dtype=torch.float64,
                        device=b.device)
        t[_index("toeplitz", L, b.device)] = b.to(torch.float64).repeat(L)
        c = torch.matmul(a.to(torch.float64),
                         t.reshape(L, 2 * L - 1)).to(I64)
    else:
        o = a.unsqueeze(-1) * b.unsqueeze(-2)              # (..., L, L)
        lead = o.shape[:-2]
        c = torch.zeros(lead + (2 * L - 1,), dtype=o.dtype, device=o.device)
        c.index_add_(-1, _index("diag", L, o.device),
                     o.reshape(lead + (L * L,)))
    if n_cols <= 2 * L - 1:
        return c[..., :n_cols]
    return F.pad(c, (0, n_cols - (2 * L - 1)))


class FieldParams:
    """One prime field in the 16-bit-limb layout, trailing limb axis."""

    suffix_ndim = 1       # trailing axes of an element (the curve code's)

    def __init__(self, name: str, modulus: int, n_limbs: int,
                 plain: bool = False):
        self.name = name
        self.modulus = modulus
        self.L = n_limbs
        self.R = 1 << (B * n_limbs)
        assert self.R > 2 * modulus
        # plain=True: products use the plain tensor montmul on every
        # device (the reference the kernels are checked against);
        # otherwise a CUDA tensor goes through the montmul kernel.
        self.plain = plain
        self.mu_limbs = int_to_limbs((-pow(modulus, -1, self.R)) % self.R,
                                     n_limbs)
        self.mod_limbs = int_to_limbs(modulus, n_limbs)
        self.comp_limbs = int_to_limbs(self.R - modulus, n_limbs)
        self.one_mont = int_to_limbs(self.R % modulus, n_limbs)
        self.r2 = int_to_limbs((self.R * self.R) % modulus, n_limbs)
        self.one_raw = int_to_limbs(1, n_limbs)
        self.zero = np.zeros(n_limbs, np.int32)
        self.one_np, self.zero_np = self.one_mont, self.zero
        # R - 1 - b + 1 limb by limb: a + sub_bias - b = a - b + R
        self.sub_bias = np.full(n_limbs, MASK, np.int32)
        self.sub_bias[0] += 1
        self.half_comp = int_to_limbs(self.R - (modulus - 1) // 2 - 1,
                                      n_limbs)
        self._consts = {}

    def __repr__(self):
        return f"FieldParams({self.name}, L={self.L}, plain={self.plain})"

    @staticmethod
    def _bits(e: int) -> np.ndarray:
        return np.array([(e >> i) & 1 for i in range(e.bit_length())],
                        dtype=np.int32)

    def const(self, name: str, device, dtype=I64):
        key = (name, str(device), dtype)
        t = self._consts.get(key)
        if t is None:
            t = upload(getattr(self, name), device, dtype)
            self._consts[key] = t
        return t

    # ---------------- host codecs ----------------

    def from_int(self, x) -> np.ndarray:
        if isinstance(x, (list, tuple)):
            return ints_to_limbs([int(v) % self.modulus for v in x], self.L)
        return int_to_limbs(int(x) % self.modulus, self.L)

    def to_mont_host(self, x) -> np.ndarray:
        m, R = self.modulus, self.R
        if isinstance(x, (list, tuple)):
            return ints_to_limbs([(int(v) % m) * R % m for v in x], self.L)
        return int_to_limbs((int(x) % m) * R % m, self.L)

    def to_int(self, limbs):
        a = np.asarray(limbs.cpu() if torch.is_tensor(limbs) else limbs)
        if a.ndim == 1:
            return limbs_to_int(a)
        return [limbs_to_int(row) for row in a.reshape(-1, self.L)]

    # ---------------- int64 internals ----------------

    def _cond_sub(self, res, c):
        """(c * R + res) in [0, R + p) -> minus p when >= p (mod R)."""
        u, cu = carry(res + self.const("comp_limbs", res.device))
        return torch.where(((c > 0) | (cu > 0)).unsqueeze(-1), u, res)

    # ---------------- public ops (int32 in, int32 out) ----------------

    def add(self, a, b):
        s = a.to(I64) + b.to(I64)
        both, c = carry(torch.stack(
            [s, s + self.const("comp_limbs", s.device)]))
        return torch.where((c[1] > 0).unsqueeze(-1), both[1],
                           both[0]).to(I32)

    def sub(self, a, b):
        """a - b + R, and the same plus p; the first keeps its carry out
        exactly when a >= b."""
        x1 = (a.to(I64) - b.to(I64)) + self.const("sub_bias", a.device)
        both, c = carry(torch.stack(
            [x1, x1 + self.const("mod_limbs", x1.device)]))
        return torch.where((c[0] > 0).unsqueeze(-1), both[0],
                           both[1]).to(I32)

    def neg(self, a):
        return self.sub(torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        from tpukzg_torch.kernels import montmul as _mm
        if self.plain:
            return _mm.montmul_plain(a, b, self)
        return _mm.montmul(a, b, self)

    def sqr(self, a):
        return self.mul(a, a)

    def mul_small(self, a, k: int):
        assert k > 0
        result = None
        doubled = a
        while k:
            if k & 1:
                result = doubled if result is None else self.add(result,
                                                                 doubled)
            k >>= 1
            if k:
                doubled = self.add(doubled, doubled)
        return result

    def pow_bits(self, a, bits):
        """a ** e for a static LSB-first bit table (leading zeros
        allowed)."""
        return self.pow_int(a, sum(int(v) << i
                                   for i, v in enumerate(np.asarray(bits))))

    def pow_int(self, a, e: int):
        """a ** e.  On a CUDA tensor one launch of the chain kernel;
        otherwise the chain's products one by one, most significant bit
        first, the multiply skipped where the bit is 0 (the same value as
        the JAX fori_loop's select).  e = 0 gives one."""
        from tpukzg_torch.kernels import montmul as _mm
        if e == 0:
            return self.const("one_mont", a.device, I32).expand(
                a.shape).clone()
        if self.plain:
            return _mm.montmul_pow_plain(a, e, self)
        return _mm.montmul_pow(a, e, self)

    def inv(self, a):
        """Fermat inversion a^(p-2); inv(0) = 0."""
        return self.pow_int(a, self.modulus - 2)

    def batch_inv(self, a, axis: int = 0):
        """Montgomery-trick inversion of every element along `axis` (an
        element axis, not the limb axis): prefix and suffix products by
        log-depth Hillis-Steele steps (one batched product each, prefix
        and suffix together), one Fermat inversion of the total, then
        inv(x_i) = prefix_{i-1} * suffix_{i+1} * total^-1.  Zero maps to
        zero (masked to one inside).  Counterpart of
        ``tpukzg/field/mont.py::_batch_inv``."""
        a = a.movedim(axis, 0)
        zero = self.is_zero(a).unsqueeze(-1)
        one = self.const("one_mont", a.device, I32).expand(a.shape)
        x = torch.where(zero, one, a)
        ps = torch.stack([x, x.flip(0)], 1)            # (n, 2, ..., L)
        n, d = ps.shape[0], 1
        while d < n:
            ps = torch.cat([ps[:d], self.mul(ps[d:], ps[:-d])], 0)
            d <<= 1
        prefix, suffix = ps[:, 0], ps[:, 1].flip(0)
        total_inv = self.inv(prefix[-1])
        pre = torch.cat([one[:1], prefix[:-1]], 0)
        suf = torch.cat([suffix[1:], one[:1]], 0)
        out = self.mul(self.mul(pre, suf), total_inv.expand(a.shape))
        out = torch.where(zero, torch.zeros_like(out), out)
        return out.movedim(0, axis)

    def sum_along(self, a, axis: int = 0):
        a = a.movedim(axis, 0)
        n = a.shape[0]
        while n > 1:
            if n % 2 == 1:
                a = torch.cat([a, torch.zeros_like(a[:1])], 0)
                n += 1
            half = n // 2
            a = self.add(a[:half], a[half:])
            n = half
        return a[0]

    def eq(self, a, b):
        return (a == b).all(-1)

    def is_zero(self, a):
        return (a == 0).all(-1)

    def select(self, mask, a, b):
        return torch.where(mask.unsqueeze(-1), a, b)

    def to_mont(self, a):
        return self.mul(a, self.const("r2", a.device, I32))

    def from_mont(self, a):
        return self.mul(a, self.const("one_raw", a.device, I32))

    def gt_half(self, a):
        """canonical(a) > (p-1)/2: a + (R - half - 1) carries out."""
        _, c = carry(a.to(I64) + self.const("half_comp", a.device))
        return c > 0


FP = FieldParams("Fp", P_MOD, 24)
FR = FieldParams("Fr", R_MOD, 16)
FP_PLAIN = FieldParams("Fp", P_MOD, 24, plain=True)
FR_PLAIN = FieldParams("Fr", R_MOD, 16, plain=True)
