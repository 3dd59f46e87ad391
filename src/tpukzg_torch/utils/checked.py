"""TPUKZG_CHECKED mode: limb-overflow checks (counterpart of
``tpukzg/utils/checked.py``).

* ``enabled()`` — the gate, env ``TPUKZG_CHECKED=1``.
* ``check_limbs(name, arr, bits)`` — every lane of a host array (or
  tensor) is a ``bits``-bit limb.  Called at the API edges when the mode
  is on; on a device tensor it costs a sync, so it is a debug mode.
* ``montmul_golden(a, b, params)`` — the exact Montgomery product by host
  bignums, the oracle the kernels are tested against.
* ``cios_bound_certificate(limb_bits, acc_bits)`` — an executable proof
  that every CIOS inner-product term fits its accumulator.  The JAX
  package's CIOS runs on 16-bit limbs in 32-bit lanes; the CUDA sources
  (``csrc/field.cuh``, ``csrc/ec.cuh``) on 32-bit words with 64-bit
  accumulators (``cios_bound_certificate(32, 64)``).
* ``shadow_montmul_lm(a, b, params)`` and ``shadow_fp_mul_rows(a, b)`` —
  the overflow audits of the port's device products, the counterparts of
  the JAX package's ``shadow_montmul_lm``.

The shadows.  The certificate bounds one inner-product term; it says
nothing of the places where the CUDA products drop a carry or a word on
purpose, trusting that it is zero.  A carry lost there gives a wrong
product with no error.  The JAX package's shadow replays its Pallas
core's 16-bit column sums and asserts that none leaves its 32-bit lane;
the port's device products are CIOS on 32-bit words, so their shadows
replay those, word by word in exact Python integers (numpy object arrays,
one element a lane), on the kernels' own inputs (L, N) 16-bit limbs
repacked into words as ``load_words`` does:

* ``shadow_montmul_lm`` replays ``mont_mul<F>`` of ``csrc/field.cuh``
  (Fp and Fr: B1, its chain launch, the four-thread B6, B4 and B5) and
  its ``cond_sub``, and asserts that every 64-bit ``s`` fits 64 bits,
  every carry ``c`` 32 bits, that ``t[N + 1]`` is at most 1 and that the
  32-bit sum ``t[N] = t[N + 1] + (s >> 32)``, whose carry-out the
  source drops, does not wrap.
* ``shadow_fp_mul_rows`` runs ``fp_mul`` of ``csrc/ec.cuh`` (Fp: B2, B3
  and the one-thread B6), whose rows are inline PTX: it reads the two
  ``asm`` blocks from the source and executes them instruction by
  instruction with PTX's carry flag, and asserts that every ``addc.u32``
  (no ``.cc``: its carry-out is dropped) has a carry-out of 0 and that
  the word that ``mov.u32`` clears was 0.

Both return the result as (L, N) 16-bit limbs and the largest value seen
at each site.  Nothing on the main path calls them: the tests and
``chip_smoke.py`` hold the kernels against them, as the JAX package's
tests hold its Pallas kernel against its shadow.
"""

from __future__ import annotations

import os
import re

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


# The widths each shadow holds its sites to: the 64-bit accumulators
# (uint64_t) and the 32-bit words (uint32_t, PTX .u32) of the CUDA
# products.  The replayed arithmetic itself is fixed at 32-bit words.
ACC_BITS = 64
WORD_BITS = 32
_M32 = (1 << 32) - 1
_M64 = (1 << 64) - 1
_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")


def _track(bounds: dict, name: str, v, bits: int) -> None:
    """Record the largest value of `v` (lanes) at site `name`; raise if
    it does not fit `bits` bits."""
    m = int(np.max(v)) if np.size(v) else 0
    bounds[name] = max(bounds.get(name, 0), m)
    if m >> bits:
        raise AssertionError(
            f"TPUKZG_CHECKED shadow: {name} = {m:#x} does not fit {bits} "
            "bits")


def _words(x_lm, n: int):
    """(2n, ...) 16-bit limbs -> (n object arrays of 32-bit words, one
    element a lane, packed as ``load_words`` packs them; the shape)."""
    x = np.asarray(x_lm.cpu() if torch.is_tensor(x_lm) else x_lm)
    if x.shape[0] != 2 * n:
        raise ValueError(f"shadow: limb axis of {x.shape} is not {2 * n}")
    shape = x.shape
    x = x.astype(np.int64).reshape(2 * n, -1)
    return [((x[2 * j] & 0xFFFF) | ((x[2 * j + 1] << 16) & _M32))
            .astype(object) for j in range(n)], shape


def _limbs(words, shape) -> np.ndarray:
    """Words -> uint32 16-bit limbs of `shape` (``store_limbs``)."""
    out = np.empty((2 * len(words), len(words[0])), np.uint32)
    for j, w in enumerate(words):
        w = np.asarray(w, dtype=np.uint64)
        out[2 * j] = w & 0xFFFF
        out[2 * j + 1] = w >> 16
    return out.reshape(shape)


def _field_words(modulus: int, n: int):
    """p as n words, and INV = -p^-1 mod 2^32 (``FpT``/``FrT``)."""
    return ([(modulus >> (32 * j)) & _M32 for j in range(n)],
            (-pow(modulus, -1, 1 << 32)) % (1 << 32))


def _cond_sub(t, carry, p):
    """``cond_sub`` (field.cuh): t - p where carry != 0 or t >= p."""
    d, borrow = [], 0
    for tj, pj in zip(t, p):
        s = (tj - pj - borrow) & _M64          # the uint64_t wraps
        d.append(s & _M32)
        borrow = s >> 63
    ge = (carry != 0) | (borrow == 0)
    return [np.where(ge, dj, tj) for dj, tj in zip(d, t)]


def shadow_montmul_lm(a_lm, b_lm, params):
    """Replay ``mont_mul<F>`` (csrc/field.cuh) on (L, N) 16-bit limbs ->
    (result (L, N) uint32 limbs, {site: largest value}).  Raises
    AssertionError where a site leaves its width (module docstring)."""
    n = params.L // 2
    p, inv = _field_words(params.modulus, n)
    (a, shape), (b, _) = _words(a_lm, n), _words(b_lm, n)
    bounds: dict = {}
    zero = np.zeros(a[0].shape, object)
    t = [zero] * (n + 2)
    for i in range(n):
        c = zero
        for j in range(n):
            s = a[j] * b[i] + t[j] + c
            _track(bounds, "s", s, ACC_BITS)
            t[j], c = s & _M32, s >> 32
            _track(bounds, "c", c, WORD_BITS)
        s = t[n] + c
        _track(bounds, "s", s, ACC_BITS)
        t[n], t[n + 1] = s & _M32, s >> 32
        _track(bounds, "t_top", t[n + 1], 1)
        m = (t[0] * inv) & _M32                 # wraps by design
        s = m * p[0] + t[0]
        _track(bounds, "s", s, ACC_BITS)
        c = s >> 32
        _track(bounds, "c", c, WORD_BITS)
        for j in range(1, n):
            s = m * p[j] + t[j] + c
            _track(bounds, "s", s, ACC_BITS)
            t[j - 1], c = s & _M32, s >> 32
            _track(bounds, "c", c, WORD_BITS)
        s = t[n] + c
        _track(bounds, "s", s, ACC_BITS)
        t[n - 1] = s & _M32
        top = t[n + 1] + (s >> 32)              # its carry-out is dropped
        _track(bounds, "top_sum", top, WORD_BITS)
        t[n] = top & _M32
    # the carry cond_sub is given: one subtraction of p must do
    _track(bounds, "carry_in", t[n], 1)
    return _limbs(_cond_sub(t[:n], t[n], p), shape), bounds


def _fp_mul_rows_source():
    """The ``asm`` blocks of ``fp_mul`` in csrc/ec.cuh, in order -> for
    each, the C expressions of its operands %0, %1, ... and its
    instructions as (line in ec.cuh, opcode, operands)."""
    with open(os.path.join(_CSRC, "ec.cuh")) as fh:
        src = fh.read()
    start = src.index("void fp_mul(")
    end = src.index("\n}\n", start)
    blocks = []
    for m in re.finditer(r"asm\((.*?)\);", src[start:end], re.S):
        text, operands = m.group(1).split(":", 1)
        insns = []
        for lit in re.finditer(r'"([^"]*)"', text):
            line = src.count("\n", 0, start + m.start(1) + lit.start()) + 1
            for ins in lit.group(1).split(";"):
                ins = ins.replace("\\n", "").replace("\\t", "").strip()
                if ins:
                    opcode, args = ins.split(None, 1)
                    insns.append((line, opcode,
                                  [a.strip() for a in args.split(",")]))
        blocks.append((re.findall(r'"\+?r"\(([^)]*)\)', operands), insns))
    return blocks


def _run_ptx(insns, reg, bounds) -> None:
    """Execute PTX add and multiply-add rows on `reg` (operand index ->
    lanes) with the carry flag: .cc writes it, addc/madc read it, an
    instruction without .cc leaves it and drops its own carry-out."""
    cf = None

    def val(x):
        return reg[int(x[1:])] if x.startswith("%") else int(x, 0)

    for line, opcode, args in insns:
        parts = opcode.split(".")
        d = int(args[0][1:])
        if parts[0] == "mov":
            _track(bounds, f"cleared@ec.cuh:{line}", reg[d], 0)
            reg[d] = np.full(np.shape(reg[d]), val(args[1]), object)
            continue
        if parts[0] in ("mad", "madc"):
            prod = val(args[1]) * val(args[2])
            x = prod & _M32 if parts[1] == "lo" else prod >> 32
            y = val(args[3])
        elif parts[0] in ("add", "addc"):
            x, y = val(args[1]), val(args[2])
        else:
            raise ValueError(f"ec.cuh:{line}: {opcode} is not replayed")
        s = x + y
        if parts[0].endswith("c"):
            if cf is None:
                raise AssertionError(f"ec.cuh:{line}: {opcode} reads the "
                                     "carry flag before it is set")
            s = s + cf
        if "cc" in parts:
            _track(bounds, "cc_sum", s, WORD_BITS + 1)
            cf = s >> 32
        else:
            _track(bounds, f"dropped@ec.cuh:{line}", s, WORD_BITS)
        reg[d] = s & _M32


def shadow_fp_mul_rows(a_lm, b_lm):
    """Run ``fp_mul`` (csrc/ec.cuh, Fp) on (24, N) 16-bit limbs ->
    (result (24, N) uint32 limbs, {site: largest value}).  Each of the
    12 rows runs the product block with b's word i, then the reduction
    block with m = t[0] INV mod 2^32; then ``cond_sub`` with t[12] as the
    carry.  Raises AssertionError where a dropped carry or a cleared word
    was not 0."""
    from tpukzg_torch.field.mont import P_MOD
    p, inv = _field_words(P_MOD, 12)
    (a, shape), (b, _) = _words(a_lm, 12), _words(b_lm, 12)
    bounds: dict = {}
    t = [np.zeros(len(a[0]), object)] * 14
    blocks = _fp_mul_rows_source()
    for i in range(12):
        for operands, insns in blocks:
            env = {"t": t, "a": a, "bi": b[i], "m": (t[0] * inv) & _M32}
            exprs = [re.fullmatch(r"(\w+)(?:\[(\d+)\])?", e).groups()
                     for e in operands]
            reg = {k: env[v] if i_ is None else env[v][int(i_)]
                   for k, (v, i_) in enumerate(exprs)}
            _run_ptx(insns, reg, bounds)
            for k, (v, i_) in enumerate(exprs):
                if v == "t":
                    t[int(i_)] = reg[k]
    _track(bounds, "carry_in", t[12], 1)
    return _limbs(_cond_sub(t[:12], t[12], p), shape), bounds
