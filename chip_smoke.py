#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/tpukzg_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # one card, no arguments
    python3 chip_smoke.py --bary SRC # barycentric_eval of SRC/tpukzg_torch
                                     # alone, timed (see bary_main)
    python3 chip_smoke.py --verify SRC  # the k=256 verify of
                                     # SRC/tpukzg_torch alone, timed and
                                     # counted (see verify_main)
    python3 chip_smoke.py --dist     # the multi-GPU phase alone, on
                                     # every card present (dist_main)

Phases, each printed on its own line:
  1. the card (nvidia-smi name and power limit) and torch's CUDA version;
  2. the kernels built from csrc/ (nvcc), with the build seconds, and
     each source's kernels with their registers and spill (ptxas);
     B1 (the product and the chain launch), B2, B3, B4, B5 and both B6
     kernels must spill nothing;
  3. B1 montmul (Fp, Fr; 2^20 lanes), B2 ec_add (2^16 lanes) and B6
     ec_double (2^16 lanes, one doubling; both kernels, one thread a
     point and four) against their plain tensor versions, bit for bit;
     B1 (Fp, Fr; 256 lanes with R - 1, p - 1, 0, 1 and R mod p in both
     operands) against the CIOS shadow of utils/checked.py, bit for bit,
     with the shadow's bounds;
     B1 beside an elementwise PyTorch op with its loads and stores (the
     floor of its access pattern); both B6 kernels timed at 4096 to 131072 lanes (the launcher's
     crossover);
  4. the main path: verify_blob_kzg_proof_batch on the n=4096 SRS and the
     bench fixtures — a k=8 warm-up, k=256 (True, launch counts taken
     around this run alone), k=256 with one tampered proof byte (False)
     and k=256 with two proofs swapped (False, decided by the pairing);
     B1's launches on the valid run (the product's and the chain
     launch's) must be those of B1_LAUNCHES;
     then the async entry on the valid batch (True; resolved at once it
     is the sync path, timed); bench.py's pipelined schedule over four
     k=256 batches (valid, tampered, swapped, valid: True, False, False,
     True, as the sync path), stages 1 and 2 under sync debug mode
     "error" but for the y readback, then again without the debug mode
     for the sustained seconds a batch; the chunked entry at chunk 64 (True, and
     False with one blob of the third chunk tampered); the CLI's bench
     verb (`python -m tpukzg_torch.cli bench --k 256 --reps 4`) in a child
     process, its line checked (metric, value > 0, the card's name in the
     unit) and printed beside the pipeline's own rate, and every kernel
     of the verify launched in its timed reps; then one more
     k=256 verify with its tensor ops counted, and one under
     torch.profiler for the device's busy share;
  5. B6 ec_double (both kernels) against its plain version on the runs
     the k=256 verify gave it (the fold's 2 lanes x 8, the subgroup
     check's 512 lanes x 32); B1's chain launch against the plain chain
     on the verify's three chains (the decompress square root on 512
     lanes, the pairing's and the final exponentiation's Fp
     inversions); then B3 bucket scan and B4 fraction tree on the very
     inputs the k=256 run gave them (one z moved in-domain); B3 launched
     twice must give the same limbs;
  6. the prover path on the 16 fixture blobs (launch counts taken around
     each step alone, B1's checked against B1_LAUNCHES): the fixed-base
     tables (B6 held against its plain version on one window's run of
     4096 lanes x 11), the chain launch on the proof batch's two Fr
     inversions, blob_to_kzg_commitment_batch and
     compute_blob_kzg_proof_batch byte-equal to the fixture, accepted by
     verify_blob_kzg_proof_batch, and one more commit batch under
     torch.profiler for the device's busy share; interpolate (iNTT,
     B5), commit_coeff and open_coeff (NTT, B5) giving the same bytes, and
     to_evals(interpolate(e)) == e; one in-domain and two out-of-domain
     openings accepted by Kzg.verify_batch (and one wrong y refused);
  7. B5 NTT against its plain version on the prover path's own
     (16, 4096) inputs, both directions, and at n = 2^18 (one seeded
     polynomial, at most 3 passes); B4 on the proof batch's own
     (16, 4096) input (one z moved in-domain); B3 on one chunk the
     fixed-base MSM launched (rows of 98,304 lanes) and on one of its
     suffix scans, each twice; every B3, B4 and B5 check reports the grid
     the launcher ran, and the fixed-base chunk's local pass, B5's first
     pass at (16, 4096) and B4 at k = 16 must each run at least one block
     an SM; then B5 and B4 timed at other splits and grids than the
     launchers' (the evidence for their choice);
  8. the setup paths, each with its launch counts and the card's name
     and power limit on every line: the n = 4096 setup generated from
     scratch (tau = 0xDEADBEEF) into a temporary directory, equal to the
     committed SRS in affine form, with the lines of the committed G2
     points bit for bit, and the fixtures' commitments and proofs on it
     byte for byte (and verified); the committed SRS compressed and
     loaded by from_compressed (equal, the fixtures verify) and three bad
     inputs refused; verify_kzg_proof True for an out-of-domain and an
     in-domain z, False for a wrong y and a wrong proof; the public MSM
     over 2^20 points (8 chunks of 2^17) equal to [sum k_i d_i] G1, and
     B3 on one row of a chunk against its plain version; B6's launches on
     every path;
  9. the windowed ladder (what scalar_mul runs on the card) against the
     256-step ladder in affine form on G1 (24, 2) and (24, 8192) and on
     G2 (the setup generation and verify_kzg_proof above already ran it:
     B2 and B6 held there on its step adds and runs of 4 doublings);
     pairing(G1, G2) equal to golden's value (computed on the host) and
     e([a] P, Q) == e(P, [a] Q); the generic Pippenger over 64 G2 points
     equal to golden; msm_batch with k = 16 rows over the n = 4096
     Lagrange points equal to 16 calls of msm, and B3 on its first chunk
     of rows against its plain version; then the multi-GPU paths
     through tpukzg_torch.dist.launch at world size = the cards present
     (NCCL, one card a rank, the kernels built by this process first):
     ShardedMsm over 2^22 points equal to the single-device msm,
     DistNtt at 2^18 equal to NttPlan bit for bit (forward and
     inverse), ShardedBatchVerifier on the k = 256 valid, tampered and
     swapped batches giving the sync path's verdicts; B5 at the column
     and row batches of the split DistNtt used; B2's and B6's launches
     on every path;
 10. one JSON line of kernel numbers, then the result line.  For every
     kernel `ms` is its time on the card (CUDA-graph replays, no host
     time: graph_ms) and `call_ms` the time around one Python call of
     its wrapper (CUDA events: cuda_ms), at the same inputs.
Any failure exits non-zero before the result line.  The script never
falls back to the CPU and imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import collections
import contextlib
import gc
import glob
import json
import os
import re
import statistics
import subprocess
import sys
import time
import traceback

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(REPO, "src"))

# Peak rates of one H100 SXM (data sheet): HBM3 bytes/s, and the 67 TFLOP/s
# float32 rate outside the tensor cores, taken as the ceiling for 32-bit
# integer multiply-adds (one multiply-add = 2 operations).
HBM_BYTES_S = 3.35e12
OPS_S = 67e12
# A 32x32->64-bit word product is two multiply-adds (low and high half).
OPS_PER_WORD_PRODUCT = 4


def montmul_ops(words: int) -> int:
    """CIOS: a*b and m*p (words^2 each) plus m (words) word products."""
    return (2 * words * words + words) * OPS_PER_WORD_PRODUCT


EC_ADD_OPS = 12 * montmul_ops(12)
EC_DOUBLE_OPS = 8 * montmul_ops(12)
REPS = 10          # timed launches per kernel (median reported)


def bound_ms(nbytes: float, ops: float):
    tb = nbytes / HBM_BYTES_S * 1e3
    to = ops / OPS_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def say(*a):
    print(*a, flush=True)


class Fail(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise Fail(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    fn()                                    # warm
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def graph_ms(torch, fn, reps: int, calls: int = 10) -> float:
    """The device time of one fn(): `calls` calls captured in one CUDA
    graph, the graph replayed `reps` times between two CUDA events.  No
    host time counts: for a wrapper whose kernels take microseconds, a
    CUDA-event time around one call measures the host (cuda_ms).  The
    torch.profiler sums of kernel intervals are not used for this: on
    the card's machine they disagreed with these times for such short
    kernels."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    g.replay()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        g.replay()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / (reps * calls)


def timed_once(torch, fn):
    """(fn(), its ms on the card by CUDA events, one run, no warm-up)."""
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    out = fn()
    e.record()
    torch.cuda.synchronize()
    return out, s.elapsed_time(e)


def count_dispatch(torch, fn) -> int:
    """Tensor ops dispatched while fn runs (the eager path's launch count,
    roughly one device kernel each), plus the port's own launches."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from tpukzg_torch.kernels import _build

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    before = sum(_build.launches.values())
    with Count():
        fn()
    return Count.n + sum(_build.launches.values()) - before


def device_busy(torch, fn):
    """One run of fn under torch.profiler, device activity only ->
    (wall s, device-busy s, device kernels, top five by device time, the
    trace's garbage as (objects, s to collect)).  Busy is the union of
    the traced device intervals."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], collections.Counter()
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        s, t = e.time_range.start, e.time_range.end
        spans.append((s, t))
        by_name[e.name] += t - s
    busy, reach = 0.0, float("-inf")
    for s, t in sorted(spans):
        if t > reach:
            busy += t - max(s, reach)
            reach = t
    top = [(name[:60], round(us * 1e-3, 3))
           for name, us in by_name.most_common(5)]
    # the trace's event tree is cyclic garbage (about eleven objects an
    # event) that only a full collection frees: free it here, untimed,
    # or the next full pass lands in whatever path runs then
    del prof
    t0 = time.perf_counter()
    freed = gc.collect()
    return (wall, busy * 1e-6, len(spans), top,
            (freed, time.perf_counter() - t0))


@contextlib.contextmanager
def gc_clock():
    """Python's cyclic-GC passes while the block runs -> a dict filled on
    leaving: passes, seconds, objects collected."""
    out, t0 = dict(passes=0, seconds=0.0, collected=0), [0.0]

    def cb(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            out["passes"] += 1
            out["seconds"] += time.perf_counter() - t0[0]
            out["collected"] += info["collected"]

    gc.callbacks.append(cb)
    try:
        yield out
    finally:
        gc.callbacks.remove(cb)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise Fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def kernel_names():
    """Names of the __global__ functions in csrc/*.cu."""
    names = set()
    for path in glob.glob(os.path.join(REPO, "src", "tpukzg_torch", "csrc",
                                       "*.cu")):
        with open(path) as fh:
            names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__"
                                    r"\([^)]*\)\s*)?(\w+)\s*\(", fh.read()))
    return names


def short_name(name: str, known) -> str:
    """The longest kernel name of `known` inside a mangled or demangled
    name, else the name itself."""
    return max((k for k in known if k in name), key=len, default=name)


def ptxas_summary(log: str):
    """{source: {kernel: {"registers": r, "spill_bytes": s}}} from the
    `nvcc -Xptxas -v` build log (spill = stores + loads); a kernel
    template's instances as kernel<0>, kernel<FpT>, ..."""
    out, src, fn, known = {}, None, None, kernel_names()
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
            out[src] = {}
            continue
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = short_name(m.group(1), known)
            arg = re.search(r"I(?:Li(\d+)|N2tk\d(\w+?))E", m.group(1))
            if arg:                             # kernel<0>, kernel<FpT>
                fn += f"<{arg[1] or arg[2]}>"
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and src and fn:
            out[src].setdefault(fn, {})["spill_bytes"] = int(m[1]) + int(m[2])
        m = re.search(r"Used (\d+) registers", line)
        if m and src and fn:
            out[src].setdefault(fn, {})["registers"] = int(m[1])
    return out


def point_pool(torch, setup):
    """All SRS points (Lagrange and monomial), limb-major (24, 2n)."""
    return tuple(torch.cat([a, b], 0).movedim(-1, 0).contiguous()
                 for a, b in zip(setup.lagrange_g1, setup.monomial_g1))


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------


def check_montmul(torch, field, lanes: int, gen, reps: int):
    from tpukzg_torch.kernels import montmul as mm
    L = field.L
    dev = torch.device("cuda")

    def rand_elems():
        x = torch.randint(0, 1 << 16, (L, lanes), generator=gen, device=dev,
                          dtype=torch.int32)
        x[L - 1] = torch.randint(0, int(field.mod_limbs[-1]), (lanes,),
                                 generator=gen, device=dev, dtype=torch.int32)
        return x

    a, b = rand_elems(), rand_elems()
    special = [torch.full((L,), 0xFFFF, dtype=torch.int32, device=dev),
               torch.as_tensor(field.from_int(field.modulus - 1), device=dev),
               torch.zeros(L, dtype=torch.int32, device=dev),
               torch.as_tensor(field.from_int(1), device=dev)]
    for i, s in enumerate(special):
        a[:, i] = s
        b[:, len(special) + i] = s
        a[:, 2 * len(special) + i] = s
        b[:, 2 * len(special) + i] = special[-1 - i]
    got = mm.montmul(a, b, field, limb_dim=0)
    from tpukzg_torch.field.mont import FP_PLAIN, FR_PLAIN
    plain_field = FP_PLAIN if field.name == "Fp" else FR_PLAIN
    want = mm.montmul_plain(a, b, plain_field, limb_dim=0)
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item())
    check(err == 0, f"montmul {field.name}: kernel != plain (max err {err})")
    ms = graph_ms(torch, lambda: mm.montmul(a, b, field, limb_dim=0), reps)
    call_ms = cuda_ms(torch, lambda: mm.montmul(a, b, field, limb_dim=0),
                      reps)
    pms = cuda_ms(torch, lambda: mm.montmul_plain(a, b, plain_field,
                                                 limb_dim=0), 1)
    # the floor of B1's access pattern: a PyTorch elementwise op with the
    # same loads and stores (a and b read, an (L, lanes) int32 written)
    c = torch.empty_like(a)
    floor_ms = graph_ms(torch, lambda: torch.bitwise_xor(a, b, out=c), reps)
    words = L // 2
    bms, by = bound_ms(3 * lanes * L * 4, lanes * montmul_ops(words))
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=pms,
                floor_ms=floor_ms, bound_ms=bms, bound_by=by,
                shape=[L, lanes],
                check=f"bit-exact on {lanes} lanes incl. all-0xFFFF, p-1, 0")


def check_montmul_shadow(torch, field, gen, lanes: int = 256):
    """B1 against the CIOS shadow (utils/checked.py: mont_mul<F> of
    csrc/field.cuh replayed word by word, every site asserted within its
    width) on `lanes` lanes: canonical random ones, and R - 1 (every limb
    0xFFFF), p - 1, 0, 1 and R mod p against each other and against
    random ones.  -> (max abs err, the shadow's bounds)."""
    from tpukzg_torch.kernels import montmul as mm
    from tpukzg_torch.utils import checked
    L = field.L
    dev = torch.device("cuda")
    a, b = (torch.randint(0, 1 << 16, (L, lanes), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(2))
    for x in (a, b):
        x[L - 1] %= int(field.mod_limbs[-1])             # below p
    stress = [torch.full((L,), 0xFFFF, dtype=torch.int32, device=dev)] + [
        torch.as_tensor(field.from_int(v), device=dev)
        for v in (field.modulus - 1, 0, 1, field.R)]
    n = len(stress)
    for i, s in enumerate(stress):
        for j, t in enumerate(stress):
            a[:, n * i + j], b[:, n * i + j] = s, t
        a[:, n * n + i] = s
        b[:, n * n + n + i] = s
    got = mm.montmul(a, b, field, limb_dim=0).cpu()
    want, bounds = checked.shadow_montmul_lm(a.cpu(), b.cpu(), field)
    err = int((got.long() - torch.from_numpy(want.astype("int64"))).abs()
              .max().item())
    check(err == 0, f"montmul {field.name}: kernel != CIOS shadow (max err "
          f"{err})")
    return err, bounds


def bench_phase(torch, k: int, reps: int, verify_launches: dict):
    """`python -m tpukzg_torch.cli bench --k K --reps R` in a child process
    on the card -> (its result line, its wall s, the launches of its
    timed reps, its stderr).  Fails unless it exits 0 with the metric, a
    value > 0 and the card's name in the unit, no vs_baseline, and every
    kernel of the k = 256 verify (`verify_launches`) launched in its
    timed reps."""
    from tpukzg_torch.bench import METRIC
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src")] + [p for p in env.get(
            "PYTHONPATH", "").split(os.pathsep) if p])
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "tpukzg_torch.cli", "bench", "--k", str(k),
         "--reps", str(reps)], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=900)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"bench exited {out.returncode}: "
          f"{out.stderr[-3000:]}")
    lines = out.stdout.strip().splitlines()
    check(lines, f"bench printed nothing: {out.stderr[-3000:]}")
    line = json.loads(lines[-1])
    name = torch.cuda.get_device_name(0)
    check(line.get("metric") == METRIC and line.get("value", 0) > 0
          and name in line.get("unit", "") and "vs_baseline" not in line,
          f"bench line {line}")
    m = re.search(r"kernel launches in the timed reps (\{.*\})", out.stderr)
    check(m, "bench logged no kernel launches")
    launches = json.loads(m.group(1))
    missing = [kern for kern, c in verify_launches.items()
               if c and not launches.get(kern)]
    check(not missing, f"bench's timed reps launched no {missing}")
    return line, wall, launches, out.stderr


def check_ec_add(torch, pool, lanes: int, gen, reps: int):
    from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
    from tpukzg_torch.field.limb_major import FP_LM_PLAIN
    dev = torch.device("cuda")
    npool = pool[0].shape[1]
    i1 = torch.randint(0, npool, (lanes,), generator=gen, device=dev)
    i2 = torch.randint(0, npool, (lanes,), generator=gen, device=dev)
    p = [c[:, i1].clone() for c in pool]
    q = [c[:, i2].clone() for c in pool]
    inf = G1_LM_PLAIN.inf((1,), dev)
    for c in range(3):
        q[c][:, 0] = p[c][:, 0]                        # P + P
        q[c][:, 1] = p[c][:, 1]                        # P + (-P)
        p[c][:, 2] = inf[c][:, 0]                      # inf + Q
        q[c][:, 3] = inf[c][:, 0]                      # P + inf
        p[c][:, 4] = inf[c][:, 0]                      # inf + inf
        q[c][:, 4] = inf[c][:, 0]
    q[1][:, 1] = FP_LM_PLAIN.neg(p[1][:, 1:2])[:, 0]
    r = hold_ec_add(torch, tuple(p), tuple(q), reps)
    check(bool(G1_LM_PLAIN.is_inf(tuple(c[:, 1:2] for c in r.pop("out"))
                                  ).all()),
          "ec_add: P + (-P) is not infinity")
    r["check"] = (f"bit-exact in all {lanes} lanes incl. inf, P+P, "
                  "P+(-P)")
    return r


def hold_ec_add(torch, p, q, reps: int):
    """B2 against its plain version on (p, q) (batch axes broadcast), and
    both timed -> the kernel entry's numbers and the kernel's output."""
    from tpukzg_torch.field.limb_major import FP_LM_PLAIN
    from tpukzg_torch.kernels import ec
    coords = torch.broadcast_tensors(*p, *q)
    p, q = tuple(c.contiguous() for c in coords[:3]), \
        tuple(c.contiguous() for c in coords[3:])
    got = ec.ec_add(p, q)
    want = ec.ec_add_plain(p, q, FP_LM_PLAIN)
    torch.cuda.synchronize()
    err = max(int((g.long() - w.long()).abs().max().item())
              for g, w in zip(got, want))
    lanes = p[0].numel() // 24
    check(err == 0, f"ec_add on {lanes} lanes: kernel != plain (max limb "
          f"err {err})")
    ms = graph_ms(torch, lambda: ec.ec_add(p, q), reps)
    call_ms = cuda_ms(torch, lambda: ec.ec_add(p, q), reps)
    pms = cuda_ms(torch, lambda: ec.ec_add_plain(p, q, FP_LM_PLAIN), 1)
    bms, by = bound_ms(9 * lanes * 24 * 4, lanes * EC_ADD_OPS)
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, shape=list(p[0].shape), out=got)


def capture_ec_add(torch, fn, lanes: int, nth: int):
    """fn() with the inputs of B2's nth call on `lanes` lanes kept
    -> (fn's result, (p, q))."""
    from tpukzg_torch.kernels import ec
    orig, seen, cap = ec.ec_add, [0], {}

    def rec(p, q):
        if torch.broadcast_shapes(*(c.shape for c in p + q))[1:].numel() \
                == lanes:
            seen[0] += 1
            if seen[0] == nth:
                cap["pq"] = (tuple(c.clone() for c in p),
                             tuple(c.clone() for c in q))
        return orig(p, q)

    ec.ec_add = rec
    try:
        out = fn()
    finally:
        ec.ec_add = orig
    check("pq" in cap, f"B2 made fewer than {nth} calls on {lanes} lanes")
    return out, cap["pq"]


def hold_ec_double(torch, p, times: int, reps: int):
    """B6 (a run of `times` doublings, one launch) against its plain
    version on p, both kernels (one thread a point, and four) and the
    launcher's choice between them, each timed -> the launcher's numbers,
    with each kernel's ms and the group the launcher took."""
    from tpukzg_torch.field.limb_major import FP_LM_PLAIN
    from tpukzg_torch.kernels import ec
    p = tuple(c.contiguous() for c in torch.broadcast_tensors(*p))
    lanes = p[0].numel() // 24
    # Z = 0 is infinity, which doubling maps to itself limb for limb
    finite = int((p[2] != 0).any(0).sum().item())
    check(finite > 0, f"ec_double x{times} on {lanes} lanes: every input "
          "point is at infinity, which holds no kernel")
    want = ec.ec_double_plain(p, FP_LM_PLAIN, times)
    err, ms_by, call_by = 0, {}, {}
    for group in (1, 4):
        got = ec.ec_double(p, times, group)
        torch.cuda.synchronize()
        e = max(int((g.long() - w.long()).abs().max().item())
                for g, w in zip(got, want))
        check(e == 0, f"ec_double x{times} on {lanes} lanes, {group} "
              f"threads a point: kernel != plain (max limb err {e})")
        err = max(err, e)
        ms_by[group] = graph_ms(torch, lambda: ec.ec_double(p, times, group),
                                reps)
        call_by[group] = cuda_ms(torch, lambda: ec.ec_double(p, times, group),
                                 reps)
    group = ec.double_group(lanes)
    pms = cuda_ms(torch, lambda: ec.ec_double_plain(p, FP_LM_PLAIN, times),
                  1)
    # each point read once and written once; t doublings of 8 products
    bms, by = bound_ms(6 * lanes * 24 * 4, lanes * times * EC_DOUBLE_OPS)
    return dict(max_abs_err=err, ms=ms_by[group], call_ms=call_by[group],
                plain_ms=pms, bound_ms=bms, bound_by=by,
                shape=list(p[0].shape), times=times, group=group,
                finite_lanes=finite,
                ms_one_thread=ms_by[1], call_ms_one_thread=call_by[1],
                ms_quad=ms_by[4], call_ms_quad=call_by[4], chain=8 * times,
                chain_quad=2 * times)


def say_double(r, name, card):
    say(f"[B6 ec_double {r['shape']} x{r['times']}, {name}] ok, both kernels "
        f"bit-exact vs plain ({r['finite_lanes']} lanes not at infinity): "
        f"{r['ms']:.4f} ms on the card, "
        f"{r['call_ms']:.4f} ms a call, by the launcher's choice ("
        f"{r['group']} threads a point); one thread a point "
        f"{r['ms_one_thread']:.4f} / {r['call_ms_one_thread']:.4f} ms, a "
        f"chain of {r['chain']} products; four {r['ms_quad']:.4f} / "
        f"{r['call_ms_quad']:.4f} ms, a chain of {r['chain_quad']} (plain "
        f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.6f} ms by "
        f"{r['bound_by']}) [{card}]")


def double_crossover(torch, pool, gen, reps: int):
    """Both B6 kernels timed on the card (graph_ms) at lane counts around
    the launcher's switch (t = 1 and t = 11), on random SRS points ->
    {"lanes x t": {"1": ms, "4": ms}} (the evidence for QUAD_MAX_LANES)."""
    from tpukzg_torch.kernels import ec
    out = {}
    for lanes in (4096, 8192, 16384, 32768, 65536, 131072):
        idx = torch.randint(0, pool[0].shape[1], (lanes,), generator=gen,
                            device="cuda")
        p = tuple(c[:, idx].contiguous() for c in pool)
        for times in (1, 11):
            out[f"{lanes}x{times}"] = {str(g): round(graph_ms(
                torch, lambda: ec.ec_double(p, times, g), reps), 5)
                for g in (1, 4)}
    return out


def check_ec_double(torch, pool, lanes: int, gen, reps: int):
    """B6 at t = 1 on random SRS points and infinity against one plain
    double."""
    from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
    dev = torch.device("cuda")
    idx = torch.randint(0, pool[0].shape[1], (lanes,), generator=gen,
                        device=dev)
    p = [c[:, idx].clone() for c in pool]
    inf = G1_LM_PLAIN.inf((1,), dev)
    for c in range(3):
        p[c][:, 0] = inf[c][:, 0]
    r = hold_ec_double(torch, tuple(p), 1, reps)
    r["check"] = f"bit-exact in all {lanes} lanes incl. infinity, t = 1"
    return r


class DoubleRuns:
    """Keeps the inputs of B6's first call at each wanted (lanes, times)
    whose points are not all at infinity, while active: `with
    DoubleRuns(torch, [(2, 8)]) as cap: ...`, then cap.got[(2, 8)] = (p,
    times).  A ladder's first run doubles infinity in every lane, which
    would hold an identity kernel too; so the first `keep` calls at each
    key are cloned (no host sync inside the run) and the pick is made on
    leaving."""

    def __init__(self, torch, wanted, keep: int = 8):
        self.torch, self.wanted, self.keep = torch, set(wanted), keep
        self.seen = {key: [] for key in self.wanted}
        self.got = {}

    def __enter__(self):
        from tpukzg_torch.kernels import ec
        self.orig = orig = ec.ec_double

        def rec(p, times=1, group=None):
            lanes = self.torch.broadcast_shapes(
                *(c.shape for c in p))[1:].numel()
            runs = self.seen.get((lanes, times))
            if runs is not None and len(runs) < self.keep:
                runs.append((tuple(c.clone() for c in p), times))
            return orig(p, times, group)

        ec.ec_double = rec
        return self

    def __exit__(self, *exc):
        from tpukzg_torch.kernels import ec
        ec.ec_double = self.orig
        for key, runs in self.seen.items():
            finite = [r for r in runs if bool(r[0][2].any().item())]
            if finite:
                self.got[key] = finite[0]
        return False


class PowRuns:
    """Keeps the input of each call of B1's chain launch while active:
    `with PowRuns(torch) as cap: ...`, then cap.got = [(x, e, field),
    ...] in call order."""

    def __init__(self, torch):
        self.torch, self.got = torch, []

    def __enter__(self):
        from tpukzg_torch.kernels import montmul
        self.orig = orig = montmul.montmul_pow

        def rec(a, e, field):
            self.got.append((a.clone(), e, field))
            return orig(a, e, field)

        montmul.montmul_pow = rec
        return self

    def __exit__(self, *exc):
        from tpukzg_torch.kernels import montmul
        montmul.montmul_pow = self.orig
        return False


def hold_pow(torch, x, e: int, field, reps: int):
    """B1's chain launch (a^e, one launch) against the plain chain (the
    same products one by one) on x, both timed.  Bound: the elements
    read and written once, and every product of the chain; the chain of
    dependent products (its length) is what sets the time."""
    from tpukzg_torch.field.mont import FP_PLAIN, FR_PLAIN
    from tpukzg_torch.kernels import montmul as mm
    plain_field = FP_PLAIN if field.name == "Fp" else FR_PLAIN
    got = mm.montmul_pow(x, e, field)
    want, pms = timed_once(torch, lambda: mm.montmul_pow_plain(
        x, e, plain_field))
    err = int((got.long() - want.long()).abs().max().item())
    lanes = x.numel() // field.L
    check(err == 0, f"montmul_pow {field.name} e of {e.bit_length()} bits on "
          f"{lanes} lanes: kernel != plain (max err {err})")
    chain = len(mm.exp_bits(e)) + sum(mm.exp_bits(e))
    ms = graph_ms(torch, lambda: mm.montmul_pow(x, e, field), reps)
    call_ms = cuda_ms(torch, lambda: mm.montmul_pow(x, e, field), reps)
    bms, by = bound_ms(2 * lanes * field.L * 4,
                       lanes * chain * montmul_ops(field.L // 2))
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, shape=[lanes, field.L],
                chain=chain, exponent_bits=e.bit_length())


def say_pow(r, name, card):
    say(f"[B1 chain launch {r['shape']}, {name}] ok, bit-exact vs the plain "
        f"chain: {r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a call, "
        f"one launch for a chain of {r['chain']} "
        f"dependent products ({r['exponent_bits']}-bit exponent; plain "
        f"{r['plain_ms']:.1f} ms, {r['chain']} launches of the plain product; "
        f"bound {r['bound_ms']:.6f} ms by {r['bound_by']}) [{card}]")


# Launches of B1 a path, the elementwise product's and the chain
# launch's together: each Fermat inversion and square root is one launch.
# The verify runs three chains: the decompress square root (606
# products), the pairing's Fp inversion of the two G1 points' Z to
# affine form (608) and the final exponentiation's Fp inversion (608), so
# its 2462 launches of one product each became 2462 - 1822 + 3; the proof
# batch two Fr inversions of 417 (854 -> 22); a commit batch one Fp
# inversion to affine form (611 -> 4); verify_kzg_proof the verify's
# three chains on 2 and 1 lanes.
B1_LAUNCHES = {"verify": {"Fp": 643, "Fr": 10},
               "verify_kzg_proof": {"Fp": 643},
               "commit_batch": {"Fp": 4},
               "proof_batch": {"Fp": 4, "Fr": 22},
               "coeff": {"Fr": 22},
               "open3": {"Fr": 21}}


def b1_launches(launches, field: str) -> int:
    f = field.lower()
    return launches.get("montmul_" + f, 0) + launches.get("montmul_pow_" + f,
                                                          0)


def check_b1_launches(paths):
    """B1's launches on every path of B1_LAUNCHES run so far."""
    for path, want in B1_LAUNCHES.items():
        for fld, n in want.items() if path in paths else ():
            got = b1_launches(paths[path], fld)
            check(got == n, f"B1 {fld} launched {got} times on the {path} "
                  f"path, not {n}")


def scan_adds(torch, seg) -> int:
    """EC adds an inclusive segmented scan needs on these keys: one for
    each lane whose key equals its left neighbour's."""
    return int((seg[:, 1:] == seg[:, :-1]).sum().item())


def check_bucket(torch, pts, seg, reps: int):
    """Kernel against the plain scan, in groups of rows of at most 2^16
    lanes (a plain scan of one 98,304-lane row holds ~3 GB of int64
    products at a time)."""
    from tpukzg_torch.curve.weierstrass_lm import G1_LM_PLAIN
    from tpukzg_torch.kernels import bucket
    got = bucket._launch(pts, seg)
    grid = dict(bucket.last_grid)
    again = bucket._launch(pts, seg)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"bucket scan: two launches on {tuple(seg.shape)} differ")
    step = max(1, (1 << 16) // seg.shape[1])

    def plain():
        rows = [bucket.seg_scan_plain(tuple(c[:, r:r + step] for c in pts),
                                      seg[r:r + step])
                for r in range(0, seg.shape[0], step)]
        return tuple(torch.cat([r[i] for r in rows], 1) for i in range(3))

    want, pms = timed_once(torch, plain)
    err = max(int((g.long() - w.long()).abs().max().item())
              for g, w in zip(got, want))
    same = G1_LM_PLAIN.eq(got, want)
    check(bool(same.all().item()), "bucket scan: kernel != plain after "
          f"normalisation in {int((~same).sum().item())} lanes of "
          f"{tuple(seg.shape)}")
    ms = graph_ms(torch, lambda: bucket._launch(pts, seg), reps)
    call_ms = cuda_ms(torch, lambda: bucket._launch(pts, seg), reps)
    g, n = seg.shape
    adds = scan_adds(torch, seg)
    bms, by = bound_ms(6 * 24 * 4 * g * n + 4 * g * n, adds * EC_ADD_OPS)
    check(grid.get("scan_local", 0) > 0,
          f"bucket scan on {tuple(seg.shape)} reported the grid {grid}")
    return dict(max_abs_err=err, ms=ms, call_ms=call_ms, plain_ms=pms,
                bound_ms=bms, bound_by=by, adds=adds, shape=[24, g, n],
                device_kernels=len(grid), grid=grid)


def check_fractree(torch, evals, z, roots, plan, reps: int):
    from tpukzg_torch.field.mont import FR_PLAIN
    from tpukzg_torch.kernels import fractree
    from tpukzg_torch.poly.poly import _fraction_merge
    n_inv = torch.as_tensor(plan.n_inv, device=evals.device)
    z = z.clone()
    z[0] = roots[5]                                   # in-domain z = w^5

    def plain():
        a, b = fractree.fractree_partials_plain(evals, z, roots)
        return FR_PLAIN.mul(_fraction_merge(a, b, FR_PLAIN), n_inv)

    a, b = fractree.fractree_partials(evals, z, roots)
    grid = dict(fractree.last_grid)
    got = FR_PLAIN.mul(_fraction_merge(a, b, FR_PLAIN), n_inv)
    want = plain()
    torch.cuda.synchronize()
    err = int((got.long() - want.long()).abs().max().item())
    check(err == 0, f"fractree: y differs from plain (max err {err})")
    check(bool((got[0] == evals[0, 5]).all().item()),
          "fractree: in-domain y != e_m")
    ms = graph_ms(torch, lambda: fractree.fractree_partials(evals, z, roots),
                  reps)
    call_ms = cuda_ms(torch, lambda: fractree.fractree_partials(evals, z,
                                                                roots), reps)
    pms = cuda_ms(torch, plain, 1)
    k, n, _ = evals.shape
    # the whole reduction, whatever the design: the fewest Fr products
    # known, 3 (n - 1) merges of (A', B, S) and 2 for A = z A' - S B, a
    # blob; e, the roots and z read once, one (A, B) pair a blob written
    muls = k * (3 * n - 1)
    bms, by = bound_ms(k * n * 64 + n * 64 + k * 64 + 2 * k * 64,
                       muls * montmul_ops(8))
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, shape=[k, n, 16], grid=grid, call_ms=call_ms,
                check="y bit-exact, one in-domain z")


def check_ntt(torch, x, plan, inverse: bool, reps: int):
    from tpukzg_torch.kernels import ntt as kntt
    got = kntt.ntt(x, plan, inverse)
    grid = [dict(p) for p in kntt.last_grid]
    want, pms = timed_once(torch, lambda: kntt.ntt_plain(x, plan, inverse))
    err = int((got.long() - want.long()).abs().max().item())
    check(err == 0, f"ntt {tuple(x.shape)} inverse={inverse}: kernel != "
          f"plain (max err {err})")
    ms = graph_ms(torch, lambda: kntt.ntt(x, plan, inverse), reps)
    call_ms = cuda_ms(torch, lambda: kntt.ntt(x, plan, inverse), reps)
    k, n = x.numel() // (16 * plan.n), plan.n
    muls = k * (n // 2) * plan.log_n + (k * n if inverse else 0)
    bms, by = bound_ms(2 * k * n * 64 + (n // 2) * 64 + 64,
                       muls * montmul_ops(8))
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, shape=[k, n, 16], inverse=inverse, grid=grid,
                call_ms=call_ms)


def alternatives(torch, ntt_x, big_x, plan, big, ft_in, reps: int):
    """B5 and B4 at other splits and grids than their launchers choose,
    each bit-exact against the launcher's choice -> {kernel: {config: ms
    on the card (graph_ms)}}.  B5 configs: the stages of each pass / the
    groups a block; B4: parts a blob x threads a block."""
    from tpukzg_torch.kernels import fractree, ntt as kntt
    out = {}
    for key, x, pl, cfgs in (
            ("ntt_16x4096", ntt_x, plan, [(12,), (6, 6), (4, 4, 4)]),
            ("ntt_1x2^18", big_x, big, [(9, 9), (6, 6, 6)])):
        want = kntt.ntt(x, pl)
        times = {}
        for split in cfgs:
            for lg in range(4):
                s0, passes = 0, []
                for st in split:
                    room = pl.log_n - st if s0 == 0 else s0
                    if lg > room or st + lg > 12:
                        break
                    passes.append((s0, s0 + st, lg))
                    s0 += st
                if len(passes) < len(split):
                    continue
                got = kntt._launch(x, pl, False, passes)
                check(torch.equal(got, want), f"B5 {key} {passes} differs")
                name = "+".join(map(str, split)) + f"/G{1 << lg}"
                times[name] = graph_ms(
                    torch, lambda: kntt._launch(x, pl, False, passes), reps)
        times["launcher"] = graph_ms(torch, lambda: kntt._launch(x, pl),
                                      reps)
        out[key] = times
    for key, (evals, z, roots), cfgs in (
            ("fractree_k16", ft_in[16], [(16, 32), (16, 64), (16, 256),
                                         (32, 64), (64, 32)]),
            ("fractree_k256", ft_in[256], [(1, 128), (1, 256), (2, 128),
                                           (4, 64)])):
        want = fractree._launch(evals, z, roots)
        times = {}
        for parts, threads in cfgs + [(None, None)]:
            got = fractree._launch(evals, z, roots, parts, threads)
            check(all(torch.equal(g, w) for g, w in zip(got, want)),
                  f"B4 {key} parts={parts} threads={threads} differs")
            name = f"{parts}x{threads}" if parts else "launcher"
            times[name] = graph_ms(
                torch, lambda: fractree._launch(evals, z, roots, parts,
                                                threads), reps)
        out[key] = times
    return out


def pipeline_path(torch, ts, batches, strict_mode: bool):
    """bench.py's 3-stage schedule (bench.py:220-251) over `batches`:
    batch i+1's stage 1, batch i's stage 2, batch i-1's verdict; the last
    drained.  With `strict_mode`, stage 1 (the constructor) and stage2()
    run under sync debug mode "error", all but the y readback (the one
    sync of a batch before its verdict); result() outside it.  ->
    (verdicts, wall s, fill and drain included)."""
    import tpukzg_torch
    from tpukzg_torch.kzg import blob
    real = blob._y_to_host

    def exempt(y):
        prev = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode(0)
        try:
            return real(y)
        finally:
            torch.cuda.set_sync_debug_mode(prev)

    def strict(fn, *args):
        if not strict_mode:
            return fn(*args)
        torch.cuda.set_sync_debug_mode("error")
        try:
            return fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    start = tpukzg_torch.verify_blob_kzg_proof_batch_pipeline
    blob._y_to_host = exempt
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pend = [strict(start, *batches[0], ts)]
        out = []
        for i in range(len(batches)):
            if i + 1 < len(batches):
                pend.append(strict(start, *batches[i + 1], ts))
            strict(pend[i].stage2)
            if i > 0:
                out.append(pend[i - 1].result())
        out.append(pend[-1].result())
        wall = time.perf_counter() - t0
    finally:
        blob._y_to_host = real
    return out, wall


def run_path(torch, fn):
    """fn() with the kernel counts set to 0 just before and read just
    after -> (result, wall s, launches by kernel)."""
    from tpukzg_torch.kernels import _build
    torch.cuda.synchronize()
    _build.launches.clear()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, dict(_build.launches)


def prover_path(torch, ts, say_path):
    """Steps 1-3 of the prover slice on the 16 fixture blobs.  Returns
    (launches by path, captured fixed-base B3 chunk and suffix scan and
    the proof batch's B4 input, NTT inputs)."""
    import tpukzg_torch
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.field.mont import FR, R_MOD
    from tpukzg_torch.kernels import bucket, fractree
    from tpukzg_torch.kzg import transcript
    from tpukzg_torch.kzg.fixtures import load_triples

    blobs, cs, pfs = load_triples(ts.n, 16)
    k, kzg, paths = len(blobs), ts.kzg, {}
    run = (ts.n, kzg.c_commit)                 # a table window's run
    with DoubleRuns(torch, [run]) as dbl:
        _, wall, paths["tables"] = run_path(
            torch, lambda: (kzg.table("lag"), kzg.table("mono")))
    say(f"[prover tables] lag + mono fixed-base tables (c = "
        f"{kzg.c_commit}, {kzg.table('lag')[0].shape[1]} windows) in "
        f"{wall:.3f} s; kernel launches {json.dumps(paths['tables'])}")

    captured = {}
    check(run in dbl.got, f"no B6 run of {run[1]} on {run[0]} lanes in the "
          "table build")
    captured["table_run"] = dbl.got[run]
    orig = bucket._launch

    def rec(pts, seg):
        if seg.shape[1] > ts.n:            # W n lanes, not 2^c - 1
            captured.setdefault("fixed", (pts, seg))
        else:                              # the suffix scan of the buckets
            captured.setdefault("suffix", (pts, seg))
        return orig(pts, seg)

    bucket._launch = rec
    try:
        got_cs, wall, paths["commit_batch"] = run_path(
            torch, lambda: tpukzg_torch.blob_to_kzg_commitment_batch(blobs,
                                                                     ts))
    finally:
        bucket._launch = orig
    say_path(f"commit_batch k={k}", wall, paths["commit_batch"])
    check(got_cs == cs, "commitments differ from the fixture's: "
          f"{[i for i in range(k) if got_cs[i] != cs[i]]}")
    orig_ft = fractree.fractree_partials

    def rec_ft(evals, z, roots):
        captured.setdefault("fractree", (evals, z, roots))
        return orig_ft(evals, z, roots)

    fractree.fractree_partials = rec_ft
    try:
        with PowRuns(torch) as pw:
            got_pfs, wall, paths["proof_batch"] = run_path(
                torch, lambda: tpukzg_torch.compute_blob_kzg_proof_batch(
                    blobs, cs, ts))
    finally:
        fractree.fractree_partials = orig_ft
    captured["pow_fr"] = [(x, e, f) for x, e, f in pw.got if f.name == "Fr"]
    say_path(f"proof_batch k={k}", wall, paths["proof_batch"])
    check(got_pfs == pfs, "proofs differ from the fixture's: "
          f"{[i for i in range(k) if got_pfs[i] != pfs[i]]}")
    wall_p, busy, n_dev, top, (freed, gc_s) = device_busy(
        torch, lambda: tpukzg_torch.blob_to_kzg_commitment_batch(blobs, ts))
    if n_dev:
        say(f"[prover commit_batch k={k}] one more, profiled: {n_dev} "
            f"device kernels busy {busy:.4f} s of {wall_p:.3f} s wall "
            f"({100 * busy / wall_p:.1f} %); top device ms "
            f"{json.dumps(top)}; the trace's cyclic garbage, {freed} "
            f"objects, collected after it in {gc_s:.3f} s")
    else:
        say(f"[prover commit_batch k={k}] device busy share not measured: "
            "the profiler trace holds no device events")
    ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, got_cs, got_pfs, ts)
    say(f"[prover] the {k} fixture commitments and proofs reproduced byte "
        f"for byte; verify_blob_kzg_proof_batch of them: {ok}")
    check(ok is True, "the port's verify refused its own proofs")

    # step 2: coefficient form through the NTT
    evals = ts.blob._blob_natural_mont(blobs)
    zs = [transcript.compute_challenge(blobs[i], cs[i], ts.n)
          for i in range(k)]
    z_mont = ts.blob._z_mont(zs)
    coeff_phases = {}

    def coeff_path():
        t = time.perf_counter()
        out = {}
        for name, fn in (
                ("interpolate", lambda: kzg.interpolate(evals)),
                ("to_evals", lambda: kzg.to_evals(out["interpolate"])),
                ("commit_coeff", lambda: kzg.commit_coeff(out["interpolate"])),
                ("open_coeff", lambda: kzg.open_coeff(out["interpolate"],
                                                      z_mont))):
            out[name] = fn()
            torch.cuda.synchronize()
            coeff_phases[name] = round(time.perf_counter() - t, 4)
            t = time.perf_counter()
        return out

    out, wall, paths["coeff"] = run_path(torch, coeff_path)
    say_path(f"coeff path k={k}", wall, paths["coeff"],
             f" phases (s) {json.dumps(coeff_phases)}")
    check(torch.equal(out["to_evals"], evals),
          "to_evals(interpolate(e)) != e")
    check(g1m.compress_points(out["commit_coeff"]) == cs,
          "commit_coeff(interpolate(e)) differs from the fixture")
    check(g1m.compress_points(out["open_coeff"][0]) == pfs,
          "open_coeff differs from the fixture's proofs")
    say("[prover] to_evals(interpolate(e)) == e bit for bit; commit_coeff "
        f"and open_coeff reproduce the {k} commitments and proofs")

    # step 3: one in-domain and two out-of-domain openings, Kzg level
    roots = ts.setup.plan.roots_int
    z3 = [roots[5], zs[1], 0x5EED]
    z3_mont = ts.blob._z_mont(z3)
    (pi, y), wall, paths["open3"] = run_path(
        torch, lambda: kzg.open(evals[:3], z3_mont))
    say_path("open k=3 (z0 = w^5)", wall, paths["open3"])
    check(torch.equal(y[0], evals[0, 5]), "in-domain y != e_5")
    c_pts, ok_sub = g1m.decompress_batch(cs[:3], ts.device)
    check(bool(ok_sub.all().item()), "fixture commitments not in G1")
    dev = ts.device
    z_can = torch.as_tensor(FR.from_int(z3), device=dev)
    y_can = FR.from_mont(y)
    rho = [pow(0xC0FFEE, i, R_MOD) for i in range(3)]
    rho_can = torch.as_tensor(FR.from_int(rho), device=dev)
    ok = bool(kzg.verify_batch(c_pts, z_can, y_can, pi, rho_can).item())
    y_bad = y_can.clone()
    y_bad[2, 0] ^= 1
    bad = bool(kzg.verify_batch(c_pts, z_can, y_bad, pi, rho_can).item())
    say(f"[prover] Kzg.verify_batch of the three openings: {ok}; with one "
        f"y changed: {bad}")
    check(ok and not bad, "Kzg.verify_batch verdicts wrong")
    ntt_inputs = dict(fwd=out["interpolate"], inv=evals)
    return paths, captured, ntt_inputs


def expect_value_error(fn, what: str) -> str:
    """fn() must raise ValueError (a refused input) -> its message."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise Fail(f"{what} was accepted")


def same_affine(torch, normalize, a, b) -> bool:
    """Two point tuples equal after normalising to affine form."""
    return all(torch.equal(x, y) for x, y in zip(normalize(a), normalize(b)))


def setup_path(torch, ts, triples, paths, say_card):
    """Setup generation from scratch into a temporary directory (tau =
    0xDEADBEEF, the committed SRS's n), held against the committed SRS:
    the points in affine form, [tau]_2 in affine form, the lines of the
    committed G2 points bit for bit; then the commit and proof batches of
    the fixture blobs on it, byte for byte, and its batch verify.  The
    next `generate_insecure` finds the file.  Returns B2 held against its
    plain version on one step of the G1 ladder."""
    import shutil
    import tempfile
    import tpukzg_torch
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.kzg.setup import Setup
    from tpukzg_torch.pairing.lines import precompute_lines
    ref = ts.setup
    tmp = tempfile.mkdtemp(prefix="tpukzg_srs_")
    path = Setup._cache_path(tmp, 0xDEADBEEF, ref.n)
    try:
        # what generate_insecure runs on a miss, with the seconds of each
        # step; B2's inputs at its 50th call of the windowed G1 ladder
        # (a step's add) and B6's first run of 4 doublings on points not
        # all at infinity kept
        with DoubleRuns(torch, [(2 * ref.n, 4)]) as dbl:
            ((gen, secs), wall, paths["setup_gen"]), step = capture_ec_add(
                torch, lambda: run_path(torch, lambda: Setup._generate(
                    0xDEADBEEF, ref.n, ref.device, path)), 2 * ref.n, 50)
        files = os.listdir(tmp)
        t0 = time.perf_counter()
        again = Setup.generate_insecure(0xDEADBEEF, ref.n, cache_dir=tmp,
                                        device=ref.device)
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    check(files == [os.path.basename(path)],
          f"the generated setup wrote {files}")
    check(all(torch.equal(a, b) for a, b in zip(
        again.lagrange_g1 + again.monomial_g1 + again.g2_tau
        + again.lines_tau, gen.lagrange_g1 + gen.monomial_g1 + gen.g2_tau
        + gen.lines_tau)), "generate_insecure read back another setup")
    say_card(f"[setup_gen n={ref.n}] generated in {wall:.3f} s; steps (s) "
             f"{json.dumps({k: round(v, 4) for k, v in secs.items()})}"
             f"; kernel launches {json.dumps(paths['setup_gen'])}; "
             f"generate_insecure then read the file back in {load_s:.3f} s")
    b2 = hold_ec_add(torch, *step, REPS)
    b2.pop("out")
    say_card(f"[setup_gen n={ref.n}] B2 on its 50th call of the windowed "
             "G1 ladder "
             f"{b2['shape']}: bit-exact vs plain, {b2['ms']:.4f} ms on the "
             f"card, {b2['call_ms']:.4f} ms a call (plain "
             f"{b2['plain_ms']:.2f} ms, bound {b2['bound_ms']:.4f} ms)")
    g1 = tuple(c.movedim(-1, 0) for c in gen.lagrange_g1)
    ops_g1 = count_dispatch(torch, lambda: G1_LM.double(g1))
    ops_g2 = count_dispatch(torch, lambda: G2.add(G2.double(gen.g2_tau),
                                                  gen.g2_gen))
    say_card(f"[setup_gen n={ref.n}] tensor ops dispatched (count_dispatch,"
             f" the port's launches included): a G1 double {ops_g1}, a G2 "
             f"double + add {ops_g2}")
    for name in ("lagrange_g1", "monomial_g1"):
        check(same_affine(torch, g1m.normalize, getattr(gen, name),
                          getattr(ref, name)),
              f"generated {name} differs from the committed SRS")
    for name in ("g2_gen", "g2_tau"):
        check(same_affine(torch, G2.normalize, getattr(gen, name),
                          getattr(ref, name)),
              f"generated {name} differs from the committed SRS")
    both = tuple(torch.stack([a, b]) for a, b in zip(ref.g2_gen, ref.g2_tau))
    d, a = precompute_lines(both)
    check(all(torch.equal(x, y) for x, y in zip(
        (d[0], a[0], d[1], a[1]), ref.lines_gen + ref.lines_tau)),
          "lines of the committed G2 points differ from the file's")
    check(all(torch.equal(x, y) for x, y in zip(
        gen.lines_gen + gen.lines_tau, ref.lines_gen + ref.lines_tau)),
          "lines of the generated setup differ from the file's")
    say_card(f"[setup_gen n={ref.n}] the Lagrange and monomial points, "
             "[1]_2 and [tau]_2 equal the committed SRS in affine form; "
             "precompute_lines of the committed G2 points equals its lines "
             "bit for bit")
    tsg = tpukzg_torch.TrustedSetup(gen)
    blobs, cs, pfs = triples
    t0 = time.perf_counter()
    tsg.kzg.table("lag")
    torch.cuda.synchronize()
    table_s = time.perf_counter() - t0
    got_cs, wall_c, paths["commit_batch_gen"] = run_path(
        torch, lambda: tpukzg_torch.blob_to_kzg_commitment_batch(blobs, tsg))
    check(got_cs == cs, "commitments on the generated setup differ")
    got_pfs, wall_p, paths["proof_batch_gen"] = run_path(
        torch, lambda: tpukzg_torch.compute_blob_kzg_proof_batch(blobs, cs,
                                                                 tsg))
    check(got_pfs == pfs, "proofs on the generated setup differ")
    t0 = time.perf_counter()
    ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, pfs, tsg)
    wall_v = time.perf_counter() - t0
    check(ok is True, "the fixtures do not verify on the generated setup")
    say_card(f"[setup_gen n={ref.n}] on it: Lagrange table {table_s:.3f} s,"
             f" commit batch k={len(blobs)} {wall_c:.3f} s and proof batch "
             f"{wall_p:.3f} s byte-equal to the fixture's, "
             f"verify_blob_kzg_proof_batch {ok} in {wall_v:.3f} s")
    check((2 * ref.n, 4) in dbl.got, "no B6 run of 4 doublings on "
          f"{2 * ref.n} lanes in the windowed G1 ladder")
    return b2, dbl.got[(2 * ref.n, 4)]


def compressed_path(torch, ts, triples, paths, say_card):
    """from_compressed of the committed SRS's points, compressed by the
    port: equal to the file in affine form, the fixtures verify on it; a
    [tau]_2 outside G2's subgroup and a G1 point outside G1 or off the
    curve are refused."""
    import tpukzg_torch
    from tpukzg_torch.curve import g1 as g1m, g2 as g2m
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.field.mont import P_MOD
    ref = ts.setup
    t0 = time.perf_counter()
    mono = g1m.compress_points(ref.monomial_g1)
    lag = g1m.compress_points(ref.lagrange_g1)
    tau_b = g2m.compress_point(ref.g2_tau)
    comp_s = time.perf_counter() - t0
    loaded, wall, paths["from_compressed"] = run_path(
        torch, lambda: tpukzg_torch.load_trusted_setup(mono, lag, tau_b,
                                                       device=ref.device))
    s = loaded.setup
    for name in ("lagrange_g1", "monomial_g1"):
        check(same_affine(torch, g1m.normalize, getattr(s, name),
                          getattr(ref, name)),
              f"loaded {name} differs from the committed SRS")
    check(same_affine(torch, G2.normalize, s.g2_tau, ref.g2_tau),
          "loaded [tau]_2 differs from the committed SRS")
    check(all(torch.equal(x, y) for x, y in zip(
        s.lines_gen + s.lines_tau, ref.lines_gen + ref.lines_tau)),
          "lines of the loaded setup differ from the file's")
    blobs, cs, pfs = triples
    ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, pfs, loaded)
    check(ok is True, "the fixtures do not verify on the loaded setup")
    say_card(f"[from_compressed n={ref.n}] {2 * ref.n} G1 + [tau]_2 "
             f"compressed in {comp_s:.3f} s, loaded and validated in "
             f"{wall:.3f} s (equal to the file in affine form; the "
             f"{len(blobs)} fixtures verify {ok}); kernel launches "
             f"{json.dumps(paths['from_compressed'])}")
    v = 5                        # x = (v, 1), as the JAX package's test
    while True:
        v += 1
        y = g2m._fp2_sqrt_ints((v ** 3 - 3 * v + 4) % P_MOD,
                               (3 * v * v - 1 + 4) % P_MOD)
        if y is not None and not g2m.in_subgroup_host(v, 1, *y):
            bad_tau = g2m.compress(v, 1, y[0], y[1], False)
            break
    x = 3
    while True:                  # on the curve, outside G1
        x += 1
        rhs = (x ** 3 + 4) % P_MOD
        yy = pow(rhs, (P_MOD + 1) // 4, P_MOD)
        if yy * yy % P_MOD == rhs:
            cand = g1m.compress(x, yy, False)
            if not bool(g1m.decompress_batch([cand], ref.device)[1].item()):
                break
    x_off = x
    while pow((x_off ** 3 + 4) % P_MOD, (P_MOD - 1) // 2, P_MOD) == 1:
        x_off += 1               # off the curve: x^3 + 4 not a square
    for what, args in (
            ("[tau]_2 outside the G2 subgroup", (mono, lag, bad_tau)),
            ("a Lagrange point outside G1",
             (mono, lag[:7] + [cand] + lag[8:], tau_b)),
            ("a monomial point off the curve",
             (mono[:3] + [g1m.compress(x_off, 0, False)] + mono[4:], lag,
              tau_b))):
        t0 = time.perf_counter()
        msg = expect_value_error(
            lambda: tpukzg_torch.load_trusted_setup(*args, device=ref.device),
            what)
        say_card(f"[from_compressed] {what}: ValueError({msg!r}) in "
                 f"{time.perf_counter() - t0:.3f} s")


def single_verify_path(torch, ts, triples, paths, say_card):
    """verify_kzg_proof at n on openings from compute_kzg_proof of a
    fixture blob: an out-of-domain and an in-domain z verify True, a wrong
    y and a wrong proof False."""
    import tpukzg_torch
    from tpukzg_torch.field.mont import R_MOD
    blobs, cs, _ = triples
    roots = ts.setup.plan.roots_int
    op = {}
    for name, z in (("z outside the domain", 0x5EEDC0FFEE % R_MOD),
                    ("z = w^5 in the domain", roots[5])):
        zb = z.to_bytes(32, "big")
        pf, y = tpukzg_torch.compute_kzg_proof(blobs[0], zb, ts)
        op[name] = (zb, y, pf)
    zb, y, pf = op["z outside the domain"]
    y_bad = ((int.from_bytes(y, "big") + 1) % R_MOD).to_bytes(32, "big")
    cases = [(name, args, True) for name, args in op.items()] + [
        ("wrong y", (zb, y_bad, pf), False),
        ("wrong proof", (zb, y, op["z = w^5 in the domain"][2]), False)]
    for i, (name, (z_b, y_b, p_b), want) in enumerate(cases):
        def one():
            return tpukzg_torch.verify_kzg_proof(cs[0], z_b, y_b, p_b, ts)

        with DoubleRuns(torch, [(2, 4)]) as dbl:
            (got, wall, launches), pq = capture_ec_add(
                torch, lambda: run_path(torch, one), 2, 50)
        if i == 0:
            paths["verify_kzg_proof"] = launches
            step, run = pq, dbl.got.get((2, 4))
        say_card(f"[verify_kzg_proof n={ts.n}, {name}] {got} in {wall:.3f} s;"
                 f" kernel launches {json.dumps(launches)}")
        check(got is want, f"verify_kzg_proof ({name}) gave {got}")
    check(run is not None, "no B6 run of 4 doublings on 2 lanes in "
          "verify_kzg_proof's windowed ladder")
    b2 = hold_ec_add(torch, *step, REPS)
    b2.pop("out")
    say_card(f"[verify_kzg_proof n={ts.n}] B2 on its 50th call on 2 lanes "
             f"(the windowed ladder's) {b2['shape']}: bit-exact vs plain, "
             f"{b2['ms']:.4f} ms on the card, "
             f"{b2['call_ms']:.4f} ms a call (plain "
             f"{b2['plain_ms']:.2f} ms, bound {b2['bound_ms']:.4f} ms)")
    return b2, run


def msm_inputs(torch, setup, log_n: int):
    """The public MSM's inputs: the SRS's 2n points (monomial, then
    Lagrange) tiled to 2^log_n, and seeded scalars below 2^254."""
    N, dev = 1 << log_n, setup.device
    points = tuple(torch.cat([m, la]).repeat(N // (2 * setup.n), 1)
                   for m, la in zip(setup.monomial_g1, setup.lagrange_g1))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0x5EED20)
    k = torch.randint(0, 1 << 16, (N, 16), generator=gen, device=dev,
                      dtype=torch.int32)
    k[:, 15] &= 0x3FFF
    return points, k


def msm_path(torch, setup, paths, say_card, log_n: int = 20):
    """The public MSM over 2^log_n points: the SRS's 2n points (known
    logs tau^i and L_i(tau), tau = 0xDEADBEEF) tiled, seeded scalars below
    2^254.  Check: the result equals [sum k_i d_i mod r] G1 (one ladder).
    Returns the first B3 launch on a row of POINT_CHUNK lanes (its input,
    one row) and the launches' grids."""
    from tpukzg_torch.curve import g1 as g1m
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.field.mont import FR, R_MOD
    from tpukzg_torch.kernels import bucket
    from tpukzg_torch.kzg.setup import _lagrange_scalars
    from tpukzg_torch.msm.pippenger_lm import POINT_CHUNK, default_window, msm
    dev, n = setup.device, setup.n
    tau = 0xDEADBEEF
    logs = ([pow(tau, i, R_MOD) for i in range(n)]
            + _lagrange_scalars(tau, n, setup.plan.roots_int))
    N = 1 << log_n
    reps = N // (2 * n)
    points, k = msm_inputs(torch, setup, log_n)
    col = k.reshape(reps, 2 * n, 16).to(torch.int64).sum(0).cpu().tolist()
    s = sum(d * sum(v << (16 * j) for j, v in enumerate(row))
            for d, row in zip(logs, col)) % R_MOD
    grids, cap = [], {}
    orig = bucket._launch

    def rec(pts, seg):
        out = orig(pts, seg)
        grids.append((tuple(seg.shape), dict(bucket.last_grid)))
        if seg.shape[1] == POINT_CHUNK:
            cap.setdefault("row", (tuple(c[:, :1].contiguous() for c in pts),
                                   seg[:1].contiguous()))
        return out

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    bucket._launch = rec
    try:
        with gc_clock() as gcs:
            out, wall, paths["msm_2^20"] = run_path(torch,
                                                    lambda: msm(points, k))
    finally:
        bucket._launch = orig
    peak = torch.cuda.max_memory_allocated()
    g = tuple(torch.as_tensor(c, device=dev)[:, None] for c in g1m.GEN_NP)
    want = G1_LM.scalar_mul(g, torch.as_tensor(FR.from_int([s]), device=dev))
    ok = bool(G1_LM.eq(tuple(c[:, None] for c in out), want).all().item())
    check(ok, "the 2^20-point MSM differs from [sum k_i d_i] G1")
    shapes = collections.Counter(sh for sh, _ in grids)
    by_shape = {f"{sh[0]}x{sh[1]}": dict(launches=c, grid=next(
        gr for s_, gr in grids if s_ == sh)) for sh, c in shapes.items()}
    say_card(f"[msm 2^{log_n}] equals [sum k_i d_i] G1: {ok}; {wall:.3f} s "
             f"in {N // POINT_CHUNK} chunks of {POINT_CHUNK} points, window "
             f"c = {default_window(N)}; peak device memory "
             f"{peak / 2**30:.2f} GiB (of it {base / 2**30:.2f} GiB held "
             f"before); Python's GC in the call: {gcs['passes']} passes, "
             f"{gcs['seconds']:.3f} s, {gcs['collected']} objects freed; "
             f"kernel launches "
             f"{json.dumps(paths['msm_2^20'])}; B3 "
             f"launches by (rows, lanes) and a launch's grid "
             f"{json.dumps(by_shape)}")
    check("row" in cap, "no B3 launch on a chunk's row was captured")
    return cap["row"], by_shape


# ---------------------------------------------------------------------------
# the windowed ladder, the pairing, the generic and batch MSMs, and the
# multi-GPU paths
# ---------------------------------------------------------------------------


def windowed_path(torch, ts, say_card):
    """The windowed ladder (what scalar_mul runs on the card) against the
    256-step ladder in affine form: G1 at (24, 2) (verify_kzg_proof's
    shape: two SRS points) and (24, 8192) (the setup's: the generator
    broadcast), scalars seeded with 0, 1 and r - 1 among them; G2 on
    [1]_2 with tau, r - 1 and 0.  Returns the walls."""
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.field.mont import FR
    from tpukzg_torch.kernels import _build
    dev = ts.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0x3D)
    pool = point_pool(torch, ts.setup)
    walls = {}
    for lanes, base in ((2, tuple(c[:, :2] for c in pool)),
                        (2 * ts.n, tuple(c[:, :1] for c in pool))):
        k = torch.randint(0, 1 << 16, (lanes, 16), generator=gen, device=dev,
                          dtype=torch.int32)
        k[..., 15] &= 0x3FFF
        k[0] = torch.as_tensor(FR.from_int(FR.modulus - 1), device=dev)
        if lanes > 2:
            k[1:3] = torch.as_tensor(FR.from_int([0, 1]), device=dev)
        out = {}
        for name in ("scalar_mul_windowed", "scalar_mul_ladder"):
            _build.launches.clear()
            out[name], wall = timed_once(
                torch, lambda: getattr(G1_LM, name)(base, k))
            walls[f"G1 {name} (24, {lanes})"] = dict(
                ms=round(wall, 3), launches=dict(_build.launches))
        same = G1_LM.eq(out["scalar_mul_windowed"],
                        out["scalar_mul_ladder"])
        check(bool(same.all().item()), f"windowed G1 ladder on {lanes} "
              f"lanes != the 256-step ladder in {int((~same).sum())} lanes")
    k2 = torch.as_tensor(FR.from_int([0xDEADBEEF, FR.modulus - 1, 0]),
                         device=dev)
    g2 = G2.gen((), dev)
    out = {}
    for name in ("scalar_mul_windowed", "scalar_mul_ladder"):
        out[name], wall = timed_once(torch, lambda: getattr(G2, name)(g2, k2))
        walls[f"G2 {name} (3,)"] = dict(ms=round(wall, 3))
    check(same_affine(torch, G2.normalize, out["scalar_mul_windowed"],
                      out["scalar_mul_ladder"]),
          "windowed G2 ladder != the 256-step ladder")
    check(bool(G2.is_inf(tuple(c[2] for c in out["scalar_mul_windowed"]))),
          "the windowed G2 ladder of 0 is not infinity")
    say_card("[windowed ladder] equal to the 256-step ladder in affine form "
             "on G1 (24, 2) and (24, 8192) and on G2; ms (CUDA events, one "
             f"call) and launches {json.dumps(walls)}")
    return walls


def pairing_path(torch, dev, say_card):
    """pairing(G1, G2) on the card against golden's value (computed on the
    host, pure Python), and e([a] P, Q) == e(P, [a] Q) with the windowed
    ladders making [a] P and [a] Q."""
    sys.path.insert(0, REPO)
    import golden.model as gold
    from tpukzg_torch.curve.g1 import G1
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.field.mont import FP, FR
    from tpukzg_torch.field.tower import FP12
    from tpukzg_torch.pairing.check import pairing
    t0 = time.perf_counter()
    want = gold.pairing(gold.G1_GEN, gold.G2_GEN)
    host_s = time.perf_counter() - t0
    p = G1.gen((), dev)
    q = G2.gen((), dev)
    e, ms = timed_once(torch, lambda: pairing(p, q))
    v = FP.to_int(FP.from_mont(e.reshape(-1, 24)))
    got = [v[2 * j:2 * j + 2] for j in range(6)]
    flat = [[c.c0, c.c1] for f6 in (want.c0, want.c1)
            for c in (f6.c0, f6.c1, f6.c2)]
    check(got == flat, "pairing(G1, G2) on the card differs from golden")
    a = torch.as_tensor(FR.from_int(0x5EEDA), device=dev)
    ap = G1.scalar_mul(p, a)
    aq = G2.scalar_mul(q, a)
    e1, ms1 = timed_once(torch, lambda: pairing(ap, q))
    e2, ms2 = timed_once(torch, lambda: pairing(p, aq))
    check(torch.equal(e1, e2), "e([a] P, Q) != e(P, [a] Q)")
    check(bool(FP12.eq(pairing(G1.inf((), dev), q),
                       FP12.one((), dev)).item()),
          "pairing(infinity, Q) is not one")
    say_card(f"[pairing] e(G1, G2)^3 on the card equals golden's "
             f"(golden {host_s:.3f} s on the host); pairing {ms:.1f}, "
             f"{ms1:.1f}, {ms2:.1f} ms (CUDA events, one call); e([a] P, Q) "
             "== e(P, [a] Q)")
    return dict(ms=[ms, ms1, ms2])


def g2_msm_path(torch, dev, say_card, n: int = 64):
    """The generic Pippenger over G2 on the card: points [d_i] Q from the
    windowed G2 ladder (seeded d), seeded scalars; equal to golden's
    [sum k_i d_i] Q in affine form."""
    sys.path.insert(0, REPO)
    import golden.model as gold
    import random
    from tpukzg_torch.curve import g2 as g2m
    from tpukzg_torch.curve.g2 import G2
    from tpukzg_torch.field.mont import FR, R_MOD
    from tpukzg_torch.msm.pippenger import Pippenger
    rng = random.Random(0x62)
    ds = [rng.randrange(R_MOD) for _ in range(n)]
    ks = [rng.randrange(R_MOD) for _ in range(n)]
    pts = G2.scalar_mul(G2.gen((n,), dev),
                        torch.as_tensor(FR.from_int(ds), device=dev))
    out, ms = timed_once(torch, lambda: Pippenger(G2).msm(
        pts, torch.as_tensor(FR.from_int(ks), device=dev)))
    s = sum(d * k for d, k in zip(ds, ks)) % R_MOD
    w = gold.g2_affine(gold.g2_mul(gold.G2_GEN, s))
    x, y, inf = g2m.point_to_ints(tuple(c.cpu() for c in out))
    check((x, y) == ((w[0].c0, w[0].c1), (w[1].c0, w[1].c1)) and not inf,
          f"the G2 MSM of {n} points differs from golden")
    say_card(f"[G2 msm n={n}] generic Pippenger (tensor code, c = 4) equals "
             f"golden's [sum k_i d_i] Q in affine form: {ms:.1f} ms (CUDA "
             "events, one call)")
    return dict(ms=ms)


def msm_batch_path(torch, ts, paths, say_card, k: int = 16):
    """msm_batch with k seeded scalar rows over the n = 4096 Lagrange SRS
    points against k calls of msm, in affine form.  Returns the first B3
    launch on a chunk of rows of n digits."""
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.kernels import bucket
    from tpukzg_torch.msm.pippenger_lm import default_window, msm, msm_batch
    dev, n = ts.device, ts.n
    gen = torch.Generator(device=dev)
    gen.manual_seed(0xBA7)
    sc = torch.randint(0, 1 << 16, (k, n, 16), generator=gen, device=dev,
                       dtype=torch.int32)
    sc[..., 15] &= 0x3FFF
    pts = ts.setup.lagrange_g1
    cap, orig = {}, bucket._launch

    def rec(p, seg):
        if seg.shape[1] == n:
            cap.setdefault("rows", (tuple(c.clone() for c in p), seg.clone()))
        return orig(p, seg)

    bucket._launch = rec
    try:
        out, wall, paths["msm_batch"] = run_path(torch,
                                                 lambda: msm_batch(pts, sc))
    finally:
        bucket._launch = orig
    rows, wall_rows, paths["msm_rows"] = run_path(
        torch, lambda: [msm(pts, sc[i]) for i in range(k)])
    want = tuple(torch.stack([r[i] for r in rows]) for i in range(3))
    same = G1_LM.eq(tuple(c.movedim(-1, 0) for c in out),
                    tuple(c.movedim(-1, 0) for c in want))
    check(bool(same.all().item()), f"msm_batch differs from msm in "
          f"{int((~same).sum())} of {k} rows")
    say_card(f"[msm_batch k={k} n={n}] equal to {k} calls of msm in affine "
             f"form: {wall:.3f} s (c = {default_window(n)}; kernel launches "
             f"{json.dumps(paths['msm_batch'])}) against {wall_rows:.3f} s "
             f"for the {k} calls ({json.dumps(paths['msm_rows'])})")
    check("rows" in cap, "no B3 launch on rows of n digits was captured")
    return cap["rows"], dict(wall=wall, wall_rows=wall_rows)


def dist_rank(rank, world, log_n_msm, log_n_ntt, batches):
    """One rank of the multi-GPU phase (NCCL, the card of its rank): the
    sharded MSM over 2^log_n_msm points (the SRS tiled, as msm_path),
    the four-step NTT at 2^log_n_ntt and the sharded batch verify of
    `batches` [(name, numpy args of Kzg.verify_batch)].  Rank 0 also
    runs the single-device references.  -> walls, checks and launches
    (CPU values)."""
    import torch
    import tpukzg_torch
    from tpukzg_torch.curve.g1 import G1
    from tpukzg_torch.curve.weierstrass_lm import G1_LM
    from tpukzg_torch.dist import (DistNtt, MeshConfig, ShardedBatchVerifier,
                                   ShardedMsm)
    from tpukzg_torch.kernels import _build
    from tpukzg_torch.msm.pippenger_lm import msm
    from tpukzg_torch.ntt.ntt import get_plan
    mesh = MeshConfig().build()
    dev = mesh.device
    ts = tpukzg_torch.generate_insecure_setup(0xDEADBEEF, 4096, device=dev)
    out = dict(rank=rank, world=world, device=str(dev),
               card=torch.cuda.get_device_name(dev), walls={},
               launches={}, checks={})

    def timed(name, fn):
        torch.cuda.synchronize(dev)
        _build.launches.clear()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize(dev)
        out["walls"][name] = time.perf_counter() - t0
        out["launches"][name] = dict(_build.launches)
        return r

    s = ts.setup
    points, k = msm_inputs(torch, s, log_n_msm)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0x5EED22)
    sm = ShardedMsm(G1, mesh=mesh)
    timed("sharded_msm", lambda: sm.msm(points, k))       # warm-up
    got = timed("sharded_msm", lambda: sm.msm(points, k))
    out["msm_affine"] = [int(v) for v in torch.cat(G1.normalize(got)[:2])
                         .cpu().tolist()]
    if rank == 0:
        want = timed("single_msm", lambda: msm(points, k))
        out["checks"]["sharded_msm == msm"] = bool(G1_LM.eq(
            tuple(c[:, None] for c in got),
            tuple(c[:, None] for c in want)).all().item())
    del points, k

    n = 1 << log_n_ntt
    dn = timed("dist_ntt_plan", lambda: DistNtt(n, mesh=mesh))
    out["ntt_split"] = [dn.n1, dn.n2]
    m = n // world
    vec = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev,
                        dtype=torch.int32)
    vec[:, 15] &= 0x3FFF
    mine = vec[rank * m:(rank + 1) * m]
    timed("dist_ntt", lambda: dn.ntt(mine))                # warm-up
    fwd = timed("dist_ntt", lambda: dn.ntt(mine))
    back = timed("dist_intt", lambda: dn.intt(fwd))
    plan = get_plan(n)
    out["checks"]["dist ntt == NttPlan"] = bool(torch.equal(
        fwd, plan.ntt(vec)[rank * m:(rank + 1) * m]))
    out["checks"]["dist intt == NttPlan"] = bool(torch.equal(
        back, plan.intt(plan.ntt(vec))[rank * m:(rank + 1) * m]))
    out["checks"]["dist intt(ntt) == input"] = bool(torch.equal(back, mine))

    sbv = ShardedBatchVerifier(s, mesh=mesh)
    out["verdicts"] = {}
    for i, (name, args) in enumerate(batches):
        t = tuple(tuple(torch.as_tensor(c, device=dev) for c in a)
                  if isinstance(a, tuple) else torch.as_tensor(a, device=dev)
                  for a in args)
        for _ in range(1 if i else 2):                  # the first: warm-up
            out["verdicts"][name] = bool(timed(
                f"sharded_verify {name}", lambda: sbv.verify_batch(*t))
                .item())
    return out


def verify_args(torch, ts, blobs, cs, pfs):
    """The arguments of Kzg.verify_batch for one batch of blobs, as the
    sync path computes them (decompressed C and pi, z, y, the powers of
    rho), as numpy arrays."""
    from tpukzg_torch.field.mont import FR
    from tpukzg_torch.kzg import transcript
    from tpukzg_torch.kzg.blob import _PendingBatch, fr_ints_from_limbs
    pb = _PendingBatch(ts.blob, blobs, cs, pfs)
    y_can = pb._y_dev.cpu()
    _, rho = transcript.compute_r_powers(cs, pb._zs, fr_ints_from_limbs(
        y_can), pfs, ts.n)
    return (tuple(c.cpu().numpy() for c in pb._c_pts), pb._z_can,
            y_can.numpy(), tuple(c.cpu().numpy() for c in pb._pi_pts),
            FR.from_int(rho).reshape(len(blobs), 16))


def dist_path(torch, ts, batches, say_card, log_n_msm: int = 22,
              log_n_ntt: int = 18):
    """The multi-GPU paths through dist.launch at world size = the cards
    present, NCCL, one card a rank, after this process built the kernels
    (no rank runs nvcc): ShardedMsm at 2^22 points equal to the
    single-device msm in affine form, DistNtt at 2^18 equal to NttPlan
    bit for bit (forward and inverse), ShardedBatchVerifier's verdicts
    equal to the sync path's."""
    from tpukzg_torch.dist import launch
    world = torch.cuda.device_count()
    args = [(name, verify_args(torch, ts, *b)) for name, b, _ in batches]
    t0 = time.perf_counter()
    outs = launch.run(dist_rank, world, "nccl",
                      args=(log_n_msm, log_n_ntt, args), timeout=600)
    wall = time.perf_counter() - t0
    r0 = outs[0]
    for o in outs:
        check(o["msm_affine"] == r0["msm_affine"], f"rank {o['rank']}'s "
              "sharded MSM differs from rank 0's")
        check(all(o["checks"].values()), f"rank {o['rank']}: "
              f"{json.dumps(o['checks'])}")
        check(o["verdicts"] == {name: want for name, _, want in batches},
              f"rank {o['rank']}: sharded verdicts {o['verdicts']}")
    check(r0["checks"].get("sharded_msm == msm"),
          "the sharded MSM differs from the single-device msm")
    say_card(f"[dist world={world}] NCCL, ranks on "
             f"{[o['device'] for o in outs]}; the run {wall:.1f} s (process "
             f"start, setup load and the paths); ShardedMsm 2^{log_n_msm} == "
             f"msm, DistNtt 2^{log_n_ntt} (n1, n2 = {r0['ntt_split']}) == "
             f"NttPlan forward and inverse, ShardedBatchVerifier verdicts "
             f"{json.dumps(r0['verdicts'])} == the sync path's; rank 0 walls "
             f"(s) {json.dumps({k: round(v, 4) for k, v in r0['walls'].items()})}")
    say_card(f"[dist world={world}] rank 0 kernel launches "
             f"{json.dumps(r0['launches'])}")
    return r0


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA card")
        return 1
    import tpukzg_torch
    from tpukzg_torch.kernels import _build, bucket, fractree
    from tpukzg_torch.kzg.fixtures import load_triples
    from tpukzg_torch.field.mont import FP, FR
    assert "jax" not in sys.modules and "tpukzg" not in sys.modules

    # 1. the card
    card = card_line()
    say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    say(f"[build] {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_info.get('seconds', 0.0):.1f} s) "
        f"-> {os.path.relpath(_build.build_info['path'], REPO)}")
    ptxas = ptxas_summary(_build.build_info.get("log", ""))
    for src in sorted(ptxas):
        say(f"[ptxas {src}] {json.dumps(ptxas[src])}")
    for src in ("bucket.cu", "ec.cu", "ntt.cu", "fractree.cu", "montmul.cu"):
        check(ptxas.get(src), f"no ptxas report for {src} in the build log")
        spilled = {k: v for k, v in ptxas[src].items()
                   if v.get("spill_bytes", 0)}
        check(not spilled, f"{src} spills: {spilled}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0x5EED)
    results = {}

    # 3. B1, B2
    for field in (FP, FR):
        r = check_montmul(torch, field, 1 << 20, gen, REPS)
        results["montmul_" + field.name.lower()] = r
        say(f"[B1 montmul {field.name}] ok, {r['check']}: {r['ms']:.4f} ms "
            f"on the card, {r['call_ms']:.4f} ms a call (plain "
            f"{r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms; an "
            f"elementwise op with the same loads and stores "
            f"{r['floor_ms']:.4f} ms) [{card}]")
        err, bounds = check_montmul_shadow(torch, field, gen)
        say(f"[B1 montmul {field.name} vs the CIOS shadow] ok, bit-exact on "
            f"256 lanes incl. R-1, p-1, 0, 1, R mod p in both operands; the "
            f"shadow's largest value at each site (every one within its "
            f"width) {json.dumps({k: hex(v) for k, v in bounds.items()})}")

    setup_t0 = time.perf_counter()
    ts = tpukzg_torch.generate_insecure_setup(0xDEADBEEF, 4096)
    say(f"[setup] n=4096 SRS on {ts.device} in "
        f"{time.perf_counter() - setup_t0:.2f} s")
    pool = point_pool(torch, ts.setup)
    r = check_ec_add(torch, pool, 1 << 16, gen, REPS)
    results["ec_add"] = r
    say(f"[B2 ec_add] ok, {r['check']}: {r['ms']:.4f} ms on the card, "
        f"{r['call_ms']:.4f} ms a call (plain {r['plain_ms']:.2f} ms, bound "
        f"{r['bound_ms']:.4f} ms)")
    dbl_pool = check_ec_double(torch, pool, 1 << 16, gen, REPS)
    say_double(dbl_pool, dbl_pool["check"], card)
    from tpukzg_torch.kernels import ec as ec_mod
    cross = double_crossover(torch, pool, gen, REPS)
    say(f"[B6 crossover] the launcher runs four threads a point up to "
        f"{ec_mod.QUAD_MAX_LANES} lanes, one above; ms on the card by "
        f"threads a point "
        f"{json.dumps(cross)} [{card}]")

    # 4. the main path
    k_main = 256
    blobs, cs, pfs = load_triples(4096, 16, k_main)
    ts.blob.timing = True
    t0 = time.perf_counter()
    ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs[:8], cs[:8], pfs[:8],
                                                  ts)
    say(f"[slice k=8 warm-up] {ok} in {time.perf_counter() - t0:.2f} s "
        f"phases {json.dumps({k: round(v, 4) for k, v in ts.blob.last_phases.items()})}")
    check(ok is True, "k=8 warm-up did not verify")

    captured = {}
    orig_launch, orig_ft = bucket._launch, fractree.fractree_partials

    def rec_launch(pts, seg):
        captured.setdefault(("bucket", tuple(seg.shape)), (pts, seg))
        return orig_launch(pts, seg)

    def rec_ft(evals, z, roots):
        captured.setdefault("fractree", (evals, z, roots))
        return orig_ft(evals, z, roots)

    # B6's inputs: the fold's Horner runs (2 lanes, c = 8) and the
    # longest run of the subgroup check's chain on the 2k decompressed
    # points (32 doublings)
    fold_run, x_run = (2, 8), (2 * k_main, 32)
    bucket._launch, fractree.fractree_partials = rec_launch, rec_ft
    try:
        with DoubleRuns(torch, [fold_run, x_run]) as dbl, \
                PowRuns(torch) as pw:
            _build.launches.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, pfs, ts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_build.launches)
    finally:
        bucket._launch, fractree.fractree_partials = orig_launch, orig_ft
    phases = dict(ts.blob.last_phases)
    say(f"[slice k={k_main}] {ok} in {wall:.3f} s = "
        f"{k_main / wall:.2f} verifications/s; phases (s) "
        f"{json.dumps({k: round(v, 4) for k, v in phases.items()})}")
    say(f"[slice k={k_main}] kernel launches {json.dumps(launches)}")
    check(ok is True, f"k={k_main} batch did not verify")
    check_b1_launches({"verify": launches})

    bad = bytearray(pfs[k_main // 2])
    bad[13] ^= 4
    t0 = time.perf_counter()
    ok_bad = tpukzg_torch.verify_blob_kzg_proof_batch(
        blobs, cs, pfs[:k_main // 2] + [bytes(bad)] + pfs[k_main // 2 + 1:],
        ts)
    say(f"[slice k={k_main} tampered proof {k_main // 2}] {ok_bad} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(ok_bad is False, "tampered batch did not fail")
    swapped = [pfs[1], pfs[0]] + pfs[2:]
    t0 = time.perf_counter()
    ok_swap = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, swapped, ts)
    swap_phases = dict(ts.blob.last_phases)
    say(f"[slice k={k_main} proofs 0 and 1 swapped] {ok_swap} in "
        f"{time.perf_counter() - t0:.2f} s; phases (s) "
        f"{json.dumps({k: round(v, 4) for k, v in swap_phases.items()})}")
    check(ok_swap is False, "batch with swapped proofs did not fail")
    check("fold_msm" in swap_phases and "pairing" in swap_phases,
          "batch with swapped proofs was not decided by the pairing")

    # 4b. the pipelined, async and chunked entry points
    ts.blob.timing = False
    tampered = pfs[:k_main // 2] + [bytes(bad)] + pfs[k_main // 2 + 1:]
    batches = [(blobs, cs, pfs), (blobs, cs, tampered), (blobs, cs, swapped),
               (blobs, cs, pfs)]
    sync_verdicts = [ok, ok_bad, ok_swap, ok]
    # resolved at once, the async entry is the sync path (with no phase
    # syncs): its wall is the one the pipeline is compared with
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    resolve = tpukzg_torch.verify_blob_kzg_proof_batch_async(blobs, cs, pfs,
                                                             ts)
    ok_async = resolve()
    async_wall = time.perf_counter() - t0
    check(ok_async is True, "the async verify of the valid batch failed")
    verdicts, strict_wall = pipeline_path(torch, ts, batches, True)
    check(verdicts == [True, False, False, True] == sync_verdicts,
          f"pipelined verdicts {verdicts}, sync {sync_verdicts}")
    again, pipe_wall = pipeline_path(torch, ts, batches, False)
    check(again == verdicts, f"pipelined verdicts {again} the second time")
    say(f"[pipeline k={k_main}] bench.py's schedule over 4 batches (valid, "
        f"tampered proof, swapped proofs, valid): verdicts {verdicts} (sync "
        f"path {sync_verdicts}); stages 1 and 2 passed under sync debug "
        f"mode \"error\" but for the y readback ({strict_wall:.3f} s in "
        f"all); run again without it: {pipe_wall:.3f} s in all, sustained "
        f"{pipe_wall / len(batches):.3f} s a batch, fill and drain included "
        f"(sync path {async_wall:.3f} s a batch, the async entry resolved "
        f"at once) [{card}]")
    chunk_walls, chunk_ok = [], []
    bad_i = 2 * 64 + 5                        # in the third chunk of 64
    bad_blob = bytearray(blobs[bad_i])
    bad_blob[31] ^= 1                         # element 0's lowest bit
    for bl in (blobs, blobs[:bad_i] + [bytes(bad_blob)] + blobs[bad_i + 1:]):
        t0 = time.perf_counter()
        chunk_ok.append(tpukzg_torch.verify_blob_kzg_proof_batch_chunked(
            bl, cs, pfs, ts, chunk=64))
        chunk_walls.append(time.perf_counter() - t0)
    say(f"[async k={k_main}] {ok_async} in {async_wall:.3f} s; [chunked "
        f"k={k_main}, chunk 64] valid {chunk_ok[0]} in {chunk_walls[0]:.3f} "
        f"s, blob {bad_i} tampered (chunk 3) {chunk_ok[1]} in "
        f"{chunk_walls[1]:.3f} s [{card}]")
    check(chunk_ok == [True, False], f"chunked verdicts {chunk_ok}")
    # 4c. the CLI's bench verb, in its own process (bench.py's shape but
    # four reps): its line beside the pipeline phase's own rate
    line, bench_wall, bench_launches, log = bench_phase(torch, k_main, 4,
                                                        launches)
    steps = re.search(r"block_times=(\[.*?\]) sustained=(\S+)", log)
    say(f"[bench] python -m tpukzg_torch.cli bench --k {k_main} --reps 4: "
        f"{json.dumps(line)} in {bench_wall:.1f} s; its step times "
        f"{steps.group(1) if steps else '?'} sustained "
        f"{steps.group(2) if steps else '?'} a batch; launches in its timed "
        f"reps {json.dumps(bench_launches)} [{card}]")
    say(f"[bench] beside it, the pipeline phase above: "
        f"{k_main / (pipe_wall / len(batches)):.2f} verifications/s (k / "
        f"sustained s; compared, not checked: the host's spread is up to "
        f"2x) against the bench's {line['value']:.2f} [{card}]")
    ops = count_dispatch(torch, lambda: tpukzg_torch.verify_blob_kzg_proof_batch(
        blobs, cs, pfs, ts))
    say(f"[slice k={k_main}] one more verify, counted: {ops} tensor ops "
        "dispatched to the card (kernel launches of the port included) "
        f"[{card}]")
    wall_p, busy, n_dev, top, (freed, gc_s) = device_busy(
        torch, lambda: tpukzg_torch.verify_blob_kzg_proof_batch(
            blobs, cs, pfs, ts))
    if n_dev:
        say(f"[slice k={k_main}] one more verify, profiled: {n_dev} device "
            f"kernels busy {busy:.4f} s of {wall_p:.3f} s wall "
            f"({100 * busy / wall_p:.1f} %; unprofiled wall {wall:.3f} s); "
            f"top device ms {json.dumps(top)}; the trace's cyclic garbage, "
            f"{freed} objects, collected after it in {gc_s:.3f} s")
    else:
        say(f"[slice k={k_main}] device busy share not measured: the "
            "profiler trace holds no device events")

    # 5. B6, B3, B4 on the main path's own inputs
    b6 = {}
    for key, name in ((fold_run, "verify fold, Horner run"),
                      (x_run, "decompress, subgroup check's longest run")):
        check(key in dbl.got, f"no B6 call on {key[0]} lanes x{key[1]} in "
              "the k = 256 verify")
        r = b6[name] = hold_ec_double(torch, *dbl.got[key], REPS)
        say_double(r, name, card)
    from tpukzg_torch.field.mont import P_MOD, R_MOD
    chains = {}
    for name, e, lanes in (("decompress square root", (P_MOD + 1) // 4,
                            2 * k_main),
                           ("pairing's G1 points to affine form, Fp "
                            "inversion", P_MOD - 2, 2),
                           ("final exponentiation's Fp inversion",
                            P_MOD - 2, 1)):
        hit = [(x, f) for x, e_, f in pw.got
               if e_ == e and x.numel() // f.L == lanes]
        check(hit, f"no chain launch of {name} in the k = {k_main} verify")
        r = chains[name] = hold_pow(torch, hit[0][0], e, hit[0][1], REPS)
        say_pow(r, name, card)
    seg_key = [key for key in captured if key != "fractree"]
    check(len(seg_key) == 2, f"bucket scan inputs captured: {seg_key}")
    parts = []
    for key in sorted(seg_key, key=lambda s: -s[1][1]):
        pts, seg = captured[key]
        r = check_bucket(torch, pts, seg, REPS)
        parts.append(r)
        say(f"[B3 bucket scan {r['shape']}] ok, affine-equal in every lane, "
            f"the same limbs twice: {r['ms']:.3f} ms on the card, "
            f"{r['call_ms']:.3f} ms a call (plain "
            f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms, "
            f"{r['adds']} adds; device kernels launched and their blocks "
            f"{json.dumps(r['grid'])})")
    results["bucket_scan"] = dict(
        max_abs_err=max(p["max_abs_err"] for p in parts),
        ms=sum(p["ms"] for p in parts),
        call_ms=sum(p["call_ms"] for p in parts),
        plain_ms=sum(p["plain_ms"] for p in parts),
        bound_ms=sum(p["bound_ms"] for p in parts),
        bound_by="operations" if all(p["bound_by"] == "operations"
                                     for p in parts) else "bytes",
        shape=[p["shape"] for p in parts],
        grid=[p["grid"] for p in parts],
        device_kernels=[p["device_kernels"] for p in parts],
        check="segmented and suffix (single-segment) scans affine-equal "
              "in every lane, the same limbs on two launches")
    evals, z, roots = captured["fractree"]
    r = check_fractree(torch, evals, z, roots, ts.setup.plan, REPS)
    results["fractree"] = r
    say(f"[B4 fractree {r['shape']}] ok, {r['check']}: {r['ms']:.4f} ms on "
        f"the card, {r['call_ms']:.4f} ms a call (plain {r['plain_ms']:.1f} "
        f"ms, bound {r['bound_ms']:.4f} ms; grid {json.dumps(r['grid'])})")

    # 6. the prover path
    def say_path(name, wall, launches, extra=""):
        say(f"[prover {name}] {wall:.3f} s; kernel launches "
            f"{json.dumps(launches)}{extra}")

    paths, cap_fixed, ntt_in = prover_path(torch, ts, say_path)
    paths["verify"] = launches
    check_b1_launches(paths)
    check(len(cap_fixed["pow_fr"]) == 2, "the proof batch ran "
          f"{len(cap_fixed['pow_fr'])} Fr chains, not its two inversions")
    for i, (x, e, f) in enumerate(cap_fixed["pow_fr"]):
        r = chains[f"proof batch's Fr inversion {i + 1}"] = hold_pow(
            torch, x, e, f, REPS)
        say_pow(r, f"proof batch's Fr inversion {i + 1}", card)
    r = b6["table build, a window's run"] = hold_ec_double(
        torch, *cap_fixed["table_run"], REPS)
    say_double(r, "table build", card)

    # 7. B5, B4 and the fixed-base B3 on the prover path's own inputs
    from tpukzg_torch.ntt.ntt import get_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = ts.setup.plan
    nr = {}
    for name, x, inv in (("fwd", ntt_in["fwd"], False),
                         ("inv", ntt_in["inv"], True)):
        r = check_ntt(torch, x, plan, inv, REPS)
        nr[name] = r
        say(f"[B5 ntt {r['shape']} inverse={inv}] ok, bit-exact: "
            f"{r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a call "
            f"(plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; passes {json.dumps(r['grid'])})")
        blocks = r["grid"][0]["blocks"]
        check(blocks >= sms, f"B5 {r['shape']} ran its first pass on "
              f"{blocks} blocks, {sms} SMs")
    t0 = time.perf_counter()
    big = get_plan(1 << 18)
    say(f"[B5 ntt] n = 2^18 plan on the host in "
        f"{time.perf_counter() - t0:.2f} s")
    lim = torch.randint(0, 1 << 16, (1, 1 << 18, 16), generator=gen,
                        device="cuda", dtype=torch.int32)
    lim[..., 15] &= 0x3FFF                     # below 2^254 < r
    for name, inv in (("fwd_2^18", False), ("inv_2^18", True)):
        r = check_ntt(torch, lim, big, inv, REPS)
        nr[name] = r
        say(f"[B5 ntt {r['shape']} inverse={inv}] ok, bit-exact: "
            f"{r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms a call "
            f"(plain {r['plain_ms']:.2f} ms, bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}; passes {json.dumps(r['grid'])})")
        check(len(r["grid"]) <= 3, f"B5 at 2^18 ran {len(r['grid'])} passes")
    r = dict(nr["fwd"])
    r["check"] = ("bit-exact vs plain: (16, 4096) fwd and inv on the "
                  "prover path's own inputs, (1, 2^18) fwd and inv")
    r["other_shapes"] = {k: {f: v[f] for f in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "shape",
        "grid")} for k, v in nr.items() if k != "fwd"}
    results["ntt"] = r
    check("fractree" in cap_fixed, "no proof-batch B4 input was captured")
    f16 = check_fractree(torch, *cap_fixed["fractree"], plan, REPS)
    say(f"[B4 fractree {f16['shape']}, the proof batch's] ok, "
        f"{f16['check']}: {f16['ms']:.4f} ms on the card, "
        f"{f16['call_ms']:.4f} ms a call (plain {f16['plain_ms']:.1f} ms, "
        f"bound {f16['bound_ms']:.4f} ms; grid {json.dumps(f16['grid'])})")
    check(f16["grid"]["blocks"] >= sms, f"B4 at k = 16 ran "
          f"{f16['grid']['blocks']} blocks on {sms} SMs")
    results["fractree"]["other_shapes"] = {"proof_batch": {
        f: f16[f] for f in ("max_abs_err", "ms", "call_ms", "plain_ms",
                            "bound_ms", "bound_by", "shape", "grid")}}
    check("fixed" in cap_fixed, "no fixed-base scan chunk was captured")
    pts, seg = cap_fixed["fixed"]
    r = check_bucket(torch, pts, seg, REPS)
    r["check"] = ("affine-equal in every lane of a fixed-base MSM chunk, "
                  "the same limbs on two launches")
    check("suffix" in cap_fixed, "no fixed-base suffix scan was captured")
    s = check_bucket(torch, *cap_fixed["suffix"], REPS)
    say(f"[B3 bucket scan suffix {s['shape']}] ok, affine-equal in every "
        f"lane, the same limbs twice: {s['ms']:.3f} ms on the card, "
        f"{s['call_ms']:.3f} ms a call (plain "
        f"{s['plain_ms']:.1f} ms, bound {s['bound_ms']:.4f} ms by "
        f"{s['bound_by']}; device kernels launched and their blocks "
        f"{json.dumps(s['grid'])})")
    r["other_shapes"] = {"suffix": {f: s[f] for f in (
        "ms", "call_ms", "plain_ms", "bound_ms", "bound_by", "shape", "grid")}}
    results["bucket_scan_fixed"] = r
    say(f"[B3 bucket scan fixed-base {r['shape']}] ok, affine-equal in every "
        f"lane, the same limbs twice: {r['ms']:.3f} ms on the card, "
        f"{r['call_ms']:.3f} ms a call (plain "
        f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms by "
        f"{r['bound_by']}, {r['adds']} adds; device kernels launched and "
        f"their blocks {json.dumps(r['grid'])})")
    blocks = r["grid"].get("scan_local", 0)
    check(blocks >= sms, f"fixed-base B3 ran {blocks} blocks on "
          f"{sms} SMs")

    alt = alternatives(torch, ntt_in["fwd"], lim, plan, big,
                       {16: cap_fixed["fractree"], 256: captured["fractree"]},
                       REPS)
    for key, times in alt.items():
        say(f"[alternatives {key}] ms {json.dumps(times)}")
    results["ntt"]["alternatives"] = {k: v for k, v in alt.items()
                                      if k.startswith("ntt")}
    results["fractree"]["alternatives"] = {k: v for k, v in alt.items()
                                           if k.startswith("fractree")}

    # 8. the setup paths: setup generation, compressed load, single
    # verify, the 2^20-point MSM (and B3 on one of its chunk's rows)
    def say_card(msg):
        say(f"{msg} [{card}]")

    triples = load_triples(4096, 16)
    b2_gen, run_gen = setup_path(torch, ts, triples, paths, say_card)
    compressed_path(torch, ts, triples, paths, say_card)
    b2_one, run_one = single_verify_path(torch, ts, triples, paths, say_card)
    check_b1_launches(paths)
    results["ec_add"]["other_shapes"] = {"setup_gen_g1_ladder": b2_gen,
                                         "verify_kzg_proof_ladder": b2_one}
    (pts, seg), by_shape = msm_path(torch, ts.setup, paths, say_card)
    r = check_bucket(torch, pts, seg, REPS)
    r["check"] = ("affine-equal in every lane of one row of a 2^20-point "
                  "MSM chunk, the same limbs on two launches")
    r["msm_launches_by_shape"] = by_shape
    results["bucket_scan_msm"] = r
    say_card(f"[B3 bucket scan 2^20 MSM row {r['shape']}] ok, affine-equal "
             f"in every lane, the same limbs twice: {r['ms']:.3f} ms on the "
             f"card, {r['call_ms']:.3f} ms a call (plain "
             f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms by "
             f"{r['bound_by']}, {r['adds']} adds; device kernels launched "
             f"and their blocks {json.dumps(r['grid'])})")
    # 9. this slice's paths: the windowed ladder, the pairing, the G2 and
    # batch MSMs, and the multi-GPU paths
    windowed_path(torch, ts, say_card)
    pairing_path(torch, ts.device, say_card)
    g2_msm_path(torch, ts.device, say_card)
    (pts, seg), _ = msm_batch_path(torch, ts, paths, say_card)
    r = check_bucket(torch, pts, seg, REPS)
    r["check"] = ("affine-equal in every lane of msm_batch's first chunk of "
                  "rows (k = 16 rows a window), the same limbs on two "
                  "launches")
    results["bucket_scan_msm_batch"] = r
    say_card(f"[B3 bucket scan msm_batch {r['shape']}] ok, affine-equal in "
             f"every lane, the same limbs twice: {r['ms']:.3f} ms on the "
             f"card, {r['call_ms']:.3f} ms a call (plain {r['plain_ms']:.1f} "
             f"ms, bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
             f"{r['adds']} adds; device kernels launched and their blocks "
             f"{json.dumps(r['grid'])})")
    for name, run in (("windowed ladder, verify_kzg_proof's run", run_one),
                      ("windowed ladder, the setup's G1 run", run_gen)):
        r = b6[name] = hold_ec_double(torch, *run, REPS)
        say_double(r, name, card)
    r0 = dist_path(torch, ts, [
        ("valid", (blobs, cs, pfs), ok),
        ("tampered", (blobs, cs, tampered), ok_bad),
        ("swapped", (blobs, cs, swapped), ok_swap)], say_card)
    # B5 at the batches DistNtt launched: its split as the ranks built it
    world, (n1, n2) = r0["world"], r0["ntt_split"]
    for name, rows, plan_n in (("dist_cols", n2 // world, n1),
                               ("dist_rows", n1 // world, n2)):
        x = torch.randint(0, 1 << 16, (rows, plan_n, 16), generator=gen,
                          device="cuda", dtype=torch.int32)
        x[..., 15] &= 0x3FFF
        for inv in (False, True):
            r = check_ntt(torch, x, get_plan(plan_n), inv, REPS)
            key = f"{name}{'_inv' if inv else ''}"
            results["ntt"]["other_shapes"][key] = {f: r[f] for f in (
                "max_abs_err", "ms", "call_ms", "plain_ms", "bound_ms",
                "bound_by", "shape", "grid")}
            say_card(f"[B5 ntt {r['shape']} inverse={inv}, DistNtt's "
                     f"{name[5:]} at world {world}] ok, bit-exact: "
                     f"{r['ms']:.4f} ms on the card, {r['call_ms']:.4f} ms "
                     f"a call (plain {r['plain_ms']:.2f} ms, bound "
                     f"{r['bound_ms']:.4f} ms by {r['bound_by']})")
    for name in ("sharded_msm", "dist_ntt", "sharded_verify valid"):
        paths[name.split()[0]] = r0["launches"][name]
    say_card("[B6 ec_double] launches by path "
             f"{json.dumps({p: c.get('ec_double', 0) for p, c in paths.items()})}")
    say_card("[B2 ec_add] launches by path "
             f"{json.dumps({p: c.get('ec_add', 0) for p, c in paths.items()})}")
    for path, need in (("setup_gen", ("ec_add", "ec_double", "montmul_fp")),
                       ("from_compressed", ("ec_add", "ec_double",
                                            "montmul_fp")),
                       ("verify_kzg_proof", ("ec_add", "ec_double",
                                             "montmul_fp")),
                       ("msm_2^20", ("bucket_scan", "ec_add", "ec_double")),
                       ("tables", ("ec_double",)),
                       ("msm_batch", ("bucket_scan", "ec_add", "ec_double")),
                       ("sharded_msm", ("bucket_scan", "ec_add",
                                        "ec_double")),
                       ("dist_ntt", ("ntt", "montmul_fr")),
                       ("sharded_verify", ("bucket_scan", "ec_add",
                                           "ec_double"))):
        for kern in need:
            check(paths[path].get(kern, 0) > 0,
                  f"{kern} was not launched on the {path} path")

    # 10. report
    fold = dict(b6["verify fold, Horner run"])
    fold["check"] = ("bit-exact vs plain at every captured run: the verify "
                     "fold's, the subgroup check's, a table window's, the "
                     "windowed ladder's runs of 4 (verify_kzg_proof's and "
                     "the setup's); and at t = 1 on 2^16 lanes incl. "
                     "infinity")
    fold["other_shapes"] = {name: r for name, r in b6.items()
                            if name != "verify fold, Horner run"}
    fold["other_shapes"]["pool, t = 1"] = dbl_pool
    results["ec_double"] = fold
    sq = dict(chains["decompress square root"])
    sq["check"] = ("bit-exact vs the plain chain on the inputs the verify "
                   "gave it: the decompress square root, the pairing's "
                   "and the final exponentiation's Fp inversions")
    sq["other_shapes"] = {k: v for k, v in chains.items()
                          if k.startswith(("final", "pairing"))}
    results["montmul_pow_fp"] = sq
    fr = dict(chains["proof batch's Fr inversion 1"])
    fr["check"] = ("bit-exact vs the plain chain on the proof batch's two "
                   "Fr inversions")
    fr["other_shapes"] = {"proof batch's Fr inversion 2": chains[
        "proof batch's Fr inversion 2"]}
    results["montmul_pow_fr"] = fr
    meta = {
        "montmul_fp": ("src/tpukzg_torch/csrc/montmul.cu",
                       "src/tpukzg/pallas/montmul.py:133"),
        "montmul_fr": ("src/tpukzg_torch/csrc/montmul.cu",
                       "src/tpukzg/pallas/montmul.py:133"),
        "montmul_pow_fp": ("src/tpukzg_torch/csrc/montmul.cu",
                           "src/tpukzg/pallas/montmul.py:133"),
        "montmul_pow_fr": ("src/tpukzg_torch/csrc/montmul.cu",
                           "src/tpukzg/pallas/montmul.py:133"),
        "ec_add": ("src/tpukzg_torch/csrc/ec.cu",
                   "src/tpukzg/pallas/ec.py:71"),
        "ec_double": ("src/tpukzg_torch/csrc/ec.cu",
                      "src/tpukzg/pallas/ec.py:103"),
        "bucket_scan": ("src/tpukzg_torch/csrc/bucket.cu",
                        "src/tpukzg/pallas/bucket.py:117"),
        "fractree": ("src/tpukzg_torch/csrc/fractree.cu",
                     "src/tpukzg/pallas/fractree.py:51"),
        "bucket_scan_fixed": ("src/tpukzg_torch/csrc/bucket.cu",
                              "src/tpukzg/pallas/bucket.py:117"),
        "ntt": ("src/tpukzg_torch/csrc/ntt.cu",
                "src/tpukzg/pallas/ntt.py:99"),
        "bucket_scan_msm": ("src/tpukzg_torch/csrc/bucket.cu",
                            "src/tpukzg/pallas/bucket.py:117"),
        "bucket_scan_msm_batch": ("src/tpukzg_torch/csrc/bucket.cu",
                                  "src/tpukzg/pallas/bucket.py:117"),
    }
    # the path whose launches each entry reports; the counter name
    path_of = {"montmul_pow_fr": ("proof_batch", "montmul_pow_fr"),
               "bucket_scan_fixed": ("commit_batch", "bucket_scan"),
               "ntt": ("coeff", "ntt"),
               "bucket_scan_msm": ("msm_2^20", "bucket_scan"),
               "bucket_scan_msm_batch": ("msm_batch", "bucket_scan")}
    regs = {"montmul_fp": ptxas["montmul.cu"],
            "montmul_fr": ptxas["montmul.cu"],
            "montmul_pow_fp": ptxas["montmul.cu"],
            "montmul_pow_fr": ptxas["montmul.cu"],
            "ec_add": ptxas["ec.cu"], "ec_double": ptxas["ec.cu"],
            "bucket_scan": ptxas["bucket.cu"],
            "bucket_scan_fixed": ptxas["bucket.cu"],
            "bucket_scan_msm": ptxas["bucket.cu"],
            "bucket_scan_msm_batch": ptxas["bucket.cu"],
            "fractree": ptxas["fractree.cu"], "ntt": ptxas["ntt.cu"]}
    kernels = []
    for name, (src, repl) in meta.items():
        r = results[name]
        path, counter = path_of.get(name, ("verify", name))
        n_launch = int(paths[path].get(counter, 0))
        check(n_launch > 0, f"{name} was not launched on the {path} path")
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=repl, launches=n_launch, path=path,
                            launches_by_path={p: int(c.get(counter, 0))
                                              for p, c in paths.items()},
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"], library_ms=None,
                            shape=r["shape"], check=r.get("check", ""),
                            **{k: r[k] for k in ("other_shapes", "grid",
                                                 "times", "chain",
                                                 "group", "ms_one_thread",
                                                 "ms_quad",
                                                 "call_ms_one_thread",
                                                 "call_ms_quad",
                                                 "exponent_bits",
                                                 "device_kernels",
                                                 "call_ms", "floor_ms",
                                                 "alternatives",
                                                 "msm_launches_by_shape")
                               if k in r},
                            **({"ptxas": regs[name]} if name in regs
                               else {})))
    say(json.dumps({"kernels": kernels}))
    say(f"[card] {card}")
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dist_main() -> int:
    """`chip_smoke.py --dist`: the multi-GPU phase alone (dist_path) at
    world size = the cards present, with what it is compared with: the
    sync path's verdicts on the same three k = 256 batches (valid, one
    tampered proof, two proofs swapped) and, inside the ranks, the
    single-device msm and NttPlan.  For a machine with several cards."""
    import torch
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA card")
        return 1
    import tpukzg_torch
    from tpukzg_torch.kernels import _build
    from tpukzg_torch.kzg.fixtures import load_triples
    assert "jax" not in sys.modules and "tpukzg" not in sys.modules
    card = card_line()
    say(f"[card] {card} | torch {torch.__version__} cuda {torch.version.cuda}"
        f" | {torch.cuda.device_count()} cards")
    _build.lib()
    ts = tpukzg_torch.generate_insecure_setup(0xDEADBEEF, 4096)
    blobs, cs, pfs = load_triples(4096, 16, 256)
    bad = bytearray(pfs[128])
    bad[13] ^= 4
    batches = []
    for name, proofs in (("valid", pfs),
                         ("tampered", pfs[:128] + [bytes(bad)] + pfs[129:]),
                         ("swapped", [pfs[1], pfs[0]] + pfs[2:])):
        t0 = time.perf_counter()
        ok = tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, proofs, ts)
        say(f"[sync k=256 {name}] {ok} in {time.perf_counter() - t0:.3f} s")
        batches.append((name, (blobs, cs, proofs), ok))
    check([b[2] for b in batches] == [True, False, False],
          f"sync verdicts {[b[2] for b in batches]}")
    dist_path(torch, ts, batches, lambda msg: say(f"{msg} [{card}]"))
    say(json.dumps({"ok": True, "world": torch.cuda.device_count()}))
    return 0


def bary_main(src: str) -> int:
    """`chip_smoke.py --bary SRC`: the barycentric evaluation of the
    package SRC/tpukzg_torch alone, at the proof batch's shape (16 blobs
    of 4096; seeded evals and z, z_0 = w^5) -> one JSON line: ms a call
    of barycentric_eval and of B4 with the host's merge (CUDA events
    around one call), the same on the card (graph_ms), the port's
    launches in one call, and a digest of y.  Run it on two trees in
    one machine call to compare them."""
    import hashlib
    import torch
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA card")
        return 1
    sys.path.insert(0, os.path.abspath(src))
    from tpukzg_torch.kernels import _build, fractree
    from tpukzg_torch.ntt.ntt import get_plan
    from tpukzg_torch.poly.poly import _fraction_merge, barycentric_eval
    assert "jax" not in sys.modules and "tpukzg" not in sys.modules
    _build.lib()
    plan = get_plan(4096)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0xBA7)
    evals = torch.randint(0, 1 << 16, (16, 4096, 16), generator=gen,
                          device="cuda", dtype=torch.int32)
    z = torch.randint(0, 1 << 16, (16, 16), generator=gen, device="cuda",
                      dtype=torch.int32)
    evals[..., 15] &= 0x3FFF                   # below 2^254 < r
    z[..., 15] &= 0x3FFF
    roots = torch.as_tensor(plan.roots, device="cuda")
    z[0] = roots[5]

    def tree():
        return _fraction_merge(*fractree.fractree_partials(evals, z, roots))

    y = barycentric_eval(plan, evals, z, roots)
    torch.cuda.synchronize()
    _build.launches.clear()
    barycentric_eval(plan, evals, z, roots)
    launches = dict(_build.launches)
    out = dict(
        src=src, shape=[16, 4096, 16], launches=launches,
        call_ms=cuda_ms(torch, lambda: barycentric_eval(plan, evals, z,
                                                        roots), REPS),
        merge_call_ms=cuda_ms(torch, tree, REPS),
        merge_ms=graph_ms(torch, tree, REPS),
        y_sha256=hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16])
    say(f"[card] {card_line()}")
    say(json.dumps(out))
    return 0


def verify_main(src: str) -> int:
    """`chip_smoke.py --verify SRC`: the k = 256 batch verify of the
    package SRC/tpukzg_torch alone, on the n = 4096 SRS and the fixtures
    -> one JSON line: the wall of each of three timed verifies (after a
    warm-up; no phase syncs), the phases of one more (each phase ending
    in a sync), its tensor ops (count_dispatch) and its launches.  Run it
    on two trees in one machine call, in turns, to compare them."""
    import torch
    if not torch.cuda.is_available():
        say("FAIL: torch.cuda.is_available() is false; this script needs a "
            "CUDA card")
        return 1
    sys.path.insert(0, os.path.abspath(src))
    import tpukzg_torch
    from tpukzg_torch.kernels import _build
    from tpukzg_torch.kzg.fixtures import load_triples
    assert "jax" not in sys.modules and "tpukzg" not in sys.modules
    _build.lib()
    ts = tpukzg_torch.generate_insecure_setup(0xDEADBEEF, 4096)
    blobs, cs, pfs = load_triples(4096, 16, 256)

    def one():
        return tpukzg_torch.verify_blob_kzg_proof_batch(blobs, cs, pfs, ts)

    check(one() is True, "the warm-up verify failed")
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        check(one() is True, "a timed verify failed")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    ts.blob.timing = True
    _build.launches.clear()
    one()
    launches = dict(_build.launches)
    phases = {k: round(v, 4) for k, v in ts.blob.last_phases.items()}
    ts.blob.timing = False
    out = dict(src=src, k=256, walls=walls, wall_median=statistics.median(
        walls), phases=phases, launches=launches,
        tensor_ops=count_dispatch(torch, one), card=card_line())
    say(json.dumps(out))
    return 0


if __name__ == "__main__":
    try:
        if sys.argv[1:2] == ["--bary"] and len(sys.argv) == 3:
            rc = bary_main(sys.argv[2])
        elif sys.argv[1:2] == ["--verify"] and len(sys.argv) == 3:
            rc = verify_main(sys.argv[2])
        elif sys.argv[1:] == ["--dist"]:
            rc = dist_main()
        else:
            rc = main()
    except Fail as e:
        print(f"FAIL: {e}", flush=True)
        rc = 1
    except Exception:                        # noqa: BLE001 - report, exit 1
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
