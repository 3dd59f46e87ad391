"""A Groth16 prover's [B]_2 = [beta]_2 + sum_i a_i [v_i(x)]_2 + s [delta]_2:
the program's public msm over G2 (tpukzg_torch.msm.pippenger_lm.msm with
curve=G2_LM) over one list of N distinct G2 points, with the witness as
scalars, drawn anew for every call.

msm_commit's kind over G2: the points are [s_i] G2 for discrete logs s_i
drawn on the card from the seed, made in set-up by the program's
windowed G2 ladder (G2_LM's scalar_mul), as a proving key's points are
fixed multiples of G2.  Each call runs in a "g2msm.call" span.  A sample
of the window's calls, drawn from the seed, is compared with the
reference's [sum_i k_i s_i] G2, worked out from the calls' scalars,
drawn again after the window, and the logs alone (the reference never
reads the points).
"""

from __future__ import annotations

import functools
import time

from h100bench import inputs, planted, work_g2
from h100bench.counters import count_dispatch
from h100bench.kinds import msm_commit
from h100bench.kinds.msm_commit import (CHECK_CALLS, LOGS, POINTS_CHUNK,
                                        SAMPLE, SCALARS, WARMUP,
                                        WARMUP_CALLS)
from h100bench.reference import bls_g2 as ref
from h100bench.reference import kzg as ref_kzg

COUNTED = 7                      # the input stream of the counted MSM


def _mont_limbs(torch, v0: int, v1: int, device):
    """An Fp2 value -> its (48, 1) Montgomery limbs: c0's 24, then c1's."""
    limbs = []
    for v in (v0, v1):
        m = v * (1 << 384) % ref.P
        limbs += [(m >> (16 * i)) & 0xFFFF for i in range(24)]
    return torch.tensor(limbs, dtype=torch.int32, device=device)[:, None]


class Kind(msm_commit.Kind):
    def setup(self):
        import torch
        from tpukzg_torch.curve.weierstrass_lm import G2_LM
        from tpukzg_torch.msm.pippenger_lm import msm
        dev, N = self.device, self.N
        self.torch = torch
        self.logs = inputs.limbs16(torch, (N,), dev, self.seed, LOGS)
        gen = tuple(_mont_limbs(torch, *v, dev) for v in
                    (ref.G2_X, ref.G2_Y, ref.ONE))
        parts = [G2_LM.scalar_mul(gen, self.logs[i:i + POINTS_CHUNK])
                 for i in range(0, N, POINTS_CHUNK)]
        self.points = tuple(torch.cat([p[c] for p in parts], 1).movedim(
            0, -1).contiguous() for c in range(3))           # (N, 48) each
        del parts
        self.msm = functools.partial(msm, curve=G2_LM)
        for q in range(WARMUP_CALLS):
            self._call(WARMUP, q)

    def window(self, seconds, rec):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.out = []
        j = 0
        while True:
            rec.step(j)
            with rec.span("g2msm.call"):
                self.out.append(self._call(SCALARS, j))
            j += 1
            if time.perf_counter() >= deadline:
                break
        self.seconds = time.perf_counter() - t0
        rec.step(j, final=True)
        self.attempted = j

    def work(self):
        return {"g2msm.call": work_g2.msm_g2_work(1, self.N)}

    def counters(self):
        """Traced runs only: one G2 MSM after the window under the
        dispatch counter."""
        return {"tensor_ops_per_msm.g2": count_dispatch(
            lambda: self._call(COUNTED, 0))}

    def check(self):
        """A seeded sample of CHECK_CALLS calls of the window, each result
        against the reference's answer for that call's scalars."""
        m = len(self.out)
        picked = sorted(int(j) for j in inputs.rng(self.seed, SAMPLE).choice(
            m, min(m, CHECK_CALLS), replace=False))
        s_bytes = ref_kzg.limb_bytes(self.s_host)
        wrong = 0
        for j in picked:
            k = self._scalars(SCALARS, j).cpu().numpy()
            wrong += ref.point_from_limbs(*self.out[j]) != ref.msm_answer(
                k, s_bytes)
        self.failed = wrong
        self.log(f"checked {len(picked)} of {m} results")
        return [("msm_wrong", wrong, 0)]


def _doubled(orig):
    from tpukzg_torch.curve.weierstrass_lm import G2_LM

    def broken(points, scalars, *a, **kw):
        out = orig(points, scalars, *a, **kw)
        return tuple(c[:, 0] for c in G2_LM.double(
            tuple(c[:, None] for c in out)))
    return broken


def faults() -> dict:
    """{name: () -> context manager}: msm_commit's faults (the control:
    the scalars rounded to their top 128 bits, a precision step below
    the configuration's; half the points left out; a stale result), with
    the result doubled over G2 where it is produced."""
    from tpukzg_torch.msm import pippenger_lm as pl
    return {**msm_commit.faults(),
            "answer_altered": lambda: planted.swap((pl, "msm", _doubled))}
