"""A prover committing polynomials of N coefficients: the program's public
msm (tpukzg_torch.msm.pippenger_lm.msm) over one list of N distinct
points, with scalars drawn anew for every call.

The points are [s_i] G1 for discrete logs s_i drawn on the card from the
seed, made in set-up by the program's windowed ladder (G1 scalar_mul),
as a setup's points are.  Call j's scalars are drawn on the card below r
from (seed, j) just before the call, so no two calls of a run share
them.  msm_points_per_s is N x calls over the seconds from the first
call to the last result read back.  A sample of the window's calls,
drawn from the seed, is compared with the reference's [sum_i k_i s_i]
G1, worked out from the calls' scalars, drawn again after the window,
and the logs alone (the reference never reads the points).
"""

from __future__ import annotations

import time

import numpy as np

from h100bench import inputs, planted, work
from h100bench.reference import kzg as ref

POINTS_CHUNK = 1 << 17           # lanes of one ladder call in set-up
WARMUP_CALLS = 2
CHECK_CALLS = 16
LOGS, SCALARS, WARMUP, SAMPLE = 1, 2, 6, 4      # input streams


class Kind:
    def __init__(self, config, traffic, seed, device, root, log):
        self.cfg, self.tr = config, traffic
        self.seed, self.device, self.root, self.log = seed, device, root, log
        self.N = config["points"]

    def setup(self):
        import torch
        from tpukzg_torch.curve import g1 as g1m
        from tpukzg_torch.curve.weierstrass_lm import G1_LM
        from tpukzg_torch.msm.pippenger_lm import msm
        dev, N = self.device, self.N
        self.torch = torch
        self.logs = inputs.limbs16(torch, (N,), dev, self.seed, LOGS)
        gen = tuple(torch.as_tensor(c, device=dev)[:, None]
                    for c in g1m.GEN_NP)
        parts = [G1_LM.scalar_mul(gen, self.logs[i:i + POINTS_CHUNK])
                 for i in range(0, N, POINTS_CHUNK)]
        self.points = tuple(torch.cat([p[c] for p in parts], 1).movedim(
            0, -1).contiguous() for c in range(3))           # (N, 24) each
        del parts
        self.msm = msm
        for q in range(WARMUP_CALLS):
            self._call(WARMUP, q)

    def _scalars(self, *stream):
        return inputs.limbs16(self.torch, (self.N,), self.device, self.seed,
                              *stream)

    def _call(self, *stream):
        out = self.msm(self.points, self._scalars(*stream))
        return np.stack([c.cpu().numpy() for c in out])

    def window(self, seconds, rec):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        self.out = []
        j = 0
        while True:
            rec.step(j)
            with rec.span("msm.call"):
                self.out.append(self._call(SCALARS, j))
            j += 1
            if time.perf_counter() >= deadline:
                break
        self.seconds = time.perf_counter() - t0
        rec.step(j, final=True)
        self.attempted = j

    def end_to_end(self):
        return {"msm_points_per_s": self.N * len(self.out) / self.seconds}

    def work(self):
        return {"msm.call": work.msm_work(1, self.N, False)}

    def counters(self):
        return {}

    def release(self):
        """Keep the logs on the host for the reference; free the rest."""
        self.s_host = self.logs.cpu().numpy()
        self.points = self.logs = self.msm = None

    def check(self):
        """A seeded sample of CHECK_CALLS calls of the window, each result
        against the reference's answer for that call's scalars."""
        m = len(self.out)
        picked = sorted(int(j) for j in inputs.rng(self.seed, SAMPLE).choice(
            m, min(m, CHECK_CALLS), replace=False))
        s_bytes = ref.limb_bytes(self.s_host)
        wrong = 0
        for j in picked:
            k = self._scalars(SCALARS, j).cpu().numpy()
            want = ref.msm_answer(k, s_bytes)
            wrong += ref.point_from_limbs(*self.out[j]) != want
        self.failed = wrong
        self.log(f"checked {len(picked)} of {m} results")
        return [("msm_wrong", wrong, 0)]


def _rounded(orig):
    def broken(points, scalars, *a, **kw):
        s = scalars.clone()
        s[..., :8] = 0
        return orig(points, s, *a, **kw)
    return broken


def _half(orig):
    def broken(points, scalars, *a, **kw):
        h = scalars.shape[0] // 2
        return orig(tuple(p[:h] for p in points), scalars[:h], *a, **kw)
    return broken


def _doubled(orig):
    from tpukzg_torch.curve.weierstrass_lm import G1_LM

    def broken(points, scalars, *a, **kw):
        out = orig(points, scalars, *a, **kw)
        return tuple(c[:, 0] for c in G1_LM.double(
            tuple(c[:, None] for c in out)))
    return broken


def _stale(orig):
    """Each call answers with the previous call's result."""
    last = []

    def broken(points, scalars, *a, **kw):
        out = orig(points, scalars, *a, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    return broken


def faults() -> dict:
    """{name: () -> context manager}: the control (the scalars rounded to
    their top 128 bits, a precision step below the configuration's), half
    the points left out, the result doubled where it is produced, and a
    stale result (the previous call's) returned."""
    from tpukzg_torch.msm import pippenger_lm as pl

    def on(make):
        return lambda: planted.swap((pl, "msm", make))
    return {"control": on(_rounded), "half_batch": on(_half),
            "answer_altered": on(_doubled), "stale_answer": on(_stale)}

