"""Device trace of a traced run: torch.profiler with CUDA activity only,
started and stopped at window steps, reduced to the device's busy
seconds, its idle gaps by what the host was doing, and the device
operations that took the most time.

Busy is the union of the traced device intervals (kernels, copies,
sets), as `device_busy` of the repository's chip_smoke.py reduces them.
Device timestamps are placed on the host's perf_counter clock by a
marker: after a synchronize the device is idle, so the first device
operation after the marker's launch starts a launch latency (some
microseconds) after the host clock read just before it.
"""

from __future__ import annotations

import bisect
import collections
import gc
import time


class Tracer:
    """Traces window steps [skip, skip + steps): `step(i)` is called by a
    window at the start of its step i and once more with the final step
    count when the window ends."""

    def __init__(self, torch, device, skip: int, steps: int):
        self.torch = torch
        self.device = device
        self.skip, self.stop_at = skip, skip + steps
        self.prof = None
        self.t0 = self.t1 = None
        self.events = []             # (name, start s, end s), host clock
        # the profiler's first start sets up CUPTI (seconds): do it here,
        # before the window
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]):
            torch.zeros(1, device=device).add_(1)
            torch.cuda.synchronize(device)

    def step(self, i: int, final: bool = False) -> None:
        if self.prof is None and self.t0 is None and i == self.skip \
                and not final:
            self._start()
        elif self.prof is not None and (i >= self.stop_at or final):
            self._stop()

    def _start(self) -> None:
        torch = self.torch
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize(self.device)
        self.t_mark = time.perf_counter()
        torch.zeros(1, device=self.device).add_(1)
        self.t0 = time.perf_counter()

    def _stop(self) -> None:
        torch = self.torch
        torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        prof, self.prof = self.prof, None
        prof.__exit__(None, None, None)
        raw = []
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                raw.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name()))
        del prof
        gc.collect()      # the trace's cyclic garbage, outside any window
        if not raw:
            return
        raw.sort()
        base = raw[0][0]
        self.events = [(name, self.t_mark + (s - base) * 1e-9,
                        self.t_mark + (t - base) * 1e-9)
                       for s, t, name in raw[1:]]


def union(intervals):
    """Sorted disjoint intervals covering the given (start, end) ones."""
    out = []
    for s, t in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def busy_seconds(events, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] in which some device operation ran."""
    return sum(min(t, t1) - max(s, t0)
               for s, t in union((s, t) for _, s, t in events)
               if t > t0 and s < t1)


def idle_share(events, t0: float, t1: float) -> float:
    """Percent of [t0, t1] in which no device operation ran."""
    return 100.0 * (1.0 - busy_seconds(events, t0, t1) / (t1 - t0))


def busy_in_spans(events, spans, name: str):
    """Device-busy seconds inside the host spans called `name` (every such
    span ends in a sync, so its kernels run inside it), or None."""
    picked = [(s, t) for n, s, t in spans if n == name]
    if not picked:
        return None
    return sum(busy_seconds(events, s, t) for s, t in picked)


def idle_gaps(events, spans, t0: float, t1: float, top: int = 10):
    """Idle seconds of [t0, t1] by the host span running when each gap
    ended (the span that launched the next operation): the `top` largest
    as [[span name, seconds], ...]; outside every span: "harness"."""
    segs = union((max(s, t0), min(t, t1)) for _, s, t in events
                 if t > t0 and s < t1)
    gaps, prev = [], t0
    for s, t in segs:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if prev < t1:
        gaps.append((prev, t1))
    spans = sorted((s, t, n) for n, s, t in spans)
    starts = [s for s, _, _ in spans]
    by = collections.Counter()
    for a, b in gaps:
        i = bisect.bisect_right(starts, b) - 1
        inside = i >= 0 and spans[i][1] >= b
        by[spans[i][2] if inside else "harness"] += b - a
    return [[n, v] for n, v in by.most_common(top)]


def top_ops(events, t0: float, t1: float, top: int = 10):
    """Device seconds by operation name inside [t0, t1], the `top` largest
    as [[name, seconds], ...]."""
    by = collections.Counter()
    for name, s, t in events:
        if t > t0 and s < t1:
            by[name[:96]] += min(t, t1) - max(s, t0)
    return [[n, v] for n, v in by.most_common(top)]
