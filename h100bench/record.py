"""Host spans around the calls a window makes into the program, and the
step hook a traced run starts and stops its profiler on."""

from __future__ import annotations

import contextlib
import time


class Recorder:
    def __init__(self, tracer=None):
        self.tracer = tracer
        self.spans = []                       # (name, start s, end s)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter()))

    def step(self, i: int, final: bool = False) -> None:
        if self.tracer is not None:
            self.tracer.step(i, final)

