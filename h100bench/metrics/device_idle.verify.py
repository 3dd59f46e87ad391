"""device_idle.verify: percent of the traced window in which no operation
ran on the card (the union of the profiler's device intervals)."""

from h100bench import trace


def read(r):
    if not r.traced:
        return None
    return trace.idle_share(r.events, r.t0, r.t1)
