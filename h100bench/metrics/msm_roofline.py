"""msm_roofline: the least time of the public MSMs (work.py: one MSM of N
distinct points) over the device time of the operations inside the
traced "msm.call" spans, in percent."""

from h100bench import trace, work


def read(r):
    spans = [s for s in r.spans if s[0] == "msm.call"]
    busy = trace.busy_in_spans(r.events, spans, "msm.call")
    if not busy or "msm.call" not in r.work:
        return None
    least = len(spans) * work.least_seconds(r.work["msm.call"])
    return 100.0 * least / busy
