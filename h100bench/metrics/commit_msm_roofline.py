"""commit_msm_roofline: the least time of the commit batches' fixed-base
MSMs (work.py: k MSMs of n points over one basis) over the device time
of the operations inside the traced "prove.commit" spans, in percent."""

from h100bench import trace, work


def read(r):
    spans = [s for s in r.spans if s[0] == "prove.commit"]
    busy = trace.busy_in_spans(r.events, spans, "prove.commit")
    if not busy or "prove.commit" not in r.work:
        return None
    least = len(spans) * work.least_seconds(r.work["prove.commit"])
    return 100.0 * least / busy
