"""g2_msm_roofline: the least time of the G2 MSMs (work_g2.py's count of
one MSM of N distinct G2 points, at work.py's peaks) over the device
time of the operations inside the traced "g2msm.call" spans, in percent.
msm_roofline's reading over the G2 cell's own span, so that no ledger
line puts a G1 and a G2 share under one name."""

from h100bench import trace, work


def read(r):
    spans = [s for s in r.spans if s[0] == "g2msm.call"]
    busy = trace.busy_in_spans(r.events, spans, "g2msm.call")
    if not busy or "g2msm.call" not in r.work:
        return None
    least = len(spans) * work.least_seconds(r.work["g2msm.call"])
    return 100.0 * least / busy
