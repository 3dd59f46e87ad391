"""prove_batch_p95_ms: the 95th percentile of one batch's commit-plus-proof
wall over every batch of the traced run's window but the profiled ones
(host clock)."""


def read(r):
    return r.counters.get("prove_batch_p95_ms")
