"""pairing_s_per_batch: the seconds of the verify's pairing phase (the
program's BlobKzg.last_phases["pairing"], with its phase timing on, so
the phase ends in a sync), the mean over the batches run after the
window."""


def read(r):
    return r.counters.get("pairing_s_per_batch")
