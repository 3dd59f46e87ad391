"""tensor_ops_per_batch.prove: tensor ops dispatched plus the program's own
kernel launches in one batch, counted after the window by the harness's
dispatch counter."""


def read(r):
    return r.counters.get("tensor_ops_per_batch.prove")
