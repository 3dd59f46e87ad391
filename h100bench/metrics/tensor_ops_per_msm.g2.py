"""tensor_ops_per_msm.g2: tensor ops dispatched plus the program's own
kernel launches in one G2 MSM, counted after the window by the harness's
dispatch counter."""


def read(r):
    return r.counters.get("tensor_ops_per_msm.g2")
