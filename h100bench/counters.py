"""Counters the harness reads around a call of the program."""

from __future__ import annotations


def count_dispatch(fn) -> int:
    """Tensor ops dispatched while fn runs (the eager path's launches,
    about one device kernel each), plus the program's own kernel
    launches as its launch counter records them (a copy of
    `count_dispatch` of the repository's chip_smoke.py)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from tpukzg_torch.kernels import _build

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    before = sum(_build.launches.values())
    with Count():
        fn()
    return Count.n + sum(_build.launches.values()) - before
