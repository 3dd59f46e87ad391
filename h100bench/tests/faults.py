"""The breaks each cell can have, planted under the harness: every
cell's kind names its own in `faults()` (kinds/<kind>.py), among them
its control."""

from __future__ import annotations

from h100bench.tests import tiny


def cases() -> list:
    """(cell, (seed, seconds) of its tiny run, fault) for every cell of
    the benchmark and of h100bench/deferred/, and every fault of its
    kind."""
    return [(w["name"], tiny.run_args(w), f) for w in tiny.workloads()
            for f in tiny.kind_of(w).faults()]


def planted(cell: str, fault: str):
    """The context manager that plants `fault` for `cell`."""
    w = [w for w in tiny.workloads() if w["name"] == cell][0]
    return tiny.kind_of(w).faults()[fault]()
