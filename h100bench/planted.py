"""Breaks planted in the program's entry points that a window calls, for
the tests that see `correct` come out false.  Each kind's `faults()`
names its own, built from these: a context manager that swaps an entry
point for a broken one and puts it back on leaving."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def swap(*swaps):
    """swap((module, name, make), ...): module.name = make(module.name) for
    each, inside the block."""
    origs = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    for (mod, name, orig), (_, _, make) in zip(origs, swaps):
        setattr(mod, name, make(orig))
    try:
        yield
    finally:
        for mod, name, orig in origs:
            setattr(mod, name, orig)
