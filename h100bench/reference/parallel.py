"""Run reference calls over spawned worker processes (one a core, at most
eight), after the window, when the program is idle."""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor


def starmap(fn, args: list) -> list:
    """[fn(*a) for a in args], spread over the workers; every worker has
    ended when this returns, and a worker that dies raises."""
    if len(args) <= 1:
        return [fn(*a) for a in args]
    workers = max(1, min(8, len(os.sched_getaffinity(0)), len(args)))
    chunk = max(1, len(args) // (4 * workers))
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as ex:
        return list(ex.map(fn, *zip(*args), chunksize=chunk))
