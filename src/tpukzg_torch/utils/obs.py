"""Observability: structured logging, metric records, profiler scopes
(counterpart of ``tpukzg/utils/obs.py``).

* one `logging` logger per layer (``tpukzg.field``, ``tpukzg.msm``, ...)
* `metric_record(...)` — the JSON schema every bench emits
* `trace(name)` — `torch.profiler.record_function` plus wall-clock, so
  profiler traces show the pipeline's stages by name
"""

from __future__ import annotations

import contextlib
import json
import logging
import time


def get_logger(layer: str) -> logging.Logger:
    return logging.getLogger(f"tpukzg.{layer}")


def metric_record(*, config: dict, chips: int, hosts: int, wall_s: float,
                  verifications_per_s: float | None = None,
                  point_adds_per_s_chip: float | None = None,
                  scaling_eff: float | None = None,
                  sol_hbm: float | None = None,
                  sol_flop: float | None = None) -> dict:
    """The bench JSON schema (BASELINE.json:2); unset metrics are left
    out."""
    return {k: v for k, v in dict(
        config=config, chips=chips, hosts=hosts, wall_s=wall_s,
        verifications_per_s=verifications_per_s,
        point_adds_per_s_chip=point_adds_per_s_chip,
        scaling_eff=scaling_eff, pct_sol_hbm=sol_hbm, pct_sol_flop=sol_flop,
    ).items() if v is not None}


@contextlib.contextmanager
def trace(name: str, log: logging.Logger | None = None):
    """Profiler annotation + wall-clock timing for one pipeline stage."""
    import torch

    t0 = time.time()
    with torch.profiler.record_function(name):
        yield
    if log is not None:
        log.debug("%s: %.3fs", name, time.time() - t0)


def dump_jsonl(path: str, record: dict) -> None:
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
