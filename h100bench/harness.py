"""One run of one cell: set-up, the measured window, the traced readings,
the comparison with the reference, and the result line.

Everything is found by name from BENCHMARK.json at the checkout's root:
the cell's entry under "workloads" names its configuration
(configs/<config>.json) and its traffic (traffic/<traffic>.json, whose
"kind" names the code in kinds/<kind>.py); each metric that applies to
the cell is an end-to-end metric its kind reports, or a per-layer metric
read by metrics/<name>.py.  A metric applies to a cell that its
"workloads" list names, or, with no list, to every cell.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import os
import sys
import time

from h100bench import trace as trace_mod
from h100bench.record import Recorder

FORBIDDEN = ("jax", "jaxlib", "flax", "tpukzg")


def _load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_kind(base: str, kind: str):
    """kinds/<kind>.py under the benchmark's directory `base`."""
    return _load_module(os.path.join(base, "kinds", kind + ".py"),
                        f"h100bench_kind_{kind}")


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


class Cell:
    """A workload of BENCHMARK.json resolved to its files."""

    def __init__(self, root: str, name: str):
        bench_path = os.path.join(root, "BENCHMARK.json")
        with open(bench_path) as fh:
            self.bench = json.load(fh)
        self.bench_dir = self.bench["paths"][0]
        entry = [w for w in self.bench["workloads"] if w["name"] == name]
        if len(entry) != 1:
            raise KeyError(f"no workload {name!r} in {bench_path}")
        self.entry, self.name = entry[0], name
        base = os.path.join(root, self.bench_dir)
        with open(os.path.join(base, "configs",
                               self.entry["config"] + ".json")) as fh:
            self.config = json.load(fh)
        with open(os.path.join(base, "traffic",
                               self.entry["traffic"] + ".json")) as fh:
            self.traffic = json.load(fh)
        self.kind = load_kind(base, self.traffic["kind"])
        self.end_to_end = [m for m in self.bench["end_to_end"]
                           if _applies(m, name)]
        self.per_layer = [m for m in self.bench["per_layer"]
                          if _applies(m, name)]
        self.readers = {m["name"]: _load_module(
            os.path.join(base, "metrics", m["name"] + ".py"),
            "h100bench_metric_" + m["name"].replace(".", "_")).read
            for m in self.per_layer}


class Readings:
    """What a per-layer reader reads: the traced window [t0, t1], the
    device operations in it, the host spans inside it, the counters taken
    after the window and the least work of each span kind."""

    def __init__(self, tracer, spans, counters, work):
        self.t0, self.t1 = (tracer.t0, tracer.t1) if tracer else (None, None)
        self.events = tracer.events if tracer else []
        self.traced = bool(self.events)
        self.spans = [s for s in spans if self.traced
                      and s[1] >= self.t0 and s[2] <= self.t1]
        self.counters = counters
        self.work = work


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def run_cell(root: str, name: str, seed: int, seconds: float, traced: bool,
             device, t_process: float, log) -> dict:
    """One run -> the result line as a dict (with "checks" last)."""
    import torch
    cell = Cell(root, name)
    device = torch.device(device)
    log(f"cell {name}: config {cell.entry['config']}, traffic "
        f"{cell.entry['traffic']} (kind {cell.traffic['kind']}), seed "
        f"{seed}, {seconds} s, trace {int(traced)}, device {device}")
    kind = cell.kind.Kind(cell.config, cell.traffic, seed, device, root, log)
    kind.setup()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    tracer = None
    if traced:
        tracer = trace_mod.Tracer(torch, device, cell.traffic["trace_skip"],
                                  cell.traffic["trace_steps"]) \
            if device.type == "cuda" else None
    rec = Recorder(tracer)
    gc.collect()
    gc.freeze()
    t_window = time.perf_counter()
    setup_s = t_window - t_process
    log(f"set-up {setup_s:.3f} s; window of {seconds} s")
    try:
        kind.window(seconds, rec)
    finally:
        gc.unfreeze()
    log(f"window {kind.seconds:.3f} s, {kind.attempted} steps")
    device_info = _device_info(torch, device)
    counters = kind.counters() if traced else {}
    kind.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = kind.check()
    log(f"reference {time.perf_counter() - t_ref:.3f} s")
    metrics = {}
    if traced:
        readings = Readings(tracer, rec.spans, counters, kind.work())
        for m in cell.per_layer:
            v = cell.readers[m["name"]](readings)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if readings.traced:
            device_info["busy_s"] = trace_mod.busy_seconds(
                readings.events, readings.t0, readings.t1)
            device_info["window_s"] = readings.t1 - readings.t0
    else:
        values = dict(kind.end_to_end(), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    out = {"correct": all(v <= lim for _, v, lim in checks),
           "attempted": kind.attempted, "failed": kind.failed,
           "metrics": metrics, "device": device_info}
    if traced and tracer is not None and tracer.events:
        out["breakdown"] = {
            "device_ops": trace_mod.top_ops(tracer.events, tracer.t0,
                                            tracer.t1),
            "idle_gaps": trace_mod.idle_gaps(tracer.events, rec.spans,
                                             tracer.t0, tracer.t1)}
    out["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        return "card: " + out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "card: nvidia-smi gave nothing"
