#!/usr/bin/env python3
"""The benchmark of tpukzg_torch on NVIDIA GPUs.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs one cell of BENCHMARK.json (the checkout's root) on the card and
prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics with --trace
0, its per-layer metrics with --trace 1), device, with --trace 1 the
breakdown, and last the checks (each number compared with its limit),
which also end standard error.  It exits non-zero with no result when
no CUDA card is present (or fewer than the cell asks for), when the
program cannot be imported, or when JAX or the JAX package was loaded.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(f"[h100bench {time.perf_counter() - T_PROCESS:8.3f}s]", *a,
          file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from h100bench import harness
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        chips = {w["name"]: w["chips"] for w in json.load(fh)["workloads"]}
    if args.workload not in chips:
        log(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < chips[args.workload]:
        log(f"needs {chips[args.workload]} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    out = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_PROCESS, log)
    bad = harness.forbidden_modules()
    if bad:
        log(f"loaded after the window: {bad}; no result")
        return 3
    log(harness.card_line())
    for name, c in out["checks"].items():
        log(f"check {name} = {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
