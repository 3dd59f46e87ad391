"""Run one function on `world` processes joined in one process group
(the counterpart of ``bench/scaling.py``'s ``--processes`` worker).

    results = run(fn, world, backend="nccl")   # or "gloo" on the CPU

Each process is started with the ``spawn`` method (the parent may hold a
CUDA context, which a forked child cannot use), sets its card first when
the backend is NCCL (``cuda:<rank>``: one card a rank), joins the group
at a ``file://`` rendezvous, calls ``fn(rank, world, *args)`` and sends
back its result, which must pickle (CPU values, not CUDA tensors).  On
the CPU (gloo) each rank takes its share of the host's cores.  A
rank that raises, or gives no result within `timeout` seconds, fails the
run; every process is joined with a time limit and ended if it hangs.
"""

from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _worker(rank, world, backend, init_file, timeout, fn, args, out):
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        else:                   # ranks on the CPU share the host's cores
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        os.environ["LOCAL_RANK"] = str(rank)
        dist.init_process_group(
            backend, init_method=f"file://{init_file}", rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:                    # reported to the parent
        out.put((rank, False, traceback.format_exc()))
        raise


def run(fn, world: int, backend: str = "nccl", init_file: str | None = None,
        args=(), timeout: float = 120.0):
    """[fn(rank, world, *args) for each rank], each in its own process.
    fn must be importable by name (a module-level function).
    init_file: the rendezvous file, which must not exist yet (None: one
    in a new temporary directory).  Raises RuntimeError naming the ranks
    that failed or gave no result within `timeout` seconds."""
    tmp = None
    if init_file is None:
        tmp = tempfile.mkdtemp(prefix="tpukzg_dist_")
        init_file = os.path.join(tmp, "rendezvous")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    procs = [ctx.Process(target=_worker, args=(
        rank, world, backend, init_file, timeout, fn, tuple(args), out))
        for rank in range(world)]
    results, errors = {}, {}
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) + len(errors) < world:
            try:
                rank, ok, val = out.get(
                    timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            (results if ok else errors)[rank] = val
    finally:
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise RuntimeError("ranks failed: " + "; ".join(
            f"rank {r}:\n{tb}" for r, tb in sorted(errors.items())))
    missing = [r for r in range(world) if r not in results]
    if missing:
        raise RuntimeError(f"ranks {missing} gave no result within "
                           f"{timeout} s")
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise RuntimeError(f"ranks {bad} exited with codes "
                           f"{[procs[r].exitcode for r in bad]}")
    return [results[r] for r in range(world)]
