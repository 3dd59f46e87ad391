"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Every ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, into an object; one link step makes ``libtpukzg_torch.so``.
The build lands in ``build/<hash of the sources>/`` at the repository
root at first use, so a fresh checkout needs nothing but ``nvcc``.  Nothing here runs at import time: the CPU
tests import every module on machines with no CUDA toolkit.
"""

from __future__ import annotations

import collections
import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

from tpukzg_torch.utils import checked

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = [ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per wrapper: each wrapper adds one where it launches
# its kernel, and nowhere else.
launches: collections.Counter = collections.Counter()

_lib = None
_lock = threading.Lock()
build_info: dict = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    cu = sorted(glob.glob(os.path.join(CSRC, "*.cu")))
    hdr = sorted(glob.glob(os.path.join(CSRC, "*.cuh")))
    return cu, hdr


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for f in files:
        h.update(os.path.basename(f).encode())
        with open(f, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile (if not built yet) and return the path of the library."""
    # the sources' CIOS products: 32-bit words, 64-bit accumulators
    checked.cios_bound_certificate(32, 64)
    cu, hdr = _sources()
    out_dir = os.path.join(REPO, "build", _digest(cu + hdr))
    lib_path = os.path.join(out_dir, "libtpukzg_torch.so")
    if os.path.exists(lib_path):
        with open(os.path.join(out_dir, "nvcc.log")) as fh:
            log = fh.read()
        build_info.update(path=lib_path, seconds=0.0, cached=True, log=log)
        return lib_path
    nvcc = _nvcc()
    tmp = f"{out_dir}.tmp{os.getpid()}"
    os.makedirs(tmp, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in cu:
        obj = os.path.join(tmp, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *FLAGS, "-c", src, "-o", obj]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, obj, p in procs:
        out, _ = p.communicate()
        logs.append(f"== {os.path.basename(src)}\n{out}")
        if p.returncode != 0:
            failed.append(src)
    log = "\n".join(logs)
    with open(os.path.join(tmp, "nvcc.log"), "w") as fh:
        fh.write(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n{log[-8000:]}")
    link = subprocess.run(
        [nvcc, ARCH, "-shared", "-o", os.path.join(tmp, "libtpukzg_torch.so"),
         *[obj for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"link failed:\n{link.stdout[-8000:]}")
    try:
        os.rename(tmp, out_dir)
    except OSError:            # another process finished the same build
        shutil.rmtree(tmp, ignore_errors=True)
    build_info.update(path=lib_path, seconds=time.perf_counter() - t0,
                      cached=False, log=log)
    return lib_path


def lib() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = ctypes.CDLL(build())
    return _lib


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_TYPES = {"p": _P, "i": _I, "l": _L}


def fn(name: str, sig: str):
    """C entry point `name` whose arguments follow `sig` (p = pointer or
    stream, i = int, l = 64-bit int); every entry point returns the
    cudaError_t of its launch."""
    f = getattr(lib(), name)
    f.argtypes = [_TYPES[c] for c in sig]
    f.restype = ctypes.c_int
    return f


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def aligned(t):
    """t, or a copy of it where its data does not start on 16 bytes (the
    kernels move elements as 16-byte loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
