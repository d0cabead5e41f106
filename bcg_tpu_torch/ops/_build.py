"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded through ``ctypes``
(no PyTorch headers, so a build takes seconds).  The libraries land in
``build/bcg_tpu_torch/`` at the repository root, named by a hash of
their sources and flags, so an edited kernel is rebuilt and an unchanged
one is reused.  :func:`build_all` starts one ``nvcc`` per source at once
and waits for all of them.

Nothing here runs at import time: the CPU test suite imports every module
of the package on machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List

from bcg_tpu_torch.obs import compile as obs_compile

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "build", "bcg_tpu_torch",
)
# One library per kernel source.
SOURCES = ("flash_prefill", "decode_attention", "guided_sampler",
           "chunk_decode_attention", "decode_attention_int8", "paged_attention",
           "w4a16")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def _lib_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [os.path.join(CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def build_all(names=SOURCES) -> List[str]:
    """Compile every missing library, one ``nvcc`` process per source,
    all started together.  Returns the compiler logs (``-Xptxas -v``
    register and shared-memory reports) of the sources it built; raises
    with the compiler's output if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name in names:
        out = _lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", CSRC, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    t_prev = t0
    for name, out, tmp, proc in procs:
        text, _ = proc.communicate()
        t_done = time.perf_counter()
        logs.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{text}")
            continue
        os.replace(tmp, out)
        # Each build as a first compile of its own entry.  The builds run
        # side by side, so each is charged the wall time since the one
        # before it finished: the charges add up to the batch's wall time.
        obs_compile.note_shape(f"nvcc_{name}", (name,), names=("library",),
                               seconds=t_done - t_prev)
        t_prev = t_done
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built on first use).  The build
    runs outside the lock: two first calls at once may both compile, each
    into its own temporary file, and the rename makes either result the
    library."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        loaded = ctypes.CDLL(_lib_path(name))
        with _lock:
            lib = _libs.setdefault(name, loaded)
    return lib


def entry(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of library ``name``, its argument
    types declared once (undeclared, ctypes would pass every Python int
    as a 32-bit int and cut the pointers).  Every entry point returns the
    launch's ``cudaError_t``."""
    lib = library(name)
    with _lock:
        fn = _entries.get(symbol)
        if fn is None:
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[symbol] = fn
        return fn


def check(err: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point
    (a launch the CUDA runtime refused never runs, and a later synchronise
    would not report it)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def stream_ptr(t) -> int:
    """The raw handle of the current CUDA stream on t's device, read as
    PyTorch's own generated kernel launchers read it (a fraction of the
    host time of building a ``torch.cuda.Stream``)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)
