"""Build and bind the CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface and loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  The target is ``sm_90a`` (Hopper).  The build goes
to ``build/repro_torch/`` at the root of the checkout, at first use; the
file name carries a hash of the sources and flags, so an edited source is
rebuilt and a stale library is never loaded.  :func:`build` starts one
``nvcc`` per source, all at once.

The flags leave out ``--use_fast_math`` on purpose: the 3DG edge weights
``exp(-Vn/σ²)`` reach the denormal range (σ² = 0.01), which flush-to-zero
would turn into zero-weight edges, and the epilogue needs IEEE ``/`` and
``expf``.  Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("graph_fused", "pairwise_similarity", "floyd_warshall", "solver",
           "aggregate", "krum", "window_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# the libraries built or loaded in this process, and the ms it took
_compiles = {"compiles": 0, "compile_ms": 0.0}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, verbose: bool = False) -> dict[str, dict]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together.  Returns, per source
    built, the compiler's messages (``log``; with ``verbose``, ``-Xptxas
    -v``'s register and shared-memory report) and the seconds from the start
    until its ``nvcc`` ended (``seconds``).  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists() and not verbose:
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = out.with_suffix(f".{os.getpid()}.log")
        cmd = [nvcc_path(), *NVCC_FLAGS, f"-I{CSRC}",
               *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with open(log, "w") as fh:
            proc = subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)
        procs[name] = (proc, tmp, out, log)
    done, failed = {}, []
    while len(done) < len(procs):
        for name, (proc, tmp, out, log) in procs.items():
            if name in done or proc.poll() is None:
                continue
            done[name] = {"seconds": time.perf_counter() - t0,
                          "log": log.read_text()}
            log.unlink()
            if proc.returncode != 0:
                failed.append(name)
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, out)
        time.sleep(0.05)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(done[n]["log"] for n in failed))
    return done


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _lock:
        if name not in _libs:
            t0 = time.perf_counter()
            path = _target(name)
            if not path.exists():
                build((name,))
            _libs[name] = ctypes.CDLL(str(path))
            _compiles["compiles"] += 1
            _compiles["compile_ms"] += (time.perf_counter() - t0) * 1e3
        return _libs[name]


def compile_stats() -> dict:
    """``compiles``: the kernel libraries this process built or loaded;
    ``compile_ms``: the milliseconds their builds and loads took."""
    with _lock:
        return dict(_compiles)


class Kernel:
    """One C entry point of a kernel library, with its launch count.

    Calling it runs the C function (which launches on the given stream and
    returns ``cudaGetLastError()``), raises on a nonzero code, and adds one
    to ``launches``.  The count is what a run reads to show that its path
    went through the kernel."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source, self.symbol, self.argtypes = source, symbol, argtypes
        self.launches = 0
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            raise RuntimeError(f"{self.symbol}: CUDA error {err}")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
L = ctypes.c_longlong
F = ctypes.c_float


def stream_of(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream
