"""The engines' runtime around the rounds (the port of
``repro.fed.runtime``): consume-once carries, host snapshots that overlap
the card, background checkpoint writes, and the bounded plan cache.
Shared by ``fed/scan_engine.py``, ``fed/engine.py`` and the service front
end (``launch/serve.py``).

``CarryHandle``
    The reference wraps a carry that ``jax.jit(donate_argnums=...)`` may
    free.  Torch's analogue of donation is the in-place update: a segment
    overwrites the memory panel (memagg) and the straggler's stale panel in
    the carry's own buffers.  A handle a segment consumed raises
    ``RuntimeError`` on any later read, so nobody reads a carry that a
    later round has overwritten.

``host_snapshot`` / ``HostSnapshot``
    A copy of a tree's tensors on the host, taken in stream order: each
    CUDA tensor is copied with ``non_blocking=True`` into a PINNED buffer
    (into pageable memory such a copy is synchronous) and one CUDA event
    is recorded after the copies.  Whatever the stream runs next, in place
    or not, runs after the copies, so the snapshot is the tree as it stood
    when it was taken, and the host waits for it (``wait``) only where it
    reads it.  A CPU tensor is cloned: ``.cpu()`` of a CPU tensor is the
    tensor itself, which the next round would overwrite.

``AsyncCheckpointWriter``
    One background thread, a bounded queue, strict submission order: the
    npz serialization and the disk write overlap the next segment.
    ``close()`` drains the queue and re-raises the first worker error.

``ProgramCache``
    A bounded LRU with the reference's counters (``hits``, ``misses``,
    ``evictions``, ``compiles``, ``compile_ms``, ``size``).  The port has
    no traced programs: the engine caches its per-batch round plans here
    (``ScanEngine._plan``), and ``compiles`` / ``compile_ms`` count the
    kernel libraries that ``kernels/_build.py`` built or loaded in this
    process and the milliseconds that took.

The reference's ``enable_compile_cache`` (jax's persistent compilation
cache) has no torch counterpart to wire: the kernel libraries already
persist under ``build/repro_torch/``, keyed by a hash of their sources and
flags.  So ``compile_cache_dir`` keeps its default and raises away from it.
"""
from __future__ import annotations

import queue
import threading
import time
from collections import OrderedDict
from typing import Callable, Optional

import torch

from repro_torch.kernels import _build


# ----------------------------------------------------------- plan LRU
class ProgramCache:
    """Bounded LRU of built plans keyed on their static inputs, with
    hit / miss / eviction counters and the process's kernel builds."""

    def __init__(self, maxsize: int = 32):
        if maxsize < 1:
            raise ValueError(f"ProgramCache needs maxsize >= 1, "
                             f"got {maxsize}")
        self.maxsize = int(maxsize)
        self._programs: OrderedDict = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}

    def __len__(self) -> int:
        return len(self._programs)

    def __contains__(self, key) -> bool:
        return key in self._programs

    def get(self, key, build: Callable[[], object]):
        """The entry for ``key``, building it (and evicting the least
        recently used entry past ``maxsize``) on a miss."""
        if key in self._programs:
            self._stats["hits"] += 1
            self._programs.move_to_end(key)
            return self._programs[key]
        self._stats["misses"] += 1
        prog = build()
        self._programs[key] = prog
        while len(self._programs) > self.maxsize:
            self._programs.popitem(last=False)
            self._stats["evictions"] += 1
        return prog

    def stats(self) -> dict:
        """hits, misses, evictions, compiles and compile_ms (the kernel
        libraries built or loaded in this process), size."""
        return {**self._stats, **_build.compile_stats(),
                "size": len(self._programs)}


# ------------------------------------------------------ consumed carries
class CarryHandle:
    """Ownership token for a carry tree that a segment updates in place.

    ``tree`` reads without consuming (host snapshots for checkpoints);
    ``consume()`` surrenders the tree to a segment and invalidates the
    handle.  Any later access raises at once."""

    __slots__ = ("_tree", "_alive", "_label")

    def __init__(self, tree, label: str = "scan carry"):
        self._tree = tree
        self._alive = True
        self._label = label

    @property
    def alive(self) -> bool:
        return self._alive

    @property
    def tree(self):
        if not self._alive:
            raise RuntimeError(
                f"use-after-consume: this {self._label} handle was consumed "
                f"by a segment, which updates the carry's buffers in place. "
                f"Use the handle RETURNED by run_segment / the stream, not "
                f"the one you passed in.")
        return self._tree

    def consume(self):
        """Surrender the carry to a segment: returns the tree and
        invalidates the handle."""
        tree = self.tree
        self._alive = False
        self._tree = None
        return tree


def clone_tree(tree):
    """A copy of ``tree`` with every tensor cloned on its device."""
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_tree(v) for v in tree)
    return tree


# ---------------------------------------------------------- host copies
class HostSnapshot:
    """A tree's tensors copied to the host in stream order (see the module
    docstring).  ``wait()`` returns the host tree once the copies landed;
    any thread may call it."""

    __slots__ = ("_tree", "_event")

    def __init__(self, tree, event: Optional[torch.cuda.Event]):
        self._tree, self._event = tree, event

    def wait(self):
        if self._event is not None:
            self._event.synchronize()
        return self._tree


def host_snapshot(tree) -> HostSnapshot:
    """Start copying every tensor of ``tree`` to the host: CUDA tensors
    into pinned buffers without blocking (one event after the copies), CPU
    tensors by a clone.  Other leaves are kept as they are."""
    cuda = []

    def copy(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                dst = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                dst.copy_(x, non_blocking=True)
                cuda.append(x.device)
                return dst
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    out = copy(tree)
    event = None
    if cuda:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cuda[0]))
    return HostSnapshot(out, event)


# -------------------------------------------------- async checkpoint I/O
class AsyncCheckpointWriter:
    """Single worker thread executing submitted thunks in order, so npz
    serialization and disk writes overlap the card's work.  The queue is
    bounded (a sweep that outruns the disk blocks on submit instead of
    piling trajectories up in host memory).  Errors are sticky: the first
    worker exception is re-raised on the next ``submit``/``flush``/
    ``close``."""

    def __init__(self, max_pending: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        # backpressure: the queue's high-watermark, the time submit() spent
        # blocked on a full queue, and the worker's write time
        self._stats = {"submitted": 0, "completed": 0, "max_pending":
                       int(max_pending), "queue_high_watermark": 0,
                       "blocked_ms": 0.0, "write_ms": 0.0}
        self._thread = threading.Thread(
            target=self._loop, name="ckpt-writer", daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                if self._err is None:     # fail fast: skip after an error
                    fn, args, kwargs = item
                    t0 = time.perf_counter()
                    fn(*args, **kwargs)
                    self._stats["write_ms"] += \
                        (time.perf_counter() - t0) * 1e3
                    self._stats["completed"] += 1
            except BaseException as e:    # noqa: BLE001 — re-raised on host
                self._err = e
            finally:
                self._q.task_done()

    def _raise_pending(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, fn: Callable, *args, **kwargs):
        self._raise_pending()
        item = (fn, args, kwargs)
        try:
            self._q.put_nowait(item)
        except queue.Full:
            t0 = time.perf_counter()
            self._q.put(item)
            self._stats["blocked_ms"] += (time.perf_counter() - t0) * 1e3
        self._stats["submitted"] += 1
        self._stats["queue_high_watermark"] = max(
            self._stats["queue_high_watermark"], self._q.qsize())

    def stats(self) -> dict:
        """Counters snapshot and the instantaneous queue depth."""
        return {**self._stats, "queue_depth": self._q.qsize(),
                "blocked_ms": round(self._stats["blocked_ms"], 3),
                "write_ms": round(self._stats["write_ms"], 3)}

    def flush(self):
        """Block until everything submitted so far has been written."""
        self._q.join()
        self._raise_pending()

    def close(self):
        """Drain, stop the worker, and surface any write error."""
        self._q.join()
        self._q.put(None)
        self._thread.join()
        self._raise_pending()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        # drain on a clean exit; on an error, still stop the thread but
        # prefer the caller's exception over a writer error
        try:
            self.close()
        except RuntimeError:
            if exc_type is None:
                raise
        return False
