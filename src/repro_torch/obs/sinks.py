"""JSONL metrics sink: schema-versioned, append-only, one writer thread.

Every event is one JSON line::

    {"schema": 1, "kind": "round", "wall_time": 1699.123, "run": "...",
     "seq": 17, ...payload...}

``kind`` partitions the stream — the engine emits ``run_start`` /
``round`` / ``segment`` / ``run_end`` events, the service adds
``request`` events — and ``schema`` versions the envelope so a consumer
can refuse a stream it does not understand (``read_metrics_jsonl``
round-trips and checks).

I/O happens on ONE background writer thread through the
``AsyncCheckpointWriter`` (bounded queue = backpressure instead of
unbounded host-memory growth; sticky errors re-raised on the caller
thread; strict submission order so ``seq`` is monotone in the file).
``emit`` itself only builds a small dict — JSON encoding AND the write
run on the writer thread, off the engine's dispatch loop.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.fed.runtime import AsyncCheckpointWriter

METRICS_SCHEMA_VERSION = 1


def _jsonable(obj):
    """numpy scalars, arrays and tensors -> plain JSON types (device values
    must already be on host — the engine emits from fetched segments)."""
    if isinstance(obj, (np.floating, np.integer, np.bool_)):
        return obj.item()
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if hasattr(obj, "tolist"):                  # a tensor already fetched
        return obj.tolist()
    raise TypeError(f"not JSON-serializable: {type(obj).__name__}")


def _definite(obj):
    """Recursively map non-finite floats to ``null`` — the stream must
    stay STANDARD JSON (python's default ``NaN`` token breaks every
    non-python consumer).  Only walked when a record actually carries a
    non-finite value; the common path never pays for it."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _definite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_definite(v) for v in obj]
    try:
        return _definite(_jsonable(obj))
    except TypeError:
        return obj


class JSONLMetricsSink:
    """Append metric events to ``path`` as JSON lines from a background
    writer thread.  Context-manager friendly; ``close()`` drains the
    queue and re-raises the first write error (never silent)."""

    def __init__(self, path: str, *, run: Optional[str] = None,
                 max_pending: int = 256):
        d = os.path.dirname(os.fspath(path))
        if d:
            os.makedirs(d, exist_ok=True)
        self.path = os.fspath(path)
        self.run = run
        self._seq = 0
        self._lock = threading.Lock()
        self._stats = {"events": 0, "bytes": 0}
        self._f = open(self.path, "a", encoding="utf-8")
        self._writer = AsyncCheckpointWriter(max_pending=max_pending)
        self._closed = False

    # ------------------------------------------------------------- emit
    def _write(self, rec: dict):
        try:
            line = json.dumps(rec, default=_jsonable,
                              separators=(",", ":"), allow_nan=False)
        except ValueError:          # a NaN/inf leaf: sanitize and retry
            line = json.dumps(_definite(rec), separators=(",", ":"),
                              allow_nan=False)
        self._f.write(line + "\n")
        self._stats["events"] += 1
        self._stats["bytes"] += len(line) + 1

    def emit(self, kind: str, payload: Optional[dict] = None, **fields):
        """Queue one event; returns its ``seq``.  ``payload``/``fields``
        must not use the envelope keys (schema/kind/seq/wall_time/run)."""
        if self._closed:
            raise RuntimeError("JSONLMetricsSink is closed")
        with self._lock:
            seq = self._seq
            self._seq += 1
        rec = {"schema": METRICS_SCHEMA_VERSION, "kind": kind, "seq": seq,
               "wall_time": round(time.time(), 6)}
        if self.run is not None:
            rec["run"] = self.run
        if payload:
            rec.update(payload)
        if fields:
            rec.update(fields)
        self._writer.submit(self._write, rec)
        return seq

    # ------------------------------------------------------------ admin
    def flush(self):
        self._writer.flush()
        self._f.flush()

    def close(self):
        if self._closed:
            return
        self._closed = True
        try:
            self._writer.close()
        finally:
            self._f.flush()
            self._f.close()

    def stats(self) -> dict:
        """events/bytes written plus the writer-thread backpressure
        counters (queue depth, high watermark, blocked ms)."""
        return {**self._stats, "writer": self._writer.stats()}

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close()
        return False


def read_metrics_jsonl(path: str, *, kind: Optional[str] = None,
                       strict: bool = True) -> list[dict]:
    """Load a JSONL metrics stream back; optionally filter by ``kind``.
    ``strict=True`` refuses events from an unknown schema version;
    ``strict=False`` silently SKIPS them (a tolerant reader never
    misinterprets an envelope it does not understand)."""
    out = []
    with open(path, encoding="utf-8") as f:
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            rec = json.loads(ln)
            if rec.get("schema") != METRICS_SCHEMA_VERSION:
                if strict:
                    raise ValueError(
                        f"unknown metrics schema {rec.get('schema')!r} "
                        f"(this reader understands "
                        f"{METRICS_SCHEMA_VERSION})")
                continue
            if kind is None or rec.get("kind") == kind:
                out.append(rec)
    return out
