"""Shared observability CLI knobs (the port of ``repro.launch.obs_cli``).

``serve.py --fedsim`` exposes the three flags through
``add_observability_args``::

    --trace-dir DIR      record host spans; Chrome trace.json lands in DIR
    --profile            also run torch.profiler (its trace in DIR/torch)
    --metrics-jsonl F    stream schema-versioned metric events to F

``make_observability`` builds the (tracer, sink) pair from parsed args;
``finish_observability`` exports the Chrome trace, stops the profiler and
drains/closes the sink — call it in a ``finally``.
"""
from __future__ import annotations

import os
from typing import Optional

from repro_torch.fed.telemetry import Tracer, make_tracer
from repro_torch.obs import JSONLMetricsSink


def add_observability_args(ap):
    g = ap.add_argument_group("observability")
    g.add_argument("--trace-dir", default=None,
                   help="record host spans; writes trace.json here "
                        "(load in chrome://tracing / ui.perfetto.dev)")
    g.add_argument("--profile", action="store_true",
                   help="also record a torch.profiler trace under "
                        "<trace-dir>/torch")
    g.add_argument("--metrics-jsonl", default=None,
                   help="stream schema-versioned metric events (JSONL) "
                        "to this file")
    return ap


def make_observability(args, *, run: Optional[str] = None):
    """(tracer, sink) from parsed args — NULL_TRACER / None when the flags
    are off, so call sites pass them through unconditionally."""
    trace_dir = getattr(args, "trace_dir", None)
    profile = bool(getattr(args, "profile", False))
    tracer = make_tracer(trace_dir, profile)
    if profile:
        tracer.start_profiler()
    metrics = getattr(args, "metrics_jsonl", None)
    sink = JSONLMetricsSink(metrics, run=run) if metrics else None
    return tracer, sink


def finish_observability(tracer: Tracer, sink, args) -> Optional[str]:
    """Export the Chrome trace (returns its path), stop the profiler,
    drain and close the sink.  Safe to call with observability off."""
    path = None
    tracer.stop_profiler()
    trace_dir = getattr(args, "trace_dir", None)
    if trace_dir and tracer.enabled:
        path = tracer.export_chrome(os.path.join(trace_dir, "trace.json"))
    if sink is not None:
        sink.close()
    return path
