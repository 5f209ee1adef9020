"""Streaming observability sinks.

``fed/telemetry.py`` produces the signals (per-round metrics, host
spans, runtime counters); this package STREAMS them out of the process:
a schema-versioned JSONL event log (``sinks.JSONLMetricsSink`` — one
background writer thread, the ``AsyncCheckpointWriter`` pattern)
and a Prometheus-style text exposition (``prom.render_prometheus``) for
the ``SimService`` front-end."""
from repro_torch.obs.prom import prom_families, render_prometheus
from repro_torch.obs.sinks import (
    METRICS_SCHEMA_VERSION, JSONLMetricsSink, read_metrics_jsonl,
)

__all__ = [
    "JSONLMetricsSink", "METRICS_SCHEMA_VERSION", "read_metrics_jsonl",
    "prom_families", "render_prometheus",
]
