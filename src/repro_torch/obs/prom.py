"""Prometheus text exposition (zero-dependency, exposition format 0.0.4).

``render_prometheus`` turns a metric-families dict into the plain-text
format a Prometheus scraper (or a human) reads::

    # HELP fedgs_rounds_streamed_total Rounds streamed to clients.
    # TYPE fedgs_rounds_streamed_total counter
    fedgs_rounds_streamed_total 192

Families are plain data so the service can build them from its counters
without a client library::

    families = {
        "rounds_streamed_total": {
            "type": "counter", "help": "Rounds streamed.",
            "samples": [({}, 192)],
        },
        "request_queue_seconds": {
            "type": "gauge", "help": "submit->drain queue latency.",
            "samples": [({"request": "3"}, 0.012)],
        },
    }

``prom_families`` is the one-liner constructor for label-free gauges.
"""
from __future__ import annotations


def _escape(v: str) -> str:
    return str(v).replace("\\", r"\\").replace("\n", r"\n").replace(
        '"', r'\"')


def _fmt(value) -> str:
    v = float(value)
    if v != v:
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def prom_families(metrics: dict, *, type_: str = "gauge",
                  help_texts: dict | None = None) -> dict:
    """Build label-free single-sample families from ``{name: value}``."""
    help_texts = help_texts or {}
    return {name: {"type": type_,
                   "help": help_texts.get(name, name.replace("_", " ")),
                   "samples": [({}, value)]}
            for name, value in metrics.items()}


def render_prometheus(families: dict, *, prefix: str = "fedgs_") -> str:
    """Render metric families (see module docstring) as exposition text.
    Sample values must be numbers; labels render sorted for a stable,
    diff-able exposition."""
    lines: list[str] = []
    for name in sorted(families):
        fam = families[name]
        full = prefix + name
        lines.append(f"# HELP {full} {_escape(fam.get('help', name))}")
        lines.append(f"# TYPE {full} {fam.get('type', 'gauge')}")
        for labels, value in fam.get("samples", []):
            if labels:
                lab = ",".join(f'{k}="{_escape(v)}"'
                               for k, v in sorted(labels.items()))
                lines.append(f"{full}{{{lab}}} {_fmt(value)}")
            else:
                lines.append(f"{full} {_fmt(value)}")
    return "\n".join(lines) + "\n"
