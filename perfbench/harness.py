"""The benchmark's general part: finds a cell's files by name, checks the
machine, loads the cell's driver and metric readers, reads the profiler's
trace, and prints the result line.

A cell is an entry of ``BENCHMARK.json``'s ``workloads``: it names a
configuration (``configs/<config>.json``) and a traffic mix
(``traffic/<traffic>.json``, whose ``driver`` key names
``drivers/<driver>.py``).  Each per-layer metric is read by
``metrics/<metric name>.py`` (``read(ctx) -> float | None``).  The limits
that decide ``correct`` are ``limits/<cell>.json``.  Nothing here knows a
cell, a mix or a metric by name, so a later change adds one by adding files.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent          # perfbench/
ROOT = BENCH.parent                              # the checkout
SRC = ROOT / "src"
PROGRAM = "repro_torch"
# top-level module names that may never be loaded in a run (compared whole:
# the program's own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_MOST = 100       # characters of an operation's name in the breakdown


class BenchError(RuntimeError):
    """A run that cannot give a result: exits non-zero, prints none."""


# ------------------------------------------------------------------ files
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None) -> dict:
    """The cell's entry, its configuration, traffic, limits and metrics."""
    bench = benchmark() if bench is None else bench
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")

    def mine(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in bench["end_to_end"] if mine(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if mine(m) and m["moves"] in moved]
    traffic = load_json(BENCH / "traffic" / f"{entry['traffic']}.json")
    return {"entry": entry,
            "config": load_json(BENCH / "configs" / f"{entry['config']}.json"),
            "traffic": traffic,
            "limits": load_json(BENCH / "limits" / f"{name}.json"),
            "end_to_end": e2e, "per_layer": layer}


def load_module(path: Path, name: str):
    """A module from a file whose name need not be an identifier."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return load_module(BENCH / "drivers" / f"{name}.py", f"_pb_driver_{name}")


def reader(metric: str):
    path = BENCH / "metrics" / f"{metric}.py"
    if not path.exists():
        raise BenchError(f"no reader metrics/{metric}.py")
    return load_module(path, "_pb_metric_" + metric.replace(".", "_")
                       .replace("-", "_"))


# ---------------------------------------------------------------- machine
def prepare_environment() -> None:
    """Before torch is imported: few threads, caches inside the checkout
    at fixed paths, the program on the path."""
    if not (SRC / PROGRAM / "__init__.py").exists():
        raise BenchError(f"the program ({SRC / PROGRAM}) is not in this "
                         f"checkout")
    os.environ["OMP_NUM_THREADS"] = "2"
    os.environ["MKL_NUM_THREADS"] = "2"
    os.environ["USE_FLAX"] = "0"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" /
                                             "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    for p in (str(SRC), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def require_chips(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: the benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, the "
                         f"machine has {torch.cuda.device_count()}")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def device_info(torch, device, chips: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


# ------------------------------------------------------------------ trace
def parse_profile(prof) -> dict:
    """The profiler's events as plain intervals (microseconds, one clock):
    ``device`` [(name, start, end)] for kernels, copies and sets (user
    annotations mirrored onto the device are left out), ``host``
    [(name, start, end)] for the host's ops and spans."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        end = start + e.duration_ns() / 1e3
        if str(e.device_type()).endswith("CUDA"):
            if e.is_user_annotation():
                continue
            dev.append((e.name(), start, end))
        else:
            host.append((e.name(), start, end))
    dev.sort(key=lambda x: x[1])
    host.sort(key=lambda x: x[1])
    return {"device": dev, "host": host}


def union_seconds(intervals, t0: float, t1: float) -> float:
    """Seconds of [t0, t1] (us) covered by the union of the intervals."""
    busy, cur_s, cur_e = 0.0, None, None
    for _, s, e in intervals:
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy / 1e6


def breakdown(trace: dict, t0: float, t1: float, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps named by the innermost host event open when each gap began."""
    by = {}
    for name, s, e in trace["device"]:
        by[name] = by.get(name, 0.0) + (e - s) / 1e6
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    gaps, last = [], t0
    for _, s, e in trace["device"]:
        if s > last:
            gaps.append((last, s))
        last = max(last, e)
    if t1 > last:
        gaps.append((last, t1))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    host = trace["host"]
    named = []
    for gs, ge in gaps:
        inner = None
        for name, s, e in host:
            if s > gs:
                break
            if e >= gs and (inner is None or s >= inner[1]):
                inner = (name, s)
        named.append([inner[0] if inner else "(no host event)",
                      (ge - gs) / 1e6])
    return {"device_ops": [[k[:NAME_MOST], v] for k, v in ops],
            "idle_gaps": [[k[:NAME_MOST], v] for k, v in named]}


# ----------------------------------------------------------------- result
def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: dict, device: dict, checks: list,
                extra: dict | None = None) -> dict:
    """The last stdout line; ``checks`` [(name, value, limit)] go last."""
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if extra:
        line.update(extra)
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line


def judge(checks: list) -> bool:
    """Every compared number within its limit (a missing number fails)."""
    return all(v is not None and v == v and v <= lim for _, v, lim in checks)
