"""Telemetry (the port of ``repro.fed.telemetry``): per-round health
metrics computed on the device, host span tracing with a profiler hook,
and the shared ``runtime_stats`` snapshot.

Health metrics (``round_telemetry``)
    Reductions over values a round already has: update norm, NaN fraction
    and clip rate over the (M, ...) client updates, the selected set's
    mean pairwise H-distance (the quantity Eq. 16 maximizes), availability
    rate, aggregation-weight entropy, the global params' step, and — where
    the batch has them — the memory panel's staleness histogram and the
    fault seam's corruption magnitude.  Every function takes any leading
    axes (the engine passes a leading cell axis) and stays on the tensors'
    device: nothing here reads a value back to the host.  They only READ
    the round's values, so a run with telemetry on computes exactly what a
    run with it off does.

``Tracer``
    Nested host spans around the runtime (plan, dispatch, fetch,
    checkpoint write), each also entering ``torch.profiler.
    record_function`` so a profiler trace carries the span names (only
    when the tracer is on).  Exports
    a Chrome/Perfetto ``trace.json``.  A span times the host: the card
    runs behind it, asynchronously, so device time comes from the profiler
    hook (``start_profiler`` / ``stop_profiler``, which write torch's own
    Chrome trace into ``profile_dir``).  Spans are on the profiler's clock:
    ``base_ns / 1e3 + ts`` is Unix-epoch microseconds, as torch's events'
    ``start_ns() / 1e3`` and its own export's ``baseTimeNanoseconds / 1e3
    + ts`` are, so the two traces lay over each other.

``runtime_snapshot``
    One counters snapshot shared by ``ScanEngine``, ``FLEngine`` and
    ``SimService``: the ``ProgramCache`` counters flat at the top level,
    the checkpoint writer's counters and the tracer's per-span aggregates.
"""
from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Optional

import torch

TELEMETRY_SCHEMA_VERSION = 1

# staleness-age bins (rounds since a client's last participation): ages
# land in [0, 1), [1, 2), [2, 4), ... [64, inf)
STALE_BIN_EDGES = (1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)
N_STALE_BINS = len(STALE_BIN_EDGES) + 1


# ------------------------------------------------------- health metrics
def _rows(x: torch.Tensor, lead: int) -> torch.Tensor:
    """``x`` with every axis past the first ``lead + 1`` flattened."""
    return x.reshape(*x.shape[:lead + 1], -1)


def _sq_norms_vs_base(stacked: dict, base: dict, lead: int) -> torch.Tensor:
    """(..., M) squared L2 norm of ``stacked_k − base`` per client, summed
    over the params (keys in the flat layout's order)."""
    out = None
    for k in sorted(stacked):
        d = stacked[k] - base[k].unsqueeze(lead)
        part = torch.sum(torch.square(_rows(d, lead)), dim=-1)
        out = part if out is None else out + part
    return out


def _nonfinite_fracs(stacked: dict, lead: int) -> torch.Tensor:
    """(..., M) fraction of non-finite entries per client over all
    params."""
    bad, total = None, 0
    for k in sorted(stacked):
        s = _rows(stacked[k], lead)
        part = torch.sum((~torch.isfinite(s)).to(torch.float32), dim=-1)
        bad = part if bad is None else bad + part
        total += s.shape[-1]
    return bad / float(max(total, 1))


def selection_dispersion(h: torch.Tensor, sel: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """Mean pairwise H-distance of the selected set, the per-round value of
    Eq. 16's dispersion term: ``h`` (..., N, N), ``sel`` / ``valid`` (...,
    M) padded indices and pad mask (pads count nothing); 0 with fewer than
    two clients selected."""
    m = sel.shape[-1]
    vf = valid.to(torch.float32)
    off = 1.0 - torch.eye(m, dtype=torch.float32, device=vf.device)
    pair = vf[..., :, None] * vf[..., None, :] * off
    rows = torch.take_along_dim(h, sel[..., :, None].to(torch.int64), dim=-2)
    hs = torch.take_along_dim(rows, sel[..., None, :].to(torch.int64), dim=-1)
    n_pairs = torch.sum(pair, dim=(-2, -1))
    return torch.where(n_pairs > 0, torch.sum(hs * pair, dim=(-2, -1))
                       / torch.clamp_min(n_pairs, 1.0),
                       torch.zeros_like(n_pairs))


def weight_entropy(weights: torch.Tensor) -> torch.Tensor:
    """Shannon entropy (nats) of the normalized aggregation weights over
    the last axis: a round that collapses onto one client reads 0."""
    w = torch.clamp_min(weights.to(torch.float32), 0.0)
    z = torch.sum(w, dim=-1, keepdim=True)
    p = w / torch.clamp_min(z, 1e-12)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p),
                                 torch.zeros_like(p)), dim=-1)
    return torch.where(z[..., 0] > 0, ent, torch.zeros_like(ent))


def staleness_histogram(age: torch.Tensor) -> torch.Tensor:
    """(..., N_STALE_BINS) counts of the per-client staleness ages (...,
    N) over the ``STALE_BIN_EDGES`` buckets."""
    edges = torch.tensor(STALE_BIN_EDGES, dtype=torch.float32,
                         device=age.device)
    idx = torch.searchsorted(edges, age.to(torch.float32).contiguous(),
                             right=True)
    bins = torch.arange(N_STALE_BINS, device=age.device)
    return torch.sum((idx[..., None] == bins).to(torch.float32), dim=-2)


def fault_corruption_norm(updf: torch.Tensor, cleanf: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Mean L2 distance between the corrupted and clean flat (..., M, P)
    update panels over the valid slots (0 for a benign cell)."""
    vf = valid.to(torch.float32)
    d = torch.sqrt(torch.clamp_min(
        torch.sum(torch.square(updf - cleanf), dim=-1), 0.0))
    return torch.sum(d * vf, dim=-1) / torch.clamp_min(
        torch.sum(vf, dim=-1), 1.0)


def round_telemetry(*, avail, valid, sel, local, params_prev, params_new,
                    weights, h, clip_thresh: float = 10.0, tau=None, t=None,
                    fault_mag=None) -> dict:
    """One round's metrics (schema v1), every value with the inputs'
    leading axes: ``avail`` (..., N) bool, ``sel`` / ``valid`` (..., M) the
    padded selected set, ``local`` the (..., M, ...) client params after
    the fault seam, ``params_prev`` / ``params_new`` the global params
    around the server update, ``weights`` (..., M) the Eq. 18 weights (pads
    zero), ``h`` (..., N, N) the normalized 3DG distances.  ``tau`` (...,
    N) with ``t`` adds the memory panel's staleness histogram;
    ``fault_mag`` (...) is the fault seam's magnitude, measured there."""
    lead = valid.dim() - 1
    vf = valid.to(torch.float32)
    n_sel = torch.sum(vf, dim=-1)
    one = torch.clamp_min(n_sel, 1.0)
    sq = _sq_norms_vs_base(local, params_prev, lead)
    norms = torch.sqrt(torch.clamp_min(sq, 0.0))
    nmask = torch.where(valid, norms, torch.zeros_like(norms))
    max_norm = torch.amax(torch.where(valid, norms, torch.full_like(
        norms, float("-inf"))), dim=-1)
    max_norm = torch.where(n_sel > 0, max_norm, torch.zeros_like(max_norm))
    clip = torch.sum((nmask > clip_thresh).to(torch.float32), dim=-1) / one
    nan = _nonfinite_fracs(local, lead)
    nan_frac = torch.sum(torch.where(valid, nan, torch.zeros_like(nan)),
                         dim=-1) / one
    delta_sq = None
    for k in sorted(params_new):
        d = _rows(params_new[k] - params_prev[k], lead - 1)
        part = torch.sum(torch.square(d), dim=-1)
        delta_sq = part if delta_sq is None else delta_sq + part
    # the mean as XLA computes it: the sum times the float32 reciprocal
    rate = torch.sum(avail.to(torch.float32), dim=-1) * (1.0 / avail.shape[-1])
    tel = {
        "avail_rate": rate,
        "n_selected": n_sel,
        "update_norm_mean": torch.sum(nmask, dim=-1) / one,
        "update_norm_max": max_norm,
        "update_clip_rate": clip,
        "update_nan_frac": nan_frac,
        "sampler_dispersion": selection_dispersion(h, sel, valid),
        "weight_entropy": weight_entropy(weights),
        "param_delta_norm": torch.sqrt(torch.clamp_min(delta_sq, 0.0)),
    }
    if tau is not None:
        age = torch.clamp_min(float(t) - tau, 0.0)
        tel["staleness_hist"] = staleness_histogram(age)
    if fault_mag is not None:
        tel["fault_corruption_norm"] = fault_mag
    return tel


# ------------------------------------------------------ host span tracer
class Tracer:
    """Nested span tracer with Chrome-trace export and a torch profiler
    hook.

    ``span(name)`` is a context manager: when the tracer is enabled it
    enters ``torch.profiler.record_function(name)`` and records a Chrome
    complete event with the host start (microseconds from ``base_ns``, the
    Unix-epoch nanoseconds at construction) and duration, thread id and
    nesting depth.  Thread-safe: the checkpoint writer's
    spans land on their own row.  ``profile_dir`` arms the profiler hook:
    ``start_profiler()`` / ``stop_profiler()`` bracket a run and the
    profiler's Chrome trace (host and, on the card, device activity) lands
    in that directory.  A disabled tracer (``NULL_TRACER``) records nothing
    and enters nothing (``span`` hands back one shared no-op context):
    unlike ``jax.named_scope``, a ``record_function`` range shows in every
    profile taken around it (on the card as a device range as long as the
    span), so it is left out when spans are off."""

    def __init__(self, *, enabled: bool = True,
                 profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.profile_dir = profile_dir
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._local = threading.local()
        # durations on perf_counter; starts from the same instant on the
        # Unix-epoch clock the profiler stamps its events with
        self._epoch = time.perf_counter()
        self.base_ns = time.time_ns()
        self._profiler = None
        self._off = nullcontext(self)

    # ------------------------------------------------------------ spans
    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def span(self, name: str, **attrs):
        """A context manager timing the block as the span ``name``."""
        if not self.enabled:
            return self._off
        return self._span(name, attrs)

    @contextmanager
    def _span(self, name: str, attrs: dict):
        with torch.profiler.record_function(name):
            self._local.depth = self._depth() + 1
            t0 = time.perf_counter()
            try:
                yield self
            finally:
                dur = time.perf_counter() - t0
                self._local.depth -= 1
                ev = {"name": name,
                      "ts": (t0 - self._epoch) * 1e6,       # us
                      "dur": dur * 1e6,
                      "tid": threading.get_ident(),
                      "depth": self._local.depth}
                if attrs:
                    ev["args"] = {k: (v if isinstance(v, (int, float, str,
                                                          bool, type(None)))
                                      else repr(v))
                                  for k, v in attrs.items()}
                with self._lock:
                    self._events.append(ev)

    # --------------------------------------------------------- profiler
    def start_profiler(self):
        """Start ``torch.profiler.profile`` (the CPU, and CUDA where there
        is a card); no-op without a ``profile_dir``."""
        if self.profile_dir and self._profiler is None:
            os.makedirs(self.profile_dir, exist_ok=True)
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._profiler = torch.profiler.profile(activities=acts)
            self._profiler.__enter__()

    def stop_profiler(self) -> Optional[str]:
        """Stop the profiler and write its Chrome trace into
        ``profile_dir``; returns the path (None when it was not running)."""
        if self._profiler is None:
            return None
        prof, self._profiler = self._profiler, None
        prof.__exit__(None, None, None)
        path = os.path.join(self.profile_dir, "torch_trace.json")
        prof.export_chrome_trace(path)
        return path

    # ----------------------------------------------------------- export
    def events(self) -> list[dict]:
        with self._lock:
            return list(self._events)

    def clear(self):
        with self._lock:
            self._events.clear()

    def summary(self) -> dict:
        """Per-span-name aggregates: count / total_ms / max_ms."""
        out: dict[str, dict] = {}
        for ev in self.events():
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            ms = ev["dur"] / 1e3
            s["count"] += 1
            s["total_ms"] += ms
            s["max_ms"] = max(s["max_ms"], ms)
        for s in out.values():
            s["total_ms"] = round(s["total_ms"], 3)
            s["max_ms"] = round(s["max_ms"], 3)
        return out

    def export_chrome(self, path: str) -> str:
        """Write the recorded spans as a Chrome/Perfetto ``trace.json``
        (complete "X" events, microsecond timestamps from
        ``baseTimeNanoseconds``, as torch's export); returns the path."""
        pid = os.getpid()
        evs = [{"name": ev["name"], "ph": "X", "pid": pid,
                "tid": ev["tid"], "ts": round(ev["ts"], 3),
                "dur": round(ev["dur"], 3),
                "args": ev.get("args", {"depth": ev["depth"]})}
               for ev in self.events()]
        doc = {"traceEvents": evs, "displayTimeUnit": "ms",
               "baseTimeNanoseconds": self.base_ns,
               "otherData": {"schema": TELEMETRY_SCHEMA_VERSION,
                             "tool": "repro_torch.fed.telemetry.Tracer"}}
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(doc, f)
        return path


NULL_TRACER = Tracer(enabled=False)


def make_tracer(trace_dir: Optional[str] = None,
                profile: bool = False) -> Tracer:
    """The CLI knobs' tracer: ``--trace-dir`` records spans (the Chrome
    export lands there), ``--profile`` also arms the torch profiler into
    ``<trace_dir>/torch``."""
    if not trace_dir and not profile:
        return NULL_TRACER
    pdir = os.path.join(trace_dir or ".", "torch") if profile else None
    return Tracer(enabled=True, profile_dir=pdir)


# ------------------------------------------------------ unified snapshot
def runtime_snapshot(*, programs=None, writer: Optional[dict] = None,
                     tracer: Optional[Tracer] = None,
                     extra: Optional[dict] = None) -> dict:
    """The one ``runtime_stats()`` shape of both engines and the service:
    the ``ProgramCache`` counters flat at the top level, the checkpoint
    writer's and the spans' sections beside them."""
    snap: dict = {"telemetry_schema": TELEMETRY_SCHEMA_VERSION}
    if programs is not None:
        snap.update(programs.stats())
    if writer is not None:
        snap["checkpoint_writer"] = dict(writer)
    if tracer is not None and tracer.enabled:
        snap["spans"] = tracer.summary()
    if extra:
        snap.update(extra)
    return snap
