"""The port's telemetry (``repro_torch.fed.telemetry``) and metrics sinks
(``repro_torch.obs``) against ``repro.fed.telemetry`` and ``repro.obs`` on
the CPU, at the reference's ``ds16`` scale.

Contracts:
* each health metric is the reference's on the same inputs (counts exact,
  floats within rtol 1e-5), and over a leading cell axis each row is the
  single-cell value; every metric is float32;
* telemetry on is bitwise telemetry off: every history field and every
  checkpoint byte, with a fault cell and a memory cell in the batch;
  rounds before a resume point read NaN;
* with the reference's draws in the seams, a FedGS cell, a memory cell and
  a Krum cell under sign-flip give the reference's per-cell telemetry:
  counts (``avail_rate``, ``n_selected``, ``staleness_hist``) exact, the
  float metrics within rtol 1e-4 (the bound val_loss is held to);
* the engine's sink feed (run_start / round / segment / run_end) and the
  tracer's spans; ``FLEngine``'s and ``SimService``'s snapshots and
  Prometheus text;
* the ``obs`` copies write what ``repro.obs`` writes for the same events
  (the wall clock aside), render the same Prometheus text, and each reads
  the other's stream.
"""
import json
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.fed import scan_engine as jse
from repro.fed import telemetry as jtel
from repro.fed.aggregator_device import \
    make_aggregator_process as jax_make_aggregator
from repro.fed.faults_device import make_fault_process as jax_make_fault
from repro.fed.models import logistic_regression as jax_logreg
import repro.obs as jobs

from repro_torch.core.availability import make_mode
from repro_torch.core.availability_device import make_process
from repro_torch.fed import scan_engine as tse
from repro_torch.fed import telemetry as ttel
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.faults_device import make_fault_process
from repro_torch.fed.models import logistic_regression
import repro_torch.obs as tobs

from test_torch_checkpoint import seams

HIST_FIELDS = ("sel", "valid", "counts", "gini", "count_var", "val_loss",
               "val_acc")
COUNTS = ("avail_rate", "n_selected", "staleness_hist")
COMBOS = [("memory", "GE"), ("fedavgm", "CLUSTER"), ("fedadam", "DRIFT")]
ROUNDS, M, E, B = 6, 4, 2, 8


@pytest.fixture(scope="module")
def ds16():
    from repro.data.synthetic import make_synthetic
    return make_synthetic(n_clients=16, alpha=0.5, beta=0.5, seed=0)


@pytest.fixture(scope="module")
def h16(ds16):
    return np.asarray(jse.oracle_h(ds16.opt_params))


def _proc(name, ds, rounds, seed=7):
    return make_process(name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                        label_sets=ds.label_sets(),
                        num_labels=ds.num_classes, rounds=rounds, seed=seed)


def _cfg(mod, rounds=ROUNDS, **kw):
    return mod.ScanConfig(rounds=rounds, m=M, local_steps=E, batch_size=B,
                          lr=0.1, eval_every=1, **kw)


def _engine(ds, rounds=ROUNDS, **kw):
    return tse.ScanEngine(ds, logistic_regression(),
                          _cfg(tse, rounds, sampler="uniform", **kw),
                          device="cpu")


def _cells(eng, ds, h, agg, scenario, rounds=ROUNDS, fault_cell=None):
    return [eng.cell(
        seed=s, process=_proc(scenario, ds, rounds, 3 + s), avail_seed=70 + s,
        h=h, aggregator_process=make_aggregator_process(agg),
        fault_process=(make_fault_process("sign_flip", ds.n_clients,
                                          frac=0.25)
                       if s == fault_cell else None))
        for s in range(2)]


# ------------------------------------------------------- metric reductions
def _inputs(seed, n=12, m=5, shapes=((3, 4), (4,))):
    rng = np.random.default_rng(seed)
    sel = np.sort(rng.choice(n, m, replace=False))
    valid = np.arange(m) < rng.integers(0, m + 1)
    local = {k: rng.normal(size=(m,) + s).astype(np.float32)
             for k, s in zip("wb", shapes)}
    local["w"][0, 0] = np.nan if seed % 2 else local["w"][0, 0]
    prev = {k: rng.normal(size=s).astype(np.float32)
            for k, s in zip("wb", shapes)}
    new = {k: v + rng.normal(size=v.shape).astype(np.float32) * 0.1
           for k, v in prev.items()}
    w = (rng.uniform(size=m) * valid).astype(np.float32)
    return {"avail": rng.uniform(size=n) < 0.6, "valid": valid, "sel": sel,
            "local": local, "params_prev": prev, "params_new": new,
            "weights": w, "h": rng.uniform(size=(n, n)).astype(np.float32),
            "clip_thresh": 3.0,
            "tau": rng.integers(0, 90, n).astype(np.float32), "t": 95,
            "fault_mag": np.asarray(rng.uniform(), np.float32)}


def _to(x, fn):
    if isinstance(x, dict):
        return {k: _to(v, fn) for k, v in x.items()}
    return fn(x) if isinstance(x, np.ndarray) else x


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float32, what
    if what in COUNTS:
        assert np.array_equal(got, want), what
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                   err_msg=what)


@pytest.mark.parametrize("seed", range(4))
def test_round_telemetry_vs_reference_and_cell_axis(seed):
    ins = [_inputs(seed * 10 + i) for i in range(3)]
    for x in ins:
        want = jtel.round_telemetry(**_to(x, jnp.asarray))
        got = ttel.round_telemetry(**_to(x, torch.as_tensor))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], k)
    # a leading cell axis: each row is the single-cell value
    stacked = {k: (np.stack([x[k] for x in ins]) if isinstance(
        ins[0][k], np.ndarray) else ins[0][k]) for k in ins[0]}
    stacked["local"] = {k: np.stack([x["local"][k] for x in ins])
                        for k in ins[0]["local"]}
    for key in ("params_prev", "params_new"):
        stacked[key] = {k: np.stack([x[key][k] for x in ins])
                        for k in ins[0][key]}
    stacked["fault_mag"] = np.stack([x["fault_mag"] for x in ins])
    rows = ttel.round_telemetry(**_to(stacked, torch.as_tensor))
    for i, x in enumerate(ins):
        one = ttel.round_telemetry(**_to(x, torch.as_tensor))
        for k in one:
            np.testing.assert_allclose(rows[k][i].numpy(), one[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)


def test_metric_helpers_vs_reference():
    rng = np.random.default_rng(3)
    h = rng.uniform(size=(6, 6)).astype(np.float32)
    for sel, valid in (([0, 2, 5, 0], [1, 1, 1, 0]), ([1, 0, 0, 0],
                                                     [1, 0, 0, 0])):
        want = jtel.selection_dispersion(jnp.asarray(h), jnp.asarray(sel),
                                         jnp.asarray(valid, jnp.float32))
        got = ttel.selection_dispersion(torch.as_tensor(h),
                                        torch.as_tensor(sel),
                                        torch.as_tensor(valid, dtype=bool))
        assert float(got) == pytest.approx(float(want), rel=1e-6)
    for w in ([1.0] * 5, [1.0, 0, 0], [0.0, 0.0], [3.0, 1.0, 0.5]):
        assert float(ttel.weight_entropy(torch.tensor(w))) == pytest.approx(
            float(jtel.weight_entropy(jnp.asarray(w))), rel=1e-6, abs=1e-7)
    age = np.array([0.0, 1.0, 3.0, 100.0, 63.9, 64.0, 0.5], np.float32)
    assert np.array_equal(ttel.staleness_histogram(torch.as_tensor(age)),
                          np.asarray(jtel.staleness_histogram(
                              jnp.asarray(age))))
    f = rng.normal(size=(3, 7)).astype(np.float32)
    for valid in ([1, 1, 1], [1, 0, 1], [0, 0, 0]):
        assert float(ttel.fault_corruption_norm(
            torch.as_tensor(-f), torch.as_tensor(f), torch.tensor(valid))) \
            == pytest.approx(float(jtel.fault_corruption_norm(
                jnp.asarray(-f), jnp.asarray(f), jnp.asarray(valid))),
                rel=1e-6)
    assert ttel.STALE_BIN_EDGES == jtel.STALE_BIN_EDGES
    assert ttel.TELEMETRY_SCHEMA_VERSION == jtel.TELEMETRY_SCHEMA_VERSION


# ------------------------------------------------ bitwise noninterference
@pytest.mark.parametrize("agg,scenario", COMBOS)
def test_telemetry_bitwise_noninterference(ds16, h16, tmp_path, agg,
                                           scenario):
    out = {}
    for name, tel in (("off", False), ("on", True)):
        eng = _engine(ds16, telemetry=tel)
        out[name] = eng.run_batch(_cells(eng, ds16, h16, agg, scenario,
                                         fault_cell=1),
                                  ckpt_path=str(tmp_path / name),
                                  ckpt_every=3)
    for i in range(2):
        for f in HIST_FIELDS:
            assert np.array_equal(getattr(out["on"][i], f),
                                  getattr(out["off"][i], f)), f"{i}: {f}"
    assert (tmp_path / "off.npz").read_bytes() == \
        (tmp_path / "on.npz").read_bytes(), "checkpoint bytes differ"
    assert out["off"][0].telemetry is None
    tel = out["on"][1].telemetry
    assert tel["avail_rate"].shape == (ROUNDS,)
    assert ("staleness_hist" in tel) == (agg == "memory")
    assert np.all(out["on"][0].telemetry["fault_corruption_norm"] == 0.0)
    assert tel["fault_corruption_norm"].max() > 0.0


def test_telemetry_content_sane(ds16, h16):
    eng = _engine(ds16, telemetry=True)
    hists = eng.run_batch(_cells(eng, ds16, h16, "memory", "GE",
                                 fault_cell=1))
    tel = hists[0].telemetry
    assert tel["staleness_hist"].shape == (ROUNDS, ttel.N_STALE_BINS)
    assert np.allclose(tel["staleness_hist"].sum(axis=1), ds16.n_clients)
    assert np.all((tel["avail_rate"] >= 0) & (tel["avail_rate"] <= 1))
    assert np.all(tel["n_selected"] == hists[0].valid.sum(1))
    assert np.all(tel["sampler_dispersion"] > 0)
    assert np.all(tel["update_nan_frac"] == 0.0)
    assert all(v.dtype == np.float32 for v in tel.values())


def test_telemetry_resume_prefix_nan(ds16, h16, tmp_path):
    ck = str(tmp_path / "ck")
    eng = _engine(ds16, telemetry=True)
    full = eng.run_batch(_cells(eng, ds16, h16, "memory", "GE"),
                         ckpt_path=ck, ckpt_every=3)
    # the checkpoint holds round 3 (the last one before the final segment)
    res_eng = _engine(ds16, telemetry=True)
    res = res_eng.run_batch(_cells(res_eng, ds16, h16, "memory", "GE"),
                            ckpt_path=ck, ckpt_every=3, resume=True)
    for i in range(2):
        for f in HIST_FIELDS:
            assert np.array_equal(getattr(res[i], f), getattr(full[i], f))
        tel, want = res[i].telemetry, full[i].telemetry
        assert np.all(np.isnan(tel["avail_rate"][:3]))
        assert np.all(np.isnan(tel["staleness_hist"][:3]))
        for k in want:
            assert np.array_equal(tel[k][3:], want[k][3:]), k


# ---------------------------------------------- against the reference run
def _jax_masks(ds):
    from repro.core.availability import make_mode as jax_make_mode
    return jse.precompute_masks(jax_make_mode(
        "LN", n_clients=ds.n_clients, beta=0.5, seed=99), ROUNDS, 11)


REF_CELLS = {
    "fedgs": (lambda m: m("fedavg"), None),
    "memory": (lambda m: m("memory", gamma=0.9), None),
    "krum_sign_flip": (lambda m: m("multikrum", krum_f=1, krum_multi=2),
                       {"frac": 0.25, "scale": 5.0})}


@pytest.fixture(scope="module")
def ref_telemetry(ds16, h16):
    masks = _jax_masks(ds16)
    out = {}
    for k, (name, (agg, attack)) in enumerate(REF_CELLS.items()):
        seed = 40 + k
        jeng = jse.ScanEngine(ds16, jax_logreg(),
                              _cfg(jse, max_sweeps=8, telemetry=True),
                              use_masks=True)
        jfault = jax_make_fault("sign_flip", ds16.n_clients, **attack) \
            if attack else None
        want = jeng.run(jeng.cell(seed=seed, masks=masks, h=h16,
                                  aggregator_process=agg(jax_make_aggregator),
                                  fault_process=jfault))
        teng = tse.ScanEngine(ds16, logistic_regression(),
                              _cfg(tse, max_sweeps=8, telemetry=True),
                              use_masks=True, device="cpu")
        tfault = make_fault_process("sign_flip", ds16.n_clients, **attack) \
            if attack else None
        got = teng.run(teng.cell(seed=seed, masks=masks, h=h16,
                                 aggregator_process=agg(
                                     make_aggregator_process),
                                 fault_process=tfault, **seams(seed)))
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", list(REF_CELLS))
def test_telemetry_vs_reference_per_cell(ref_telemetry, name):
    want, got = ref_telemetry[name]
    assert np.array_equal(got.sel, np.asarray(want.sel))
    assert np.array_equal(got.counts, np.asarray(want.counts))
    assert set(got.telemetry) == set(want.telemetry)
    for k, w in want.telemetry.items():
        g, w = got.telemetry[k], np.asarray(w)
        assert g.shape == w.shape and g.dtype == np.float32, k
        if k in COUNTS:
            assert np.array_equal(g, w), k
        else:
            np.testing.assert_allclose(g, w, rtol=1e-4, err_msg=k)
    keys = set(got.telemetry)
    assert ("staleness_hist" in keys) == (name == "memory")
    assert ("fault_corruption_norm" in keys) == (name == "krum_sign_flip")
    if name == "fedgs":
        assert np.all(got.telemetry["sampler_dispersion"] > 0)


# ------------------------------------------------------- sinks and spans
def test_engine_streams_round_events_and_spans(ds16, h16, tmp_path):
    path = str(tmp_path / "m.jsonl")
    eng = _engine(ds16, rounds=4, telemetry=True)
    eng.tracer = ttel.Tracer()
    with tobs.JSONLMetricsSink(path, run="test") as sink:
        eng.attach_sink(sink)
        eng.run_batch(_cells(eng, ds16, h16, "memory", "GE", rounds=4),
                      ckpt_path=str(tmp_path / "ck"), ckpt_every=2)
    evs = tobs.read_metrics_jsonl(path)
    kinds = [e["kind"] for e in evs]
    assert kinds[0] == "run_start" and kinds[-1] == "run_end"
    assert kinds.count("segment") == 2
    rounds = tobs.read_metrics_jsonl(path, kind="round")
    assert len(rounds) == 2 * 4
    assert {"cell", "t", "metrics", "run", "seq", "wall_time", "n_valid",
            "val_loss"} <= set(rounds[0])
    assert len(rounds[0]["metrics"]["staleness_hist"]) == ttel.N_STALE_BINS
    # the reference's reader takes the port's stream
    assert len(jobs.read_metrics_jsonl(path, kind="round")) == 8
    names = set(eng.tracer.summary())
    assert {"init_carry", "program_get", "dispatch_segment", "device_get",
            "metrics_emit", "checkpoint_write"} <= names
    end = evs[-1]["runtime"]
    assert end["checkpoint_writer"]["completed"] == 1
    eng.attach_sink(None)
    assert eng.sink is None


class TestTracer:
    def test_nested_spans_and_summary(self):
        tr = ttel.Tracer()
        with tr.span("outer", tag="x", obj=object()):
            with tr.span("inner"):
                pass
            with tr.span("inner"):
                pass
        evs = tr.events()
        assert [e["name"] for e in evs] == ["inner", "inner", "outer"]
        assert {e["name"]: e["depth"] for e in evs} == {"inner": 1,
                                                         "outer": 0}
        s = tr.summary()
        assert s["inner"]["count"] == 2 and s["outer"]["count"] == 1
        assert evs[-1]["args"]["tag"] == "x"
        assert isinstance(evs[-1]["args"]["obj"], str)
        tr.clear()
        assert tr.events() == []

    def test_export_chrome_as_the_reference(self, tmp_path):
        docs = {}
        for name, mod in (("j", jtel), ("t", ttel)):
            tr = mod.Tracer()
            with tr.span("a", k=1):
                pass
            docs[name] = json.loads(open(tr.export_chrome(
                str(tmp_path / name / "trace.json"))).read())
        (ev,), (want,) = docs["t"]["traceEvents"], docs["j"]["traceEvents"]
        assert set(ev) == set(want) and ev["ph"] == "X"
        assert ev["args"] == want["args"] == {"k": 1}
        assert docs["t"]["displayTimeUnit"] == "ms"
        assert docs["t"]["otherData"]["schema"] == \
            docs["j"]["otherData"]["schema"]

    def test_null_tracer_and_exceptions(self):
        with ttel.NULL_TRACER.span("x"):
            pass
        assert ttel.NULL_TRACER.events() == []
        tr = ttel.Tracer()
        with pytest.raises(ValueError):
            with tr.span("boom"):
                raise ValueError("x")
        assert tr.summary()["boom"]["count"] == 1
        assert ttel.make_tracer(None, False) is ttel.NULL_TRACER
        assert ttel.make_tracer("d", False).profile_dir is None

    def test_profiler_hook_writes_torch_trace(self, tmp_path):
        tr = ttel.make_tracer(str(tmp_path), True)
        assert tr.profile_dir == str(tmp_path / "torch")
        tr.start_profiler()
        with tr.span("work"):
            torch.ones(64).sum()
        path = tr.stop_profiler()
        doc = json.loads(open(path).read())
        assert any(e.get("name") == "work" for e in doc["traceEvents"])
        assert tr.stop_profiler() is None
        # a disabled tracer leaves no range in a profile taken around it
        with torch.profiler.profile() as prof:
            with ttel.NULL_TRACER.span("quiet"):
                torch.ones(8).sum()
        assert not any(e.key == "quiet" for e in prof.key_averages())


def test_runtime_snapshot_as_the_reference():
    for mod in (jtel, ttel):
        snap = mod.runtime_snapshot(programs=None, writer={"submitted": 2},
                                    tracer=mod.Tracer(), extra={"foo": 1})
        assert snap == {"telemetry_schema": 1,
                        "checkpoint_writer": {"submitted": 2},
                        "spans": {}, "foo": 1}


def test_flengine_runtime_stats_and_events(ds16, tmp_path):
    from repro_torch.core.sampler import UniformSampler
    from repro_torch.fed.engine import FLConfig, FLEngine
    mode = make_mode("IDL", n_clients=ds16.n_clients, seed=7)
    cfg = FLConfig(rounds=3, sample_frac=0.25, local_steps=2, batch_size=8,
                   eval_every=1, seed=0)
    path = str(tmp_path / "m.jsonl")
    with tobs.JSONLMetricsSink(path) as sink:
        eng = FLEngine(ds16, logistic_regression(), UniformSampler(), mode,
                       cfg, device="cpu", tracer=ttel.Tracer(), sink=sink)
        eng.run(ckpt_path=str(tmp_path / "ck"), ckpt_every=2)
    st = eng.runtime_stats()
    assert st["telemetry_schema"] == 1 and st["misses"] == 1
    assert st["checkpoint_writer"]["completed"] == 1
    assert {"local_train", "aggregate", "eval", "checkpoint_write"} <= \
        set(st["spans"])
    kinds = [e["kind"] for e in tobs.read_metrics_jsonl(path)]
    assert kinds == ["run_start"] + ["round"] * 3 + ["run_end"]


_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
    r'([-+]?[0-9.]+([eE][-+]?[0-9]+)?|NaN|[+-]Inf)$')


def parse_prometheus(text: str) -> dict:
    """{family: [(labels, value)]} from exposition text; raises on a line
    that is not one."""
    out, typed = {}, set()
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            assert kind in ("counter", "gauge"), ln
            typed.add(name)
            continue
        assert _PROM_LINE.match(ln), ln
        name = re.split(r"[{ ]", ln, 1)[0]
        assert name in typed, ln
        out.setdefault(name, []).append(float(ln.rsplit(" ", 1)[1]))
    return out


def test_sim_service_latency_and_metrics_text(ds16):
    from repro_torch.launch.serve import SimService
    svc = SimService(_engine(ds16, rounds=4, telemetry=True))
    for i in range(2):
        svc.submit(seed=i, avail_seed=70 + i,
                   process=_proc("GE", ds16, 4, 3 + i),
                   aggregator_process=make_aggregator_process("memory"))
    updates = list(svc.drain(segment=2))
    assert len(updates) == 4
    assert updates[0].metrics["staleness_hist"].shape == (2,
                                                          ttel.N_STALE_BINS)
    for t in range(2):
        tm = svc.histories[t].request_timing
        assert 0 <= tm["first_segment_s"] <= tm["complete_s"]
        assert svc.histories[t].telemetry is not None
    fams = parse_prometheus(svc.metrics_text())
    assert fams["fedgs_requests_total"] == [2.0]
    assert fams["fedgs_rounds_streamed_total"] == [8.0]
    assert len(fams["fedgs_request_queue_seconds"]) == 2
    assert fams["fedgs_program_cache_hit_rate"][0] > 0


# ------------------------------------------------------------ obs copies
def test_jsonl_sink_writes_what_the_reference_writes(tmp_path):
    events = [("run_start", {"cells": 2, "mesh": None}),
              ("round", {"t": 0, "x": np.float32(1.5),
                         "hist": np.arange(3, dtype=np.int32),
                         "nan": float("nan"), "inf": [1.0, float("inf")]}),
              ("round", {"t": 1, "nested": {"a": np.int64(4)}}),
              ("run_end", {"runtime": {"hits": 3}})]
    lines = {}
    for name, mod in (("j", jobs), ("t", tobs)):
        path = str(tmp_path / f"{name}.jsonl")
        with mod.JSONLMetricsSink(path, run="r") as sink:
            for kind, payload in events:
                sink.emit(kind, payload, extra=1)
            sink.flush()
            assert sink.stats()["events"] == len(events)
        lines[name] = [json.loads(ln) for ln in open(path)]
        for ev in lines[name]:
            ev.pop("wall_time")
    assert lines["t"] == lines["j"]
    # each reads the other's stream, and both refuse an unknown schema
    assert tobs.read_metrics_jsonl(str(tmp_path / "j.jsonl"), kind="round") \
        == jobs.read_metrics_jsonl(str(tmp_path / "j.jsonl"), kind="round")
    assert len(jobs.read_metrics_jsonl(str(tmp_path / "t.jsonl"))) == 4
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"schema": 999, "kind": "round"}) + "\n")
    with pytest.raises(ValueError, match="schema"):
        tobs.read_metrics_jsonl(str(bad))
    assert tobs.read_metrics_jsonl(str(bad), strict=False) == []
    sink = tobs.JSONLMetricsSink(str(tmp_path / "c.jsonl"))
    sink.close()
    with pytest.raises(RuntimeError, match="closed"):
        sink.emit("round")


def test_prometheus_text_as_the_reference():
    fams = {"requests_total": {"type": "counter", "help": "reqs\nline",
                               "samples": [({}, 3)]},
            "queue_seconds": {"type": "gauge", "help": 'q "x"',
                              "samples": [({"request": "1"}, 0.5),
                                          ({"request": "0", "b": 'a"b'},
                                           0.25)]},
            "odd": {"samples": [({}, float("nan")), ({"k": "1"},
                                                     float("inf")),
                                ({"k": "2"}, 1e20), ({"k": "3"}, -2.0)]}}
    text = tobs.render_prometheus(fams)
    assert text == jobs.render_prometheus(fams)
    assert tobs.render_prometheus(fams, prefix="x_") == \
        jobs.render_prometheus(fams, prefix="x_")
    got = tobs.prom_families({"hits": 4, "misses": 1}, type_="counter",
                             help_texts={"hits": "h"})
    assert got == jobs.prom_families({"hits": 4, "misses": 1},
                                     type_="counter",
                                     help_texts={"hits": "h"})
    parsed = parse_prometheus(tobs.render_prometheus(
        {k: v for k, v in fams.items() if k != "queue_seconds"}))
    assert parsed["fedgs_requests_total"] == [3.0]


def test_fedsim_cli_with_observability(tmp_path, capsys):
    from repro_torch.launch import serve
    mpath = tmp_path / "m.jsonl"
    tdir = tmp_path / "traces"
    hists = serve.main(["--fedsim", "--device", "cpu", "--cells", "2",
                        "--rounds", "4", "--segment", "2", "--n-clients",
                        "12", "--telemetry", "--metrics-jsonl", str(mpath),
                        "--trace-dir", str(tdir)])
    assert len(hists) == 2 and hists[0].telemetry is not None
    evs = tobs.read_metrics_jsonl(str(mpath))
    assert {"run_start", "round", "segment", "request", "run_end"} == \
        {e["kind"] for e in evs}
    trace = json.loads((tdir / "trace.json").read_text())
    assert any(e["name"] == "dispatch_segment"
               for e in trace["traceEvents"])
    out = capsys.readouterr().out
    parse_prometheus(out[out.index("# HELP"):out.index("trace:")])
