"""The sweep engine's layer spans and the tracer's clock, on the CPU.

Contracts:
* ``ScanEngine._round`` opens ``sampler``, ``local_train``, ``aggregate``
  and ``eval`` once each per batch round, in that order, at depth 1 inside
  the segment's ``dispatch_segment``, and their durations fit inside it;
* a run with the tracer on is bitwise the run with ``NULL_TRACER``
  (trajectory and carry);
* a span's ``base_ns / 1e3 + ts`` is the profiler's clock: within 500 us of
  the ``start_ns() / 1e3`` of the profiler's event of the same name, and
  the Chrome export carries ``baseTimeNanoseconds``;
* a disabled tracer hands back one shared no-op context.
"""
import json

import pytest
import torch

from repro_torch.core.availability import make_mode
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed import scan_engine as tse
from repro_torch.fed import telemetry as ttel
from repro_torch.fed.models import logistic_regression

LAYERS = ("sampler", "local_train", "aggregate", "eval")
SEGMENTS = ((0, 2), (2, 3))          # (t0, rounds): 2 segments, 5 rounds
ROUNDS = sum(k for _, k in SEGMENTS)


@pytest.fixture(scope="module")
def ds20():
    return make_synthetic(n_clients=20, seed=3, max_size=200)


def _run(ds, sampler, tracer):
    cfg = tse.ScanConfig(rounds=ROUNDS, m=4, local_steps=2, batch_size=5,
                         lr=0.1, eval_every=1, sampler=sampler,
                         max_sweeps=4)
    eng = tse.ScanEngine(ds, logistic_regression(), cfg, use_masks=True,
                         device="cpu", tracer=tracer)
    h = tse.oracle_h(ds.opt_params, device="cpu") \
        if sampler == "fedgs" else None
    cells = []
    for i, mode in enumerate(("IDL", "LN", "YMF")):
        md = make_mode(mode, n_clients=ds.n_clients, data_sizes=ds.sizes,
                       label_sets=ds.label_sets(),
                       num_labels=ds.num_classes, seed=7)
        cells.append(eng.cell(seed=11 + i, masks=tse.precompute_masks(
            md, ROUNDS, avail_seed=5 + i), h=h, sampler_seed=40 + i))
    handle = eng.init_carry(cells)
    trajs = []
    for t0, k in SEGMENTS:
        handle, traj = eng.run_segment(cells, handle, t0, k)
        trajs.append(traj)
    return handle.tree, trajs


def _leaves(x, path=""):
    if isinstance(x, dict):
        for k in sorted(x, key=str):
            yield from _leaves(x[k], f"{path}/{k}")
    elif isinstance(x, (list, tuple)):
        for i, v in enumerate(x):
            yield from _leaves(v, f"{path}/{i}")
    elif isinstance(x, torch.Tensor):
        yield path, x


@pytest.mark.parametrize("sampler", ["fedgs", "uniform"])
def test_layer_spans_once_a_round_inside_dispatch(ds20, sampler):
    tracer = ttel.Tracer()
    tree_on, trajs_on = _run(ds20, sampler, tracer)
    evs = tracer.events()
    segs = sorted((e for e in evs if e["name"] == "dispatch_segment"),
                  key=lambda e: e["ts"])
    assert len(segs) == len(SEGMENTS)
    assert all(e["depth"] == 0 for e in segs)
    layer = [e for e in evs if e["name"] in LAYERS]
    assert all(e["depth"] == 1 for e in layer)
    for seg, (_, k) in zip(segs, SEGMENTS):
        s0, s1 = seg["ts"], seg["ts"] + seg["dur"]
        inside = sorted((e for e in layer
                         if s0 <= e["ts"] and e["ts"] + e["dur"] <= s1),
                        key=lambda e: e["ts"])
        # one of each a round, in the round's order
        assert [e["name"] for e in inside] == list(LAYERS) * k
        assert sum(e["dur"] for e in inside) <= seg["dur"]
    assert len(layer) == len(LAYERS) * ROUNDS
    # the tracer changes nothing the engine computes
    tree_off, trajs_off = _run(ds20, sampler, ttel.NULL_TRACER)
    got = dict(_leaves({"carry": tree_on, "traj": trajs_on}))
    want = dict(_leaves({"carry": tree_off, "traj": trajs_off}))
    assert set(got) == set(want) and got
    for key, v in want.items():
        assert got[key].dtype == v.dtype and got[key].shape == v.shape, key
        assert got[key].numpy().tobytes() == v.numpy().tobytes(), key


def test_spans_on_the_profilers_clock(tmp_path):
    tracer = ttel.Tracer()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        # a profile's first range pays the profiler's own first-use cost
        # between its start stamp and the span's
        with tracer.span("warm"):
            torch.ones(64).sum()
        with tracer.span("clock_probe"):
            torch.ones(64).sum()
    (ev,) = [e for e in tracer.events() if e["name"] == "clock_probe"]
    starts = [e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name() == "clock_probe"]
    assert starts
    ours = tracer.base_ns / 1e3 + ev["ts"]
    assert min(abs(ours - s / 1e3) for s in starts) < 500.0
    doc = json.loads(open(tracer.export_chrome(
        str(tmp_path / "trace.json"))).read())
    assert doc["baseTimeNanoseconds"] == tracer.base_ns
    (xev,) = [e for e in doc["traceEvents"] if e["name"] == "clock_probe"]
    # one ulp of a Unix-epoch microsecond in a float64 is 0.25 us
    assert abs(doc["baseTimeNanoseconds"] / 1e3 + xev["ts"] - ours) <= 1.0


def test_disabled_span_is_one_shared_noop():
    null = ttel.NULL_TRACER
    a, b = null.span("sampler"), null.span("eval", t=3)
    assert a is b
    with a as got:
        assert got is null
    with null.span("x"):
        pass
    assert null.events() == []
