"""The port's runtime layer (``repro_torch.fed.runtime``), its stream and
its service front end, against ``repro.fed.runtime`` and
``repro.launch.serve`` on the CPU at the reference's ``ds16`` scale.

Contracts:
* ``ProgramCache``, ``CarryHandle`` and ``AsyncCheckpointWriter`` behave
  as the reference's: the same LRU order and hit / miss / eviction counts,
  consume-once handles, ordered writes with sticky, fail-fast errors, the
  same counter keys; ``compiles`` counts kernel-library loads;
* ``host_snapshot`` copies CPU tensors (a later in-place round does not
  reach the copy);
* ``run_segment`` consumes the handle it is given (a later read raises)
  unless ``donate_carry=False``; ``donate_carry=False`` and
  ``async_pipeline=False`` are bitwise the defaults, histories and
  checkpoint arrays alike, for every COMBO; ``ckpt_every`` without a path
  runs segments, bitwise the whole run; the stream yields its segments in
  order, as the reference's does;
* ``runtime_stats`` has the reference's shape; ``compile_cache_dir``,
  ``lower_batch`` and ``carry_shapes`` raise;
* ``SimService``: one update per (request, segment), in the reference's
  order, reassembling to ``run_batch``'s histories bitwise; the service's
  counters as the reference's; ``python -m repro_torch.launch.serve
  --fedsim --device cpu`` runs.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.fed import runtime as jrt
from repro.fed.scan_engine import ScanConfig as JaxScanConfig

from repro_torch.core.availability_device import make_process
from repro_torch.fed import runtime as trt
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.models import logistic_regression
from repro_torch.fed.scan_engine import ScanConfig, ScanEngine

ROOT = Path(__file__).resolve().parents[1]
HIST_FIELDS = ("sel", "valid", "counts", "gini", "count_var", "val_loss",
               "val_acc")
COMBOS = [("fedavgm", "GE"), ("fedadam", "CLUSTER"),
          ("fedprox_w", "DRIFT"), ("memory", "DEADLINE")]


@pytest.fixture(scope="module")
def ds16():
    from repro.data.synthetic import make_synthetic
    return make_synthetic(n_clients=16, alpha=0.5, beta=0.5, seed=0)


def _proc(name, ds, rounds, seed=7):
    return make_process(name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                        label_sets=ds.label_sets(),
                        num_labels=ds.num_classes, rounds=rounds, seed=seed)


def _cfg(rounds, **kw):
    return ScanConfig(rounds=rounds, m=4, local_steps=2, batch_size=8,
                      lr=0.1, eval_every=1, sampler="uniform", **kw)


def _engine(ds, rounds, **kw):
    return ScanEngine(ds, logistic_regression(), _cfg(rounds, **kw),
                      device="cpu")


def _cells(eng, ds, rounds, agg, scenario, b=2):
    return [eng.cell(seed=s, process=_proc(scenario, ds, rounds, 3 + s),
                     avail_seed=70 + s,
                     aggregator_process=make_aggregator_process(agg))
            for s in range(b)]


def _same(a, b, msg=""):
    for f in HIST_FIELDS:
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), \
            f"{msg}: {f}"


# ------------------------------------------------------------ ProgramCache
def test_program_cache_lru_as_the_reference():
    """The same get sequence through both caches: the same builds, the
    same LRU order, the same counters (``compiles`` aside)."""
    log = {"j": [], "t": []}

    def mk(side, tag):
        def build():
            log[side].append(tag)
            return lambda: tag
        return build
    caches = {"j": jrt.ProgramCache(maxsize=2), "t": trt.ProgramCache(
        maxsize=2)}
    for side, pc in caches.items():
        for key in ("a", "b", "a", "c", "b", "c", "a"):
            assert pc.get(key, mk(side, key))() == key
    assert log["t"] == log["j"] == ["a", "b", "c", "b", "a"]
    st, want = caches["t"].stats(), caches["j"].stats()
    assert set(st) == set(want)
    for k in ("hits", "misses", "evictions", "size"):
        assert st[k] == want[k], k
    assert ("b" in caches["t"]) == ("b" in caches["j"])
    with pytest.raises(ValueError):
        trt.ProgramCache(maxsize=0)
    with pytest.raises(ValueError):
        ScanConfig(program_cache_size=0)


def test_compile_counters_read_the_kernel_builds(monkeypatch):
    from repro_torch.kernels import _build
    monkeypatch.setattr(_build, "_compiles",
                        {"compiles": 3, "compile_ms": 12.5})
    st = trt.ProgramCache().stats()
    assert (st["compiles"], st["compile_ms"]) == (3, 12.5)


def test_plan_cache_bounded_by_program_cache_size(ds16):
    eng = _engine(ds16, 2, program_cache_size=2)
    batches = [_cells(eng, ds16, 2, "fedavg", "GE", b=1) for _ in range(3)]
    for cells in batches + [batches[2]]:
        eng.run_batch(cells)
    st = eng.runtime_stats()
    assert st["size"] == 2 and st["evictions"] == 1
    assert st["misses"] == 3 and st["hits"] >= 1


# ------------------------------------------------------------- CarryHandle
@pytest.mark.parametrize("mod", [jrt, trt], ids=["reference", "port"])
def test_carry_handle_consume_once(mod):
    h = mod.CarryHandle({"x": 1})
    assert h.alive and h.tree == {"x": 1}
    assert h.consume() == {"x": 1}
    assert not h.alive
    with pytest.raises(RuntimeError, match="use-after"):
        _ = h.tree
    with pytest.raises(RuntimeError, match="use-after"):
        h.consume()


def test_host_snapshot_copies_cpu_tensors():
    tree = {"mem": torch.zeros(3, 2), "h": [torch.ones(2), None],
            "round": 4}
    snap = trt.host_snapshot(tree).wait()
    tree["mem"][1] = 7.0                 # the next round, in place
    tree["h"][0].add_(1.0)
    assert torch.equal(snap["mem"], torch.zeros(3, 2))
    assert torch.equal(snap["h"][0], torch.ones(2))
    assert snap["h"][1] is None and snap["round"] == 4
    clone = trt.clone_tree(tree)
    tree["mem"].zero_()
    assert clone["mem"][1, 0] == 7.0


# --------------------------------------------------- AsyncCheckpointWriter
@pytest.mark.parametrize("mod", [jrt, trt], ids=["reference", "port"])
def test_writer_ordered_sticky_fail_fast(mod):
    seen = []
    with mod.AsyncCheckpointWriter() as w:
        for i in range(5):
            w.submit(seen.append, i)
        w.flush()
    assert seen == [0, 1, 2, 3, 4]
    st = w.stats()
    assert st["submitted"] == st["completed"] == 5
    w = mod.AsyncCheckpointWriter()
    w.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        w.flush()
    w.submit(seen.append, 9)           # alive after the first error
    w.close()
    assert seen[-1] == 9
    w = mod.AsyncCheckpointWriter()
    w.submit(lambda: 1 / 0)
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        w.close()


def test_writer_backpressure_counters_as_the_reference():
    import threading
    stats = {}
    for name, mod in (("j", jrt), ("t", trt)):
        gate = threading.Event()
        w = mod.AsyncCheckpointWriter(max_pending=1)
        w.submit(gate.wait)
        w.submit(lambda: None)          # fills the queue
        threading.Timer(0.05, gate.set).start()
        w.submit(lambda: None)          # blocks until the gate opens
        w.close()
        stats[name] = w.stats()
    assert set(stats["t"]) == set(stats["j"])
    assert stats["t"]["blocked_ms"] > 0
    for k in ("submitted", "completed", "max_pending"):
        assert stats["t"][k] == stats["j"][k], k


# -------------------------------------------------- engine runtime surface
def test_run_segment_consumes_the_handle(ds16):
    eng = _engine(ds16, 4)
    cells = _cells(eng, ds16, 4, "memory", "GE")
    h0 = eng.init_carry(cells)
    assert isinstance(h0, trt.CarryHandle)
    h1, traj = eng.run_segment(cells, h0, 0, 2)
    assert not h0.alive and h1.alive
    with pytest.raises(RuntimeError, match="use-after-consume"):
        eng.run_segment(cells, h0, 2, 2)
    with pytest.raises(RuntimeError, match="use-after-consume"):
        _ = h0.tree["counts"]
    h2, _ = eng.run_segment(cells, h1, 2, 2)
    assert traj["sel"].shape == (2, 2, 4)
    # donate_carry=False: the handle survives and the segment is the same
    keep = _engine(ds16, 4, donate_carry=False)
    k0 = keep.init_carry(cells)
    k1, _ = keep.run_segment(cells, k0, 0, 2)
    k2, _ = keep.run_segment(cells, k1, 2, 2)
    assert k0.alive and k1.alive
    assert torch.equal(k0.tree["counts"], torch.zeros(2, 16))
    assert torch.equal(k2.tree["counts"], h2.tree["counts"])
    assert torch.equal(k2.tree["agg"][0]["mem"], h2.tree["agg"][0]["mem"])


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("agg,scenario", COMBOS)
def test_no_donation_and_inline_bitwise_the_default(ds16, tmp_path, agg,
                                                    scenario):
    rounds = 6
    out = {}
    for name, kw in (("default", {}), ("no_donate", {"donate_carry": False}),
                     ("inline", {"async_pipeline": False})):
        eng = _engine(ds16, rounds, **kw)
        ck = str(tmp_path / name)
        out[name] = (eng.run_batch(_cells(eng, ds16, rounds, agg, scenario),
                                   ckpt_path=ck, ckpt_every=2),
                     _npz(ck + ".npz"))
        if name == "default":
            assert eng.runtime_stats()["checkpoint_writer"]["completed"] \
                == 2
    want, want_ck = out["default"]
    assert int(want_ck["round"]) == 4
    for name in ("no_donate", "inline"):
        got, got_ck = out[name]
        for i in range(2):
            _same(got[i], want[i], f"{name} {i}")
        assert sorted(got_ck) == sorted(want_ck)
        for k in want_ck:
            assert np.array_equal(got_ck[k], want_ck[k]), f"{name} {k}"


def test_stream_yields_segments_in_order(ds16):
    rounds = 6
    eng = _engine(ds16, rounds)
    cells = _cells(eng, ds16, rounds, "fedavgm", "GE")
    segs = list(eng.run_batch_stream(cells, ckpt_every=4))
    assert [(t0, k) for t0, k, _ in segs] == [(0, 4), (4, 2)]
    for _, k, traj in segs:
        assert traj["sel"].shape[:2] == (len(cells), k)
        assert isinstance(traj["sel"], np.ndarray)
        assert traj["sel"].dtype == np.int32
    assert eng.final_counts.shape == (len(cells), ds16.n_clients)
    whole = eng.run_batch(cells)
    sel = np.concatenate([t["sel"] for _, _, t in segs], axis=1)
    assert np.array_equal(sel[0], whole[0].sel)


def test_ckpt_every_without_path_segments(ds16):
    rounds = 6
    eng = _engine(ds16, rounds)
    cells = _cells(eng, ds16, rounds, "fedadam", "CLUSTER")
    whole = eng.run_batch(cells)
    seen = []
    orig = eng.run_segment

    def spy(c, h, t0, k):
        seen.append((t0, k))
        return orig(c, h, t0, k)
    eng.run_segment = spy
    seg = eng.run_batch(cells, ckpt_every=2)
    assert seen == [(0, 2), (2, 2), (4, 2)]
    for a, b in zip(seg, whole):
        _same(a, b)


def test_runtime_stats_shape_and_rejections(ds16, tmp_path):
    from repro.fed.models import logistic_regression as jax_logreg
    from repro.fed.scan_engine import ScanEngine as JaxScanEngine
    eng = _engine(ds16, 4)
    cells = _cells(eng, ds16, 4, "fedavg", "GE")
    eng.run_batch(cells, ckpt_path=str(tmp_path / "ck"), ckpt_every=2)
    got = eng.runtime_stats()
    want = JaxScanEngine(ds16, jax_logreg(), JaxScanConfig(
        rounds=4)).runtime_stats()
    assert set(want) <= set(got)
    assert set(got) - set(want) == {"checkpoint_writer"}
    assert set(got["checkpoint_writer"]) == set(
        jrt.AsyncCheckpointWriter().stats())
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        ScanConfig(compile_cache_dir=str(tmp_path))
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        eng.lower_batch(cells)
    # carry_shapes is ported: the memory panel (N, P) as init_carry has it
    shapes = eng.carry_shapes(cells)
    tree = eng.init_carry(cells).tree
    for i, st in tree["agg"].items():
        assert shapes["agg"][i]["mem"].shape == tuple(st["mem"].shape)


# --------------------------------------------------------------- SimService
def _svc_kw(ds, rounds):
    return lambda i: dict(
        seed=i, avail_seed=70 + i,
        process=_proc(("GE", "DEADLINE")[i % 2], ds, rounds, 3 + i),
        aggregator_process=make_aggregator_process(
            ("memory", "fedavgm")[i % 2]))


def test_sim_service_streams_and_matches_run_batch(ds16):
    from repro_torch.launch.serve import SimService
    rounds = 6
    kw = _svc_kw(ds16, rounds)
    svc = SimService(_engine(ds16, rounds))
    tickets = [svc.submit(**kw(i)) for i in range(2)]
    updates = list(svc.drain(segment=3))
    assert [(u.request, u.t0, u.rounds) for u in updates] == \
        [(0, 0, 3), (1, 0, 3), (0, 3, 3), (1, 3, 3)]
    ref_eng = _engine(ds16, rounds)
    ref = ref_eng.run_batch([ref_eng.cell(**kw(i)) for i in range(2)])
    for i, t in enumerate(tickets):
        hist = svc.histories[t]
        _same(hist, ref[i], f"request {t}")
        vl = np.concatenate([u.val_loss for u in updates if u.request == t])
        assert np.array_equal(vl, hist.val_loss, equal_nan=True)
        assert set(hist.request_timing) == {"submit_time",
                                            "first_segment_s", "complete_s"}
    st = svc.stats()["service"]
    assert (st["requests_total"], st["drains_total"],
            st["segments_streamed_total"], st["updates_streamed_total"],
            st["rounds_streamed_total"]) == (2, 1, 2, 4, 12)
    assert list(svc.drain()) == []          # nothing pending


def test_sim_service_counters_as_the_reference(ds16):
    """The same requests through the reference's service and the port's:
    the same update windows and the same counters."""
    from repro.core.availability_device import make_process as jmp
    from repro.fed.aggregator_device import \
        make_aggregator_process as jmagg
    from repro.fed.models import logistic_regression as jax_logreg
    from repro.fed.scan_engine import ScanEngine as JaxScanEngine
    from repro.launch.serve import SimService as JaxSimService
    from repro_torch.launch.serve import SimService
    rounds = 4

    def kw(make, magg, i):
        return dict(seed=i, avail_seed=70 + i, aggregator_process=magg(
            "fedavgm"), process=make("GE", n_clients=ds16.n_clients,
                                     rounds=rounds, seed=3 + i))
    jsvc = JaxSimService(JaxScanEngine(ds16, jax_logreg(), JaxScanConfig(
        rounds=rounds, m=4, local_steps=2, batch_size=8, sampler="uniform")))
    tsvc = SimService(_engine(ds16, rounds))
    for i in range(3):
        jsvc.submit(**kw(jmp, jmagg, i))
        tsvc.submit(**kw(make_process, make_aggregator_process, i))
    ju = [(u.request, u.t0, u.rounds) for u in jsvc.drain(segment=2)]
    tu = [(u.request, u.t0, u.rounds) for u in tsvc.drain(segment=2)]
    assert tu == ju
    want, got = jsvc.stats()["service"], tsvc.stats()["service"]
    assert set(got) == set(want)
    for k in want:
        if k != "drain_busy_seconds_total":
            assert got[k] == want[k], k


def test_serve_fedsim_entry_runs(capsys):
    from repro_torch.launch import serve
    hists = serve.main(["--fedsim", "--device", "cpu", "--cells", "2",
                        "--rounds", "4", "--segment", "2", "--n-clients",
                        "12"])
    assert len(hists) == 2 and hists[0].val_loss.shape == (4,)
    out = capsys.readouterr().out
    assert "fedsim: 2 cells x 4 rounds" in out
    assert "fedgs_rounds_streamed_total 8" in out


def test_python_m_serve_fedsim_on_the_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--fedsim",
         "--device", "cpu", "--cells", "2", "--rounds", "4", "--segment",
         "2", "--n-clients", "12"], capture_output=True, text=True, env=env,
        cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "fedsim: 2 cells x 4 rounds, 4 streamed updates" in proc.stdout
