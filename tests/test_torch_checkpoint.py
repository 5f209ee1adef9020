"""The port's checkpoints (``repro_torch.checkpoint``) and exact resume of
both engines, against ``repro.checkpoint`` and the reference's runs on the
CPU, at the reference's ``ds16`` scale (Synthetic(0.5, 0.5), N = 16).

Contracts:
* format: the same nested numpy tree (empty containers, bf16, scalars)
  gives the same npz keys and arrays from either package, and each package
  loads the other's file; torch leaves (bf16 too) are written as their
  numpy twins; an object leaf is refused, so files load without pickles;
* ScanEngine: for each of the reference's COMBOS (a stateful aggregator x
  a stateful availability family) and for a fault + krum batch, the run
  with checkpoints every 3 rounds and a FRESH engine's resume from the
  round-3 file are bitwise the unbroken run; with the reference's draws in
  the seams each resumed cell selects the reference's per-cell sets with
  its counts, val_loss within 1e-4; a missing file starts fresh;
* FLEngine: for the same COMBOS the resumed tail and final params are
  bitwise the unbroken run's; with the reference's draws the tail matches
  the reference's run (sets, val_loss within 1e-4); a file without the
  server state (the older format) still resumes, from a fresh server.
"""
import numpy as np
import pytest
import torch

import jax
import ml_dtypes

from repro.checkpoint import ckpt as jckpt
from repro.core.availability import make_mode as jax_make_mode
from repro.core.availability_device import make_process as jax_make_process
from repro.fed import scan_engine as jse
from repro.fed.aggregator_device import \
    make_aggregator_process as jax_make_aggregator
from repro.fed.engine import FLConfig as JaxFLConfig, FLEngine as JaxFLEngine
from repro.fed.models import logistic_regression as jax_logreg

from repro_torch.checkpoint import ckpt as tckpt
from repro_torch.core.availability import ProcessMode, make_mode
from repro_torch.core.availability_device import make_process
from repro_torch.core.sampler import make_sampler
from repro_torch.fed import scan_engine as tse
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.faults_device import make_fault_process
from repro_torch.fed.models import logistic_regression

from test_torch_engine import _jax_params
from test_torch_engine import jax_batch_indices as fl_batch_indices
from test_torch_scan import (_idx_program, jax_avail_draws, jax_init,
                             jax_sampler_draws)

COMBOS = [("fedavgm", "GE"), ("fedadam", "CLUSTER"),
          ("fedprox_w", "DRIFT"), ("memory", "DEADLINE")]
ROUNDS, SPLIT, M, E, B = 6, 3, 4, 2, 8


_draw_idx = _idx_program(E, B)


def seams(seed):
    """The reference scan's init, training-index and Gumbel draws."""
    def batch(t, sel, sizes):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        _, sub = jax.random.split(key)
        return np.asarray(_draw_idx(sub, np.asarray(sizes, np.int32)),
                          np.int64)
    return {"init_params": jax_init(seed), "batch_indices": batch,
            "sampler_draws": jax_sampler_draws(seed + 0x5E1EC7)}


@pytest.fixture(scope="module")
def ds16():
    from repro.data.synthetic import make_synthetic
    return make_synthetic(n_clients=16, alpha=0.5, beta=0.5, seed=0)


# ------------------------------------------------------------------ format
def _tree():
    rng = np.random.default_rng(0)
    return {"params": {"w": rng.normal(size=(3, 4)).astype(np.float32),
                       "b": np.arange(4, dtype=np.int64)},
            "bf": rng.normal(size=(5,)).astype(ml_dtypes.bfloat16),
            "seq": [np.float32(1.5), np.zeros((2, 0), np.float32),
                    (np.bool_(True), np.int8(-3))],
            "empty_d": {}, "empty_l": [], "empty_t": (),
            "round": np.int64(7), "nested": {"x": {"y": {}}}}


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def test_format_same_keys_and_arrays(tmp_path):
    tree = _tree()
    jckpt.save_checkpoint(str(tmp_path / "j"), tree, metadata={"a": 1})
    tckpt.save_checkpoint(str(tmp_path / "t"), tree, metadata={"a": 1})
    want, got = _npz(tmp_path / "j.npz"), _npz(tmp_path / "t.npz")
    assert sorted(got) == sorted(want)
    assert "bf%bf16" in got and "empty_t%empty" in got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert np.array_equal(got[k], want[k]), k
    assert (tmp_path / "t.json").read_text() == \
        (tmp_path / "j.json").read_text()


def test_each_package_loads_the_others_file(tmp_path):
    tree = _tree()
    jckpt.save_checkpoint(str(tmp_path / "j.npz"), tree)
    tckpt.save_checkpoint(str(tmp_path / "t.npz"), tree)
    from_j = tckpt.load_checkpoint(str(tmp_path / "j"))
    from_t = jckpt.load_checkpoint(str(tmp_path / "t"))
    # bf16: ml_dtypes on the reference's side, a torch tensor on the port's
    assert torch.equal(from_j["bf"].view(torch.int16), torch.from_numpy(
        tree["bf"].view(np.int16)))
    assert np.array_equal(from_t["bf"].view(np.uint16),
                          tree["bf"].view(np.uint16))
    for got in (from_j, from_t):
        assert np.array_equal(got["params"]["w"], tree["params"]["w"])
        assert got["empty_d"] == {} and got["empty_l"] == [] and \
            got["empty_t"] == ()
        assert got["nested"] == {"x": {"y": {}}}
        assert int(got["round"]) == 7
        assert got["seq"]["2"]["1"] == -3
    # with a template: sequences and dtypes back
    like = jax.tree_util.tree_map(lambda x: x, tree)
    got = tckpt.load_checkpoint(str(tmp_path / "j"), like=like)
    assert isinstance(got["seq"], list) and isinstance(got["seq"][2], tuple)
    assert got["params"]["b"].dtype == np.int64
    assert np.array_equal(got["params"]["b"], tree["params"]["b"])


def test_torch_leaves_int_keys_and_none(tmp_path):
    bf = torch.randn(7, generator=torch.Generator().manual_seed(1)).to(
        torch.bfloat16)
    tree = {"agg": {0: {"m": torch.ones(2, 3)}, 5: {"m": torch.zeros(1)}},
            "bf": bf, "i": torch.arange(3), "h": [torch.eye(2), {}]}
    tckpt.save_checkpoint(str(tmp_path / "t"), tree)
    flat = _npz(tmp_path / "t.npz")
    assert sorted(flat) == ["agg/0/m", "agg/5/m", "bf%bf16", "h/0",
                            "h/1%empty", "i"]
    assert flat["bf%bf16"].dtype == np.uint16 and flat["i"].dtype == np.int64
    # the reference reads the torch bf16 bits as ml_dtypes bf16
    ref = jckpt.load_checkpoint(str(tmp_path / "t"))
    assert np.array_equal(ref["bf"].astype(np.float32),
                          bf.to(torch.float32).numpy())
    like = {"agg": {0: {"m": torch.empty(0)}, 5: {"m": torch.empty(0)}},
            "bf": torch.empty(0, dtype=torch.bfloat16),
            "i": torch.empty(0, dtype=torch.int32), "h": [torch.empty(0),
                                                          None]}
    got = tckpt.load_checkpoint(str(tmp_path / "t"), like=like)
    assert torch.equal(got["bf"], bf) and got["i"].dtype == torch.int32
    assert torch.equal(got["agg"][5]["m"], torch.zeros(1))
    assert got["h"][1] is None and torch.equal(got["h"][0], torch.eye(2))
    with pytest.raises(KeyError):
        tckpt.load_checkpoint(str(tmp_path / "t"), like={"missing": None,
                                                          "x": 0})
    with pytest.raises(TypeError, match="pickle"):
        tckpt.save_checkpoint(str(tmp_path / "bad"), {"h": [None]})


# ------------------------------------------------------------- ScanEngine
def _cfg(mod, rounds=ROUNDS, **kw):
    return mod.ScanConfig(rounds=rounds, m=M, local_steps=E, batch_size=B,
                          lr=0.1, eval_every=1, sampler="uniform", **kw)


def _proc(make, ds, name, seed):
    return make(name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                label_sets=ds.label_sets(), num_labels=ds.num_classes,
                rounds=ROUNDS, seed=seed)


def _bitwise(a, b, msg=""):
    for f in ("sel", "valid", "counts", "gini", "count_var", "val_loss",
              "val_acc"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), \
            f"{msg}: {f}"
    assert (a.chosen is None) == (b.chosen is None)
    if a.chosen is not None:
        assert np.array_equal(a.chosen, b.chosen), f"{msg}: chosen"


def _scan_cells(eng, ds, agg, scenario, ref_draws):
    out = []
    for s in range(2):
        proc = _proc(make_process, ds, scenario, 3 + s)
        kw = {}
        if ref_draws:
            kw = {**seams(s), "avail_draws": jax_avail_draws(
                proc.draw_dist, 70 + s, ds.n_clients)}
        out.append(eng.cell(seed=s, process=proc, avail_seed=70 + s,
                            aggregator_process=make_aggregator_process(agg),
                            **kw))
    return out


def _resume_triple(ds, tmp_path, make_cells, **cfg_kw):
    """(unbroken, segmented with checkpoints, resumed in a fresh engine)."""
    eng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse, **cfg_kw),
                         device="cpu")
    whole = eng.run_batch(make_cells(eng))
    ck = str(tmp_path / "ck")
    seg = eng.run_batch(make_cells(eng), ckpt_path=ck, ckpt_every=SPLIT)
    eng2 = tse.ScanEngine(ds, logistic_regression(), _cfg(tse, **cfg_kw),
                          device="cpu")
    res = eng2.run_batch(make_cells(eng2), ckpt_path=ck, ckpt_every=SPLIT,
                         resume=True)
    return whole, seg, res


@pytest.fixture(scope="module")
def jax_scan_runs(ds16):
    """The reference's per-cell runs of each COMBO's two cells."""
    out = {}
    eng = jse.ScanEngine(ds16, jax_logreg(), _cfg(jse))
    for agg, scenario in COMBOS:
        out[agg] = [eng.run(eng.cell(
            seed=s, process=_proc(jax_make_process, ds16, scenario, 3 + s),
            avail_seed=70 + s, aggregator_process=jax_make_aggregator(agg)))
            for s in range(2)]
    return out


@pytest.mark.parametrize("agg,scenario", COMBOS)
def test_scan_resume_bitwise(ds16, tmp_path, jax_scan_runs, agg, scenario):
    whole, seg, res = _resume_triple(
        ds16, tmp_path,
        lambda e: _scan_cells(e, ds16, agg, scenario, ref_draws=True))
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert int(z["round"]) == SPLIT
        # the (N, P) memory panel has rows for a memory cell only
        assert z["carry/agg/0/mem"].shape[0] == (16 if agg == "memory"
                                                  else 0)
    for i in range(2):
        _bitwise(seg[i], whole[i], f"{agg} seg {i}")
        _bitwise(res[i], whole[i], f"{agg} resumed {i}")
        want = jax_scan_runs[agg][i]
        for t in range(ROUNDS):
            assert res[i].sampled(t).tolist() == want.sampled(t).tolist()
        assert np.array_equal(res[i].counts, np.asarray(want.counts))
        np.testing.assert_allclose(res[i].val_loss, want.val_loss,
                                   atol=1e-4)


def test_scan_resume_bitwise_fault_krum(ds16, tmp_path):
    """krum x sign_flip, and a straggler x trimmed-mean cell whose (N, P)
    stale panel rides the carry, plus a memory cell and a PoC cell on the
    engine's own device draws (no generator state is saved: every draw is
    keyed by its round)."""
    n = ds16.n_clients

    def cells(eng):
        from repro_torch.core.sampler_device import make_sampler_process
        return [
            eng.cell(seed=0, process=_proc(make_process, ds16, "GE", 3),
                     avail_seed=70,
                     fault_process=make_fault_process("sign_flip", n,
                                                      frac=0.25),
                     aggregator_process=make_aggregator_process(
                         "krum", krum_f=1)),
            eng.cell(seed=1, process=_proc(make_process, ds16, "GE", 4),
                     avail_seed=71,
                     fault_process=make_fault_process("straggler_stale", n,
                                                      frac=0.5),
                     aggregator_process=make_aggregator_process(
                         "trimmed_mean", beta_trim=0.25)),
            eng.cell(seed=2, process=_proc(make_process, ds16, "DEADLINE",
                                           5),
                     aggregator_process=make_aggregator_process("memory"),
                     fault_process=make_fault_process("gaussian_noise", n,
                                                      frac=0.25)),
            eng.cell(seed=3, process=_proc(make_process, ds16, "CLUSTER", 6),
                     sampler_process=make_sampler_process("poc"))]
    whole, seg, res = _resume_triple(ds16, tmp_path, cells)
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert "carry/fault/1/stale" in z.files and \
            "carry/fault/3/stale" not in z.files
        assert "traj/chosen" in z.files
    for i in range(4):
        _bitwise(seg[i], whole[i], f"seg {i}")
        _bitwise(res[i], whole[i], f"resumed {i}")


def test_scan_resume_without_checkpoint_starts_fresh(ds16, tmp_path):
    eng = tse.ScanEngine(ds16, logistic_regression(), _cfg(tse, rounds=4),
                         device="cpu")
    cells = [eng.cell(seed=0, process=_proc(make_process, ds16, "GE", 7))]
    got = eng.run_batch(cells, ckpt_path=str(tmp_path / "missing"),
                        resume=True)
    _bitwise(got[0], eng.run_batch(cells)[0])
    assert not (tmp_path / "missing.npz").exists()


def test_scan_checkpoint_dynamic_3dg(ds16, tmp_path):
    """With the dynamic 3DG the carry holds each cell's embeddings and H:
    the resume rebuilds H on the same cadence, bitwise."""
    from repro_torch.core.sampler_device import make_sampler_process
    masks = tse.precompute_masks(make_mode("IDL", n_clients=16), ROUNDS, 3)

    def cells(eng):
        return [eng.cell(seed=s, masks=masks,
                         sampler_process=make_sampler_process(name))
                for s, name in ((0, "fedgs"), (1, "uniform"))]

    def run(eng, **kw):
        return eng.run_batch(cells(eng), **kw)
    kw = dict(graph_refresh_every=2, max_sweeps=4)
    engines = [tse.ScanEngine(ds16, logistic_regression(), _cfg(tse, **kw),
                              use_masks=True, device="cpu")
               for _ in range(2)]
    whole = run(engines[0])
    ck = str(tmp_path / "ck")
    run(engines[0], ckpt_path=ck, ckpt_every=SPLIT)
    res = run(engines[1], ckpt_path=ck, ckpt_every=SPLIT, resume=True)
    with np.load(ck + ".npz") as z:
        assert "carry/emb/0" in z.files and "carry/h/1" in z.files
    for a, b in zip(res, whole):
        _bitwise(a, b)


# --------------------------------------------------------------- FLEngine
def _fl(ds, agg, scenario, rounds=8, **kw):
    proc = _proc(make_process, ds, scenario, 7)
    cfg = FLConfig(rounds=rounds, sample_frac=0.25, local_steps=E,
                   batch_size=B, eval_every=1, seed=0, avail_seed=1234)
    return FLEngine(ds, logistic_regression(), make_sampler("uniform"),
                    ProcessMode(proc, avail_seed=1234), cfg, device="cpu",
                    aggregator=make_aggregator_process(agg), **kw)


def _fl_resumed(build, tmp_path, split=4):
    full = build()
    h_full = full.run()
    ck = str(tmp_path / "ck")
    head = build()
    head.cfg.rounds = split
    head.run(ckpt_path=ck, ckpt_every=split)
    res = build()
    h_res = res.run(ckpt_path=ck, resume=True)
    return full, h_full, res, h_res


def _fl_bitwise(full, h_full, res, h_res, split=4):
    assert h_res.rounds == list(range(split, full.cfg.rounds))
    assert h_res.val_loss == h_full.val_loss[split:]
    assert h_res.all_sampled == h_full.all_sampled[split:]
    assert np.array_equal(res.counts, full.counts)
    for k in full.params:
        assert torch.equal(res.params[k], full.params[k]), k


@pytest.mark.parametrize("agg,scenario", COMBOS)
def test_flengine_resume_bitwise(ds16, tmp_path, agg, scenario):
    _fl_bitwise(*_fl_resumed(lambda: _fl(ds16, agg, scenario), tmp_path))


def test_flengine_fault_resume_bitwise(ds16, tmp_path):
    build = lambda: _fl(ds16, "trimmed_mean", "GE",    # noqa: E731
                        fault="straggler_stale", fault_frac=0.5)
    _fl_bitwise(*_fl_resumed(build, tmp_path))
    with np.load(str(tmp_path / "ck.npz")) as z:
        assert "faults/stale" in z.files and "faults/latency" in z.files


def test_flengine_resume_vs_reference(ds16, tmp_path):
    """FedGS with the memory family on a Table-1 mode, the reference's H,
    init and batch draws: the resumed tail selects the reference's sets,
    val_loss within 1e-4 of the reference's unbroken run."""
    from repro.core.graph import build_3dg as jax_build_3dg
    from repro.core.sampler import FedGSSampler as JaxFedGSSampler
    from repro_torch.core.sampler import FedGSSampler
    _, _, h = jax_build_3dg(ds16.opt_params)
    h = np.asarray(h)

    def build(mod_cfg, mod_engine, sampler, mode_fn, model, agg, **kw):
        cfg = mod_cfg(rounds=8, sample_frac=0.25, local_steps=E,
                      batch_size=B, eval_every=1, seed=0, avail_seed=1234)
        eng = mod_engine(ds16, model, sampler,
                         mode_fn("LN", n_clients=16, beta=0.5, seed=99),
                         cfg, aggregator=agg("memory", gamma=0.9), **kw)
        eng.install_graph_from_H(h)
        return eng
    want = build(JaxFLConfig, JaxFLEngine, JaxFedGSSampler(alpha=1.0),
                 jax_make_mode, jax_logreg(), jax_make_aggregator).run()
    seams_kw = {"device": "cpu", "init_params": _jax_params(0),
                "batch_indices": fl_batch_indices(0, E, B)}
    port = lambda: build(                                 # noqa: E731
        FLConfig, FLEngine, FedGSSampler(alpha=1.0, device="cpu"), make_mode,
        logistic_regression(), make_aggregator_process, **seams_kw)
    full, h_full, res, h_res = _fl_resumed(port, tmp_path)
    _fl_bitwise(full, h_full, res, h_res)
    assert h_res.sampled == [list(map(int, s)) for s in want.sampled[4:]]
    np.testing.assert_allclose(h_res.val_loss, want.val_loss[4:], atol=1e-4)


def test_flengine_older_format_without_server_state(ds16, tmp_path):
    ck = str(tmp_path / "ck")
    head = _fl(ds16, "fedavgm", "GE")
    head.cfg.rounds = 4
    head.run(ckpt_path=ck, ckpt_every=4)
    with np.load(ck + ".npz") as z:
        assert any(k.startswith("server/m1/") for k in z.files)
        legacy = {k: z[k] for k in z.files if not k.startswith("server/")}
    full = _fl(ds16, "fedavgm", "GE")
    h_full = full.run()
    np.savez(str(tmp_path / "old.npz"), **legacy)
    res = _fl(ds16, "fedavgm", "GE")
    h_old = res.run(ckpt_path=str(tmp_path / "old"), resume=True)
    assert h_old.rounds == list(range(4, 8))
    assert np.all(np.isfinite(h_old.val_loss))
    # momentum restarted from zero: the tail drifts from the unbroken run
    assert h_old.val_loss != h_full.val_loss[4:]
    assert "checkpoint_writer" not in res.runtime_stats()
    assert head.runtime_stats()["checkpoint_writer"]["completed"] == 1
