"""The port's (cells, silo) mesh on ``torch.distributed`` (``launch/mesh``,
``sharding/rules``, ``ScanConfig.mesh`` / ``cell_sharding`` /
``silo_reduce``) on the CPU, over 2–4 gloo ranks spawned with a file store.

Contract, the reference's own (``tests/test_shard_engine.py``): against
the reference's single-device ``run_batch`` of the same mixed cells (its
draws handed in through the seams), every decision — sets, pad masks,
counts, the count-derived fairness metrics — is bitwise; val_loss agrees
with the port's own unmeshed run within 2e-6 (``gather``) and 1e-5
(``psum``), and with the reference within the port's 1e-4.  One-round
segments are fully bitwise the unmeshed one-round chain; a same-mesh
resume is bitwise the unbroken segmented run; an uneven batch is padded
and the pads dropped; ``psum`` with N % silo != 0 raises; a checkpoint a
(2, 1) mesh saved resumes unmeshed bitwise.

The ranks import no JAX: the reference runs here, in the test process,
and its draws travel to the ranks as arrays.
"""
import os

import numpy as np
import pytest
import torch

from repro_torch.launch.mesh import (EngineMesh, engine_mesh_shape,
                                     make_engine_mesh, make_host_mesh,
                                     make_production_mesh, run_ranks)
from repro_torch.sharding import rules

ROUNDS, M = 6, 4
SCENARIOS = ("GE", "CLUSTER", "DRIFT", "DEADLINE")
SAMPLERS = ("uniform", "md", "fedgs")
AGGS = ("fedavg", "fedavgm", "fedadam", "memory")
N_CELLS = 8
RANKS_TIMEOUT = 150          # seconds a spawned world may take
DECISIONS = ("sel", "valid", "counts", "gini", "count_var", "val_acc")
FIELDS = DECISIONS + ("val_loss",)


def _cfg(config_cls, **kw):
    return config_cls(**{**dict(rounds=ROUNDS, m=M, local_steps=2,
                                batch_size=8, lr=0.1, eval_every=1,
                                max_sweeps=8, sampler="uniform"), **kw})


def _spec(i):
    """Cell i of the mixed batch: (scenario, sampler, aggregator)."""
    return (SCENARIOS[i % 4], SAMPLERS[(i + i // 4) % len(SAMPLERS)],
            AGGS[(i // 2) % 4])


def _proc_kw(ds, i):
    return dict(n_clients=ds.n_clients, data_sizes=ds.sizes,
                label_sets=ds.label_sets(), num_labels=ds.num_classes,
                rounds=ROUNDS, seed=7 + i)


def _port_cells(eng, ds, h, draws, k=N_CELLS):
    """The port's mixed cells, their draws the reference's (from tables)."""
    from repro_torch.core.availability_device import make_process
    from repro_torch.core.sampler_device import make_sampler_process
    from repro_torch.fed.aggregator_device import make_aggregator_process
    cells = []
    for i in range(k):
        scen, samp, agg = _spec(i)
        d = draws[i]
        cells.append(eng.cell(
            seed=i, process=make_process(scen, **_proc_kw(ds, i)), h=h,
            avail_seed=40 + i,
            sampler_process=make_sampler_process(samp, alpha=1.0),
            aggregator_process=make_aggregator_process(agg),
            init_params=d["init"],
            batch_indices=lambda t, sel, sizes, d=d: d["batch"][t],
            sampler_draws=lambda kind, t, arg, d=d: d["gumbel"][t],
            avail_draws=lambda kind, t, shape, d=d: d["avail"][kind, t]))
    return cells


def _hist(h) -> dict:
    return {f: np.asarray(getattr(h, f)) for f in FIELDS}


def _engine(ds, **kw):
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine
    return ScanEngine(ds, logistic_regression(), _cfg(ScanConfig, **kw),
                      device="cpu")


def _port_ds(n=30):
    from repro_torch.data.synthetic import make_synthetic
    return make_synthetic(n_clients=n, alpha=0.5, beta=0.5, seed=0)


# ------------------------------------------------------------- the ranks
def _mesh_rank(rank, world, job):
    """One rank of a spawned world: every run of ``job`` on its mesh."""
    torch.set_num_threads(1)
    from repro_torch.fed.aggregator_device import make_aggregator_process
    ds, out = _port_ds(), {}
    for name, kw in job["runs"]:
        eng = _engine(ds, mesh=job["mesh"], **kw.get("cfg", {}))
        cells = _port_cells(eng, ds, job["h"], job["draws"])[:kw.get("k", 8)]
        if name == "psum_indivisible":
            odd = _port_ds(31)
            eng = _engine(odd, mesh=job["mesh"], silo_reduce="psum")
            from repro_torch.core.availability_device import make_process
            cell = eng.cell(seed=0, process=make_process(
                "GE", n_clients=31, data_sizes=odd.sizes, rounds=ROUNDS),
                aggregator_process=make_aggregator_process("memory"))
            try:
                eng.run_batch([cell])
                out[name] = "no error"
            except ValueError as e:
                out[name] = str(e)
            continue
        ck = os.path.join(job["dir"], name)
        if name == "segments":
            # the public segment API on a mesh: whole carries in and out
            handle = eng.init_carry(cells)
            handle, first = eng.run_segment(cells, handle, 0, 3)
            handle, second = eng.run_segment(cells, handle, 3, ROUNDS - 3)
            out[name] = (torch.cat([first["sel"], second["sel"]], 1).numpy(),
                         handle.tree["counts"].numpy())
        elif name == "resume":
            seg = eng.run_batch(cells, ckpt_path=ck, ckpt_every=3)
            res = eng.run_batch(cells, ckpt_path=ck, resume=True,
                                ckpt_every=3)
            out[name] = ([_hist(h) for h in seg], [_hist(h) for h in res])
        elif "ckpt_every" in kw:
            out[name] = [_hist(h) for h in eng.run_batch(
                cells, ckpt_path=ck, ckpt_every=kw["ckpt_every"])]
        else:
            out[name] = [_hist(h) for h in eng.run_batch(cells)]
    return out


def _spawn(mesh, runs, reference, tmp_path):
    h, _, draws = reference
    job = {"mesh": mesh, "runs": runs, "h": h, "draws": draws,
           "dir": str(tmp_path)}
    world = mesh[0] * mesh[1]
    out = run_ranks(_mesh_rank, world, (job,),
                    init_file=str(tmp_path / "init"), timeout=RANKS_TIMEOUT)
    # every rank returns the whole batch, the same on every rank
    for other in out[1:]:
        for name in other:
            if isinstance(other[name], list):
                for a, b in zip(other[name], out[0][name]):
                    for f in FIELDS:
                        assert np.array_equal(a[f], b[f], equal_nan=True), \
                            (name, f)
    return out[0]


# ---------------------------------------------------------- the reference
@pytest.fixture(scope="module")
def reference(synthetic_ds):
    """The reference's single-device run_batch of the 8 mixed cells, and
    its draws as tables the ranks replay: (H, histories, draws)."""
    import jax
    import jax.numpy as jnp
    from test_torch_scan import (_idx_program, jax_avail_draws, jax_init,
                                 jax_sampler_draws)

    from repro.core import availability_device as jad
    from repro.core import sampler_device as jsd
    from repro.fed import scan_engine as jse
    from repro.fed.aggregator_device import \
        make_aggregator_process as jax_make_aggregator
    from repro.fed.models import logistic_regression as jax_logreg

    from repro_torch.core.availability_device import make_process
    idx_draw = _idx_program(2, 8)

    def jax_batch_indices(seed):
        """The scan's training keys at E = 2, B = 8 (test_torch_scan's
        derivation)."""
        def draw(t, sel, sizes):
            key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
            _, sub = jax.random.split(key)
            return np.asarray(idx_draw(sub, jnp.asarray(sizes, jnp.int32)),
                              np.int64)
        return draw
    ds = synthetic_ds
    h = np.asarray(jse.oracle_h(ds.opt_params))
    jeng = jse.ScanEngine(ds, jax_logreg(), _cfg(jse.ScanConfig))
    jcells = []
    for i in range(N_CELLS):
        scen, samp, agg = _spec(i)
        jcells.append(jeng.cell(
            seed=i, process=jad.make_process(scen, **_proc_kw(ds, i)), h=h,
            avail_seed=40 + i,
            sampler_process=jsd.make_sampler_process(samp, alpha=1.0),
            aggregator_process=jax_make_aggregator(agg)))
    want = jeng.run_batch(jcells)
    n, draws = ds.n_clients, []
    for i, w in enumerate(want):
        dist = make_process(_spec(i)[0], **_proc_kw(ds, i)).draw_dist
        av = jax_avail_draws(dist, 40 + i, n)
        bi = jax_batch_indices(i)
        gu = jax_sampler_draws(i + 0x5E1EC7)
        avail = {("init", None): av("init", None, (n,))}
        for t in range(ROUNDS):
            avail["u", t] = av("u", t, (n,))
            avail["force", t] = av("force", t, ())
            if dist is not None:
                avail["step", t] = av("step", t, (n,))
        sel = np.asarray(w.sel)
        draws.append({
            "init": jax_init(i), "avail": avail,
            "batch": [bi(t, sel[t], ds.sizes[sel[t]]) for t in range(ROUNDS)],
            "gumbel": [gu("gumbel", t, (n,)) for t in range(ROUNDS)]})
    return h, [_hist(w) for w in want], draws


@pytest.fixture(scope="module")
def unmeshed(reference):
    """The port's own single-device run of the same cells."""
    h, _, draws = reference
    ds = _port_ds()
    eng = _engine(ds)
    return [_hist(x) for x in eng.run_batch(_port_cells(eng, ds, h, draws))]


def _decisions_equal(got, want, msg):
    for f in DECISIONS:
        assert np.array_equal(got[f], want[f]), f"{msg}: {f}"


def _check(got, reference, unmeshed, loss_tol, msg):
    """Sets, pad masks and counts bitwise the reference's; every decision
    bitwise and val_loss within ``loss_tol`` of the port's unmeshed run
    (the mesh contract); the float metrics within the port's own contract
    against the reference (test_torch_scan: XLA and torch round the
    fairness sums differently in the last ulp)."""
    _, want, _ = reference
    assert len(got) == len(want)
    for i, (g, w, u) in enumerate(zip(got, want, unmeshed)):
        for f in ("sel", "valid", "counts"):
            assert np.array_equal(g[f], w[f]), f"{msg} cell {i}: {f}"
        _decisions_equal(g, u, f"{msg} cell {i} vs unmeshed")
        np.testing.assert_allclose(g["val_loss"], u["val_loss"],
                                   atol=loss_tol, err_msg=f"{msg} cell {i}")
        np.testing.assert_allclose(g["val_loss"], w["val_loss"], atol=1e-4,
                                   err_msg=f"{msg} cell {i} vs reference")
        for f in ("gini", "count_var"):
            np.testing.assert_allclose(g[f], w[f], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{msg} cell {i}: {f}")


# ------------------------------------------------------------------ tests
def test_mesh_2x1(reference, unmeshed, tmp_path):
    """(2, 1): the 8 mixed cells, one-round segments, a same-mesh resume,
    an uneven batch of 5, init_carry + run_segment (whole carries on every
    rank); then the (2, 1) checkpoint resumed unmeshed."""
    out = _spawn((2, 1), [("batch", {}), ("seg1", {"ckpt_every": 1}),
                          ("resume", {}), ("uneven", {"k": 5}),
                          ("segments", {})],
                 reference, tmp_path)
    whole = unmeshed
    _check(out["batch"], reference, whole, 2e-6, "(2, 1) gather")
    sel, counts = out["segments"]
    assert np.array_equal(sel, np.stack([h["sel"] for h in out["batch"]]))
    assert np.array_equal(counts, np.stack([h["counts"]
                                            for h in out["batch"]]))
    # one-round segments chain bitwise (every field) with the unmeshed chain
    h, _, draws = reference
    ds = _port_ds()
    eng = _engine(ds)
    cells = _port_cells(eng, ds, h, draws)
    chain = [_hist(x) for x in eng.run_batch(
        cells, ckpt_path=str(tmp_path / "one"), ckpt_every=1)]
    for i, (g, w) in enumerate(zip(out["seg1"], chain)):
        for f in FIELDS:
            assert np.array_equal(g[f], w[f], equal_nan=True), (i, f)
    seg, res = out["resume"]
    for i, (a, b) in enumerate(zip(seg, res)):
        for f in FIELDS:
            assert np.array_equal(a[f], b[f], equal_nan=True), (i, f)
    assert len(out["uneven"]) == 5
    _check(out["uneven"], (None, reference[1][:5], None), whole[:5], 2e-6,
           "(2, 1) uneven")
    # the (2, 1) run's last checkpoint (round 5) resumed on no mesh
    res = [_hist(x) for x in _engine(ds).run_batch(
        _port_cells(eng, ds, h, draws), ckpt_path=str(tmp_path / "seg1"),
        resume=True, ckpt_every=1)]
    for i, (g, w) in enumerate(zip(res, chain)):
        for f in FIELDS:
            assert np.array_equal(g[f], w[f], equal_nan=True), (i, f)


def test_mesh_1x2_gather_and_psum(reference, unmeshed, tmp_path):
    """(1, 2): silo-split training (M = 4 over 2 ranks), gather and psum;
    psum with N = 31 over silo 2 raises."""
    out = _spawn((1, 2), [("gather", {}),
                          ("psum", {"cfg": {"silo_reduce": "psum"}}),
                          ("psum_indivisible", {})],
                 reference, tmp_path)
    whole = unmeshed
    _check(out["gather"], reference, whole, 2e-6, "(1, 2) gather")
    _check(out["psum"], reference, whole, 1e-5, "(1, 2) psum")
    assert "must divide by silo=2" in out["psum_indivisible"]


def test_mesh_2x2_gather_and_psum(reference, unmeshed, tmp_path):
    """(2, 2) over 4 ranks: M = 4 with M % silo == 0, cells and silo
    together, gather and psum."""
    out = _spawn((2, 2), [("gather", {}),
                          ("psum", {"cfg": {"silo_reduce": "psum"}})],
                 reference, tmp_path)
    whole = unmeshed
    _check(out["gather"], reference, whole, 2e-6, "(2, 2) gather")
    _check(out["psum"], reference, whole, 1e-5, "(2, 2) psum")


def _pad_rank(rank, world, m):
    """Silo chunks with M % silo != 0 (M = 3 over 2 ranks: a pad slot)."""
    torch.set_num_threads(1)
    ds = _port_ds()
    from repro_torch.core.availability_device import make_process
    out = []
    for mesh in ((1, 2), None):
        eng = _engine(ds, mesh=mesh, m=m) if mesh else _engine(ds, m=m)
        cells = [eng.cell(seed=s, process=make_process(
            "GE", n_clients=30, data_sizes=ds.sizes, rounds=ROUNDS,
            seed=3 + s), avail_seed=50 + s) for s in range(2)]
        out.append([_hist(h) for h in eng.run_batch(cells)])
    return out


def test_silo_chunks_with_a_pad_slot(tmp_path):
    """M = 3 over silo 2: each rank trains ceil(3/2) = 2 slots (the last
    one padded), the gathered updates are the unsplit ones, bitwise."""
    out = run_ranks(_pad_rank, 2, (3,), init_file=str(tmp_path / "init"),
                    timeout=RANKS_TIMEOUT)
    meshed, single = out[0]
    for a, b in zip(meshed, single):
        for f in FIELDS:
            assert np.array_equal(a[f], b[f], equal_nan=True), f


# --------------------------------------------------- no process group
def test_engine_mesh_shape_and_errors():
    assert engine_mesh_shape((4,)) == (4, 1)
    assert engine_mesh_shape([2, 3]) == (2, 3)
    for bad in ((0,), (2, 0), (1, 2, 3)):
        with pytest.raises(ValueError):
            engine_mesh_shape(bad)
    with pytest.raises(RuntimeError, match="initialized"):
        make_engine_mesh((2, 1))
    prod = make_production_mesh()
    assert (prod.shape, prod.axis_names) == ((16, 16), ("data", "model"))
    mesh = make_host_mesh("cpu")
    assert mesh.shape == (1,) and mesh.axis_names == ("data",)


def _world_rank(rank, world, shape):
    m = make_engine_mesh(shape)
    t = torch.arange(3, dtype=torch.float32) + 10 * rank
    return (m.rank, m.cell_rank, m.silo_rank, m.all_gather_silo(t).tolist(),
            m.all_reduce_silo(t).tolist(), m.gather_objects(rank))


def test_make_engine_mesh_layout(tmp_path):
    """rank = c·silo + s, row-major; silo collectives stay in the row."""
    out = run_ranks(_world_rank, 4, ((2, 2),),
                    init_file=str(tmp_path / "init"), timeout=RANKS_TIMEOUT)
    for r, (rank, c, s, gathered, summed, objs) in enumerate(out):
        assert (rank, c, s) == (r, r // 2, r % 2)
        row = [2 * c, 2 * c + 1]
        assert gathered == [x + 10 * q for q in row for x in range(3)]
        assert summed == [2 * x + 10 * sum(row) for x in range(3)]
        assert objs == [0, 1, 2, 3]


def _wrong_world_rank(rank, world):
    try:
        make_engine_mesh((2, 2))
    except RuntimeError as e:
        return str(e)
    return "no error"


def test_make_engine_mesh_rejects_a_wrong_world(tmp_path):
    out = run_ranks(_wrong_world_rank, 2, (), init_file=str(
        tmp_path / "init"), timeout=RANKS_TIMEOUT)
    assert all("needs 4 ranks, the world has 2" in e for e in out)


def test_rules_specs_against_the_reference():
    """The engine rules: the reference's axis names; the batch spec; the
    memory panel split into rows only under psum."""
    from repro.sharding import rules as jrules
    assert rules.ENGINE_CELL_AXIS == jrules.ENGINE_CELL_AXIS
    assert rules.ENGINE_SILO_AXIS == jrules.ENGINE_SILO_AXIS
    assert rules.engine_batch_spec() == tuple(jrules.engine_batch_spec())
    assert rules.engine_batch_spec(False) == tuple(
        jrules.engine_batch_spec(False))
    tree = {"params": {"w": torch.zeros(2, 3)}, "counts": torch.zeros(2, 5),
            "agg": {0: {"mem": torch.zeros(5, 7), "tau": torch.zeros(5)}},
            "h": [None, torch.zeros(5, 5)]}
    specs = rules.engine_carry_specs(tree, panel_sharded=True)
    assert specs["agg"][0]["mem"] == ("cells", "silo")
    assert specs["agg"][0]["tau"] == ("cells",)
    assert specs["h"] == [None, ("cells",)]
    plain = rules.engine_carry_specs(tree, cell_sharding=False)
    assert plain["agg"][0]["mem"] == () and plain["counts"] == ()


def test_run_ranks_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        run_ranks(_failing_rank, 2, (), init_file=str(tmp_path / "init"),
                  timeout=RANKS_TIMEOUT)


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("boom")
    return rank


@pytest.mark.parametrize("fn", [_world_rank, _failing_rank],
                         ids=["returns", "raises"])
def test_run_ranks_leaves_no_process(tmp_path, fn):
    """Whether the world returns or raises, the ranks and the resource
    tracker that spawning them started have all ended."""
    import multiprocessing as mp
    from multiprocessing import resource_tracker

    args = ((2, 1),) if fn is _world_rank else ()
    try:
        run_ranks(fn, 2, args, init_file=str(tmp_path / "init"),
                  timeout=RANKS_TIMEOUT)
    except RuntimeError:
        assert fn is _failing_rank
    assert mp.active_children() == []
    assert resource_tracker._resource_tracker._pid is None


def test_engine_mesh_without_a_group_is_local():
    """A (1, 1) mesh needs no collective: every call is the identity."""
    m = EngineMesh(shape=(1, 1), rank=0, cell_rank=0, silo_rank=0,
                   silo_group=None, world_group=None, backend="gloo")
    t = torch.arange(4.0)
    assert m.all_gather_silo(t) is t and m.all_reduce_silo(t) is t
    assert m.gather_objects("x") == ["x"]
    m.barrier()
