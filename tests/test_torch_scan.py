"""The port's batched sweep engine (``repro_torch.fed.scan_engine``) and its
sampler processes against ``repro.fed.scan_engine`` on the CPU.

Contract: with the reference's draws handed in through the seams (init
params, batch indices for the padded ``sel``, the availability, Gumbel and
probe draws), each port cell selects the reference's set in every round
and ends with its counts, and val_loss agrees within 1e-4 — against the
reference's PER-CELL ``eng.run(cell)`` (its mixed batches do not equal its
per-cell runs: ROADMAP Queue C).  The dynamic 3DG: H at each refresh within
rtol 1e-4 with the same disconnected pattern.  With the port's own draws:
``run_batch`` is bitwise its own per-cell runs, and ``run_segment`` splits
are bitwise the whole run.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import availability_device as jad
from repro.core import sampler_device as jsd
from repro.core.availability import make_mode as jax_make_mode
from repro.fed import scan_engine as jse
from repro.fed.aggregator_device import \
    make_aggregator_process as jax_make_aggregator
from repro.fed.faults_device import make_fault_process as jax_make_fault
from repro.fed.models import logistic_regression as jax_logreg

from repro_torch.core import availability_device as tad
from repro_torch.core import sampler_device as tsd
from repro_torch.core.availability import make_mode
from repro_torch.fed import scan_engine as tse
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.faults_device import make_fault_process
from repro_torch.fed.models import logistic_regression

ROUNDS, M, E, B = 8, 6, 5, 10


def _cfg(mod, rounds=ROUNDS, **kw):
    return mod.ScanConfig(rounds=rounds, m=M, local_steps=E, batch_size=B,
                          lr=0.1, eval_every=1, max_sweeps=16, **kw)


def _mode(make, name, ds):
    return make(name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                label_sets=ds.label_sets(), num_labels=ds.num_classes, seed=7)


# ------------------------------------------------ the reference's draws
def jax_init(seed):
    return jax.tree_util.tree_map(
        np.asarray, jax_logreg().init(jax.random.PRNGKey(seed)))


def _idx_program(local_steps, batch_size):
    def one(ck, nk):
        return jax.vmap(lambda sk: jax.random.randint(
            sk, (batch_size,), 0, jnp.maximum(nk, 1)))(
                jax.random.split(ck, local_steps))

    @jax.jit
    def draw(key, sizes):
        return jax.vmap(one)(jax.random.split(key, sizes.shape[0]), sizes)
    return draw


_draw_idx = _idx_program(E, B)


def jax_batch_indices(seed):
    """The scan's training keys: fold_in(PRNGKey(seed), t) -> split ->
    split(sub, M) -> split(client, E) -> randint(·, (B,), 0, max(n_k, 1))."""
    def draw(t, sel, sizes):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        _, sub = jax.random.split(key)
        return np.asarray(_draw_idx(sub, jnp.asarray(sizes, jnp.int32)),
                          np.int64)
    return draw


def jax_sampler_draws(sampler_seed, poc_probe=64):
    """Gumbel noise on fold_in(sampler_key, t); the PoC probe on
    split(fold_in(·, 1), d), one randint per candidate."""
    def draws(kind, t, arg):
        skey = jax.random.fold_in(jax.random.PRNGKey(sampler_seed), t)
        if kind == "gumbel":
            return np.asarray(jax.random.gumbel(skey, arg, jnp.float32))
        keys = jax.random.split(jax.random.fold_in(skey, 1), len(arg))
        return np.stack([np.asarray(jax.random.randint(
            k, (poc_probe,), 0, max(int(nk), 1))) for k, nk in zip(keys, arg)])
    return draws


def jax_avail_draws(dist, avail_seed, n):
    key = jax.random.PRNGKey(avail_seed)

    def sample(k, shape):
        fn = jax.random.uniform if dist == "uniform" else jax.random.normal
        return np.asarray(fn(k, shape))

    def draws(kind, t, shape):
        if kind == "init":
            return sample(key, shape)
        akey = jax.random.fold_in(key, t)
        if kind == "u":
            return np.asarray(jax.random.uniform(akey, shape))
        if kind == "force":
            return np.asarray(jax.random.randint(
                jax.random.fold_in(akey, 1), (), 0, n))
        return sample(jax.random.fold_in(akey, 2), shape)
    return draws


def seams(seed):
    return {"init_params": jax_init(seed),
            "batch_indices": jax_batch_indices(seed),
            "sampler_draws": jax_sampler_draws(seed + 0x5E1EC7)}


def _same_run(th, jh, loss_atol=1e-4):
    """Sets and counts identical, val_loss within loss_atol."""
    assert th.sel.shape == jh.sel.shape
    for t in range(th.sel.shape[0]):
        assert th.sampled(t).tolist() == jh.sampled(t).tolist(), f"round {t}"
    assert np.array_equal(th.valid, np.asarray(jh.valid))
    assert np.array_equal(th.counts, np.asarray(jh.counts))
    np.testing.assert_allclose(th.val_loss, jh.val_loss, atol=loss_atol)
    np.testing.assert_allclose(th.count_var, jh.count_var, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(th.gini, jh.gini, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def h_ref(synthetic_ds):
    return np.asarray(jse.oracle_h(synthetic_ds.opt_params))


# ---------------------------------------------- masks: all four samplers
SAMPLER_CELLS = [("fedgs", 1.0, 3), ("fedgs", 2.0, 4), ("uniform", 1.0, 5),
                 ("md", 1.0, 6), ("poc", 1.0, 7)]


@pytest.fixture(scope="module")
def mask_runs(synthetic_ds, h_ref):
    ds = synthetic_ds
    masks = jse.precompute_masks(_mode(jax_make_mode, "LN", ds), ROUNDS, 11)
    jeng = jse.ScanEngine(ds, jax_logreg(), _cfg(jse), use_masks=True)
    want = [jeng.run(jeng.cell(
        seed=seed, masks=masks, alpha=alpha, h=h_ref,
        sampler_process=jsd.make_sampler_process(name, alpha=alpha)))
        for name, alpha, seed in SAMPLER_CELLS]
    teng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse),
                          use_masks=True, device="cpu")
    tmasks = tse.precompute_masks(_mode(make_mode, "LN", ds), ROUNDS, 11)
    assert np.array_equal(tmasks, masks)
    cells = [teng.cell(seed=seed, masks=tmasks, alpha=alpha, h=h_ref,
                       sampler_process=tsd.make_sampler_process(
                           name, alpha=alpha), **seams(seed))
             for name, alpha, seed in SAMPLER_CELLS]
    return want, teng.run_batch(cells), masks


@pytest.mark.parametrize("k", range(len(SAMPLER_CELLS)),
                         ids=[f"{n}-{a}" for n, a, _ in SAMPLER_CELLS])
def test_mask_cells_vs_reference(mask_runs, k):
    want, got, masks = mask_runs
    _same_run(got[k], want[k])
    for t in range(ROUNDS):
        s = got[k].sampled(t)
        assert set(s) <= set(np.flatnonzero(masks[t]))
        assert len(s) == min(M, int(masks[t].sum()))


# --------------------------------- FedGS on each device availability family
DEVICE_FAMILIES = [("LN", {}), ("GE", {"mean_on": 6.0, "mean_off": 3.0}),
                   ("CLUSTER", {"n_clusters": 3, "floor": 0.1}),
                   ("DRIFT", {}), ("DEADLINE", {"deadline": 1.1})]


def _procs(make_process, ds, name, kw):
    return make_process(name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                        label_sets=ds.label_sets(),
                        num_labels=ds.num_classes, seed=5, rounds=ROUNDS,
                        **kw)


@pytest.fixture(scope="module")
def device_runs(synthetic_ds, h_ref):
    ds = synthetic_ds
    jeng = jse.ScanEngine(ds, jax_logreg(), _cfg(jse))
    teng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse), device="cpu")
    want, cells = [], []
    for k, (name, kw) in enumerate(DEVICE_FAMILIES):
        seed, aseed = 20 + k, 40 + k
        want.append(jeng.run(jeng.cell(
            seed=seed, process=_procs(jad.make_process, ds, name, kw),
            avail_seed=aseed, h=h_ref)))
        proc = _procs(tad.make_process, ds, name, kw)
        cells.append(teng.cell(
            seed=seed, process=proc, avail_seed=aseed, h=h_ref,
            avail_draws=jax_avail_draws(proc.draw_dist, aseed, ds.n_clients),
            **seams(seed)))
    return want, teng.run_batch(cells)


@pytest.mark.parametrize("k", range(len(DEVICE_FAMILIES)),
                         ids=[n for n, _ in DEVICE_FAMILIES])
def test_fedgs_on_device_family_vs_reference(device_runs, k):
    want, got = device_runs
    _same_run(got[k], want[k])


# ------------------------------------ memory, and Krum under sign-flip
ROBUST = {"memory": (lambda m: m("memory", gamma=0.9), None),
          "krum_sign_flip": (lambda m: m("multikrum", krum_f=1, krum_multi=3),
                             {"frac": 0.2, "scale": 5.0})}


@pytest.fixture(scope="module")
def robust_runs(synthetic_ds, h_ref):
    ds = synthetic_ds
    masks = jse.precompute_masks(_mode(jax_make_mode, "LN", ds), ROUNDS, 13)
    out = {}
    for k, (name, (agg, attack)) in enumerate(ROBUST.items()):
        seed = 30 + k
        jeng = jse.ScanEngine(ds, jax_logreg(), _cfg(jse), use_masks=True)
        jfault = jax_make_fault("sign_flip", ds.n_clients, **attack) \
            if attack else None
        want = jeng.run(jeng.cell(seed=seed, masks=masks, h=h_ref,
                                  aggregator_process=agg(jax_make_aggregator),
                                  fault_process=jfault))
        teng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse),
                              use_masks=True, device="cpu")
        tfault = make_fault_process("sign_flip", ds.n_clients, **attack) \
            if attack else None
        got = teng.run(teng.cell(seed=seed, masks=masks, h=h_ref,
                                 aggregator_process=agg(
                                     make_aggregator_process),
                                 fault_process=tfault, **seams(seed)))
        out[name] = (want, got)
    return out


@pytest.mark.parametrize("name", list(ROBUST))
def test_robust_cells_vs_reference(robust_runs, name):
    want, got = robust_runs[name]
    _same_run(got, want)
    assert (got.chosen is not None) == name.startswith("krum")
    if got.chosen is not None:
        assert got.chosen.shape == (ROUNDS, M)
        assert np.all(got.chosen.sum(1) == 3)
        assert not np.any(got.chosen & ~got.valid)


# ------------------------------------------------------- dynamic 3DG
# sigma2 = 0.02 keeps every edge weight exp(-Vn/sigma2) >= e^-50, a normal
# float32: at the default 0.01 some fall under 1.2e-38, which XLA:CPU
# flushes to zero and torch keeps, and H parts (ROADMAP Queue C)
REFRESH, DYN_ROUNDS, SIGMA2 = 3, 9, 0.02
DYN_CELLS = {"uniform": 1, "fedgs": 2}


def _key_indices(key, sizes):
    return np.asarray(_draw_idx(key, jnp.asarray(sizes, jnp.int32)),
                      np.int64)


@pytest.fixture(scope="module")
def dynamic_runs(synthetic_ds):
    """Per sampler: the reference's and the port's carried H after the
    probe round and after every refresh, and the sets."""
    ds = synthetic_ds
    masks = jse.precompute_masks(_mode(jax_make_mode, "IDL", ds),
                                 DYN_ROUNDS, 3)
    cfg_kw = dict(rounds=DYN_ROUNDS, graph_refresh_every=REFRESH,
                  graph_sigma2=SIGMA2)
    jeng = jse.ScanEngine(ds, jax_logreg(), _cfg(jse, **cfg_kw),
                          use_masks=True)
    teng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse, **cfg_kw),
                          use_masks=True, device="cpu")
    out = {}
    for name, seed in DYN_CELLS.items():
        jcell = jeng.cell(seed=seed, masks=masks,
                          sampler_process=jsd.make_sampler_process(name))
        handle = jeng.init_carry([jcell])
        jh, jsel = [np.asarray(handle.tree["h"][0])], []
        for t0 in range(0, DYN_ROUNDS, REFRESH):
            handle, traj = jeng.run_segment([jcell], handle, t0, REFRESH)
            jh.append(np.asarray(handle.tree["h"][0]))
            jsel.append(np.asarray(traj["sel"][0]))
        ikey = jax.random.PRNGKey(seed + 778)
        tcell = teng.cell(seed=seed, masks=masks,
                          sampler_process=tsd.make_sampler_process(name),
                          graph_init_params=jax_init(seed + 778),
                          graph_batch_indices=_key_indices(ikey, ds.sizes),
                          **seams(seed))
        carry = teng.init_carry([tcell])
        th, tsel = [carry.tree["h"][0].numpy()], []
        for t0 in range(0, DYN_ROUNDS, REFRESH):
            carry, traj = teng.run_segment([tcell], carry, t0, REFRESH)
            th.append(carry.tree["h"][0].numpy())
            tsel.append(traj["sel"][0].numpy())
        out[name] = {"jh": jh, "jsel": np.concatenate(jsel), "th": th,
                     "tsel": np.concatenate(tsel), "cell": tcell}
    out["engine"], out["masks"] = teng, masks
    return out


def _h_close(got, want):
    # normalized H: a disconnected pair sits at the maximum, 1
    assert np.array_equal(got == got.max(), want == want.max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_dynamic_3dg_h_at_each_refresh(dynamic_runs):
    """A uniform cell's sets do not read H, so its participants and their
    re-embeddings are the reference's: H after the probe round and after
    each of the three rebuilds within rtol 1e-4."""
    run = dynamic_runs["uniform"]
    assert np.array_equal(run["tsel"], run["jsel"])
    assert len(run["th"]) == len(run["jh"]) == 1 + DYN_ROUNDS // REFRESH
    for got, want in zip(run["th"], run["jh"]):
        _h_close(got, want)
    assert not np.array_equal(run["th"][0], run["th"][-1])


def test_dynamic_3dg_fedgs_solver_contract(dynamic_runs, synthetic_ds):
    """A FedGS cell on the dynamic 3DG: the probe round's H within rtol
    1e-4, and given the reference's H the port's solve picks the
    reference's round-0 set.  (Over the run the sets may part at a
    near-tie that H's round-off decides: ROADMAP Queue C.)"""
    run = dynamic_runs["fedgs"]
    _h_close(run["th"][0], run["jh"][0])
    n = synthetic_ds.n_clients
    s = tsd.fedgs_select(torch.as_tensor(run["jh"][0]), torch.zeros(n),
                         torch.ones(n, dtype=torch.bool), 1.0, m=M,
                         max_sweeps=16)
    assert np.flatnonzero(s.numpy()).tolist() == run["jsel"][0].tolist()
    # and the port's own run on its own H: the solve it did at round 0
    s = tsd.fedgs_select(torch.as_tensor(run["th"][0]), torch.zeros(n),
                         torch.ones(n, dtype=torch.bool), 1.0, m=M,
                         max_sweeps=16)
    assert np.flatnonzero(s.numpy()).tolist() == run["tsel"][0].tolist()


# -------------------------------------------------- the port's own draws
def _own_cells(eng, ds, h):
    ln = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)
    n = ds.n_clients
    return [
        eng.cell(seed=0, mode=ln, h=h),
        eng.cell(seed=1, process=tad.GilbertElliott(n, mean_on=6, mean_off=3),
                 sampler_process=tsd.make_sampler_process("uniform")),
        eng.cell(seed=2, process=tad.make_process("CLUSTER", n_clients=n),
                 sampler_process=tsd.make_sampler_process("md"),
                 aggregator_process=make_aggregator_process("memory")),
        eng.cell(seed=3, process=tad.make_process(
            "DRIFT", n_clients=n, data_sizes=ds.sizes, rounds=ROUNDS),
            sampler_process=tsd.make_sampler_process("poc")),
        eng.cell(seed=4, process=tad.DeadlineProcess(n, deadline=1.2), h=h,
                 aggregator_process=make_aggregator_process(
                     "multikrum", krum_f=1, krum_multi=3),
                 fault_process=make_fault_process("sign_flip", n, frac=0.2,
                                                  scale=5.0)),
        eng.cell(seed=5, mode=ln, h=h,
                 fault_process=make_fault_process("gaussian_noise", n),
                 aggregator_process=make_aggregator_process("median")),
        eng.cell(seed=6, mode=ln, h=h, alpha=0.5,
                 fault_process=make_fault_process("straggler_stale", n),
                 aggregator_process=make_aggregator_process("fedadam")),
    ]


def _bitwise(a, b):
    for f in ("val_loss", "val_acc", "count_var", "gini", "sel", "valid",
              "counts"):
        assert np.array_equal(getattr(a, f), getattr(b, f), equal_nan=True), f
    assert (a.chosen is None) == (b.chosen is None)
    if a.chosen is not None:
        assert np.array_equal(a.chosen, b.chosen)


def test_run_batch_bitwise_per_cell_runs(synthetic_ds, h_ref):
    ds = synthetic_ds
    eng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse), device="cpu")
    cells = _own_cells(eng, ds, h_ref)
    batch = eng.run_batch(cells)
    assert all(np.isfinite(h.val_loss).all() for h in batch)
    for cell, got in zip(cells, batch):
        _bitwise(got, eng.run(cell))
    # a reordered sub-batch: the same trajectories
    sub = eng.run_batch([cells[4], cells[0], cells[2]])
    for got, k in zip(sub, (4, 0, 2)):
        _bitwise(got, batch[k])


@pytest.mark.parametrize("layout", ["interleaved", "fedgs_last"])
def test_fedgs_cells_solve_together_as_alone(synthetic_ds, h_ref,
                                            monkeypatch, layout):
    """FedGS cells at two alphas (one with an H of its own) beside uniform
    cells: the batch's one FedGS solve a round gives each cell the sets
    and counts of its own run, and of a run whose FedGS cells each take the
    per-step route (``_select_steps``)."""
    ds, n = synthetic_ds, synthetic_ds.n_clients
    eng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse), device="cpu")
    ln = make_mode("LN", n_clients=n, beta=0.5, seed=99)
    h2 = np.array(h_ref, copy=True)
    h2[:5, :5] = 0.5 * h2[:5, :5]
    specs = [("fedgs", 1.0, h_ref), ("uniform", 1.0, None),
             ("fedgs", 0.5, h_ref), ("uniform", 1.0, None),
             ("fedgs", 2.0, h2)]
    if layout == "fedgs_last":
        specs = specs[1::2] + specs[0::2]
    cells = [eng.cell(seed=10 + i, mode=ln, alpha=alpha, h=h,
                      sampler_process=tsd.make_sampler_process(
                          name, alpha=alpha))
             for i, (name, alpha, h) in enumerate(specs)]
    batch = eng.run_batch(cells)
    for cell, got in zip(cells, batch):
        one = eng.run(cell)
        assert np.array_equal(got.sel, one.sel)
        assert np.array_equal(got.counts, one.counts)

    def per_step(h, counts, avail, alphas, *, m, max_sweeps, scales=None):
        z = tsd.balance_z(counts, m)
        return torch.stack([tsd._select_steps(
            h[i].float(), z[i], tsd._f32_ratio(alphas[i], n), avail[i], m=m,
            max_sweeps=max_sweeps) for i in range(len(alphas))])

    monkeypatch.setattr(tse, "fedgs_select_cells", per_step)
    eng2 = tse.ScanEngine(ds, logistic_regression(), _cfg(tse),
                          device="cpu")
    cells2 = [eng2.cell(seed=10 + i, mode=ln, alpha=alpha, h=h,
                        sampler_process=tsd.make_sampler_process(
                            name, alpha=alpha))
              for i, (name, alpha, h) in enumerate(specs)]
    for got, want in zip(batch, eng2.run_batch(cells2)):
        assert np.array_equal(got.sel, want.sel)
        assert np.array_equal(got.counts, want.counts)
    assert any(not np.array_equal(batch[i].sel, batch[j].sel)
               for i in range(len(specs)) for j in range(i))


def test_segments_bitwise_whole_run(synthetic_ds, h_ref):
    ds = synthetic_ds
    eng = tse.ScanEngine(ds, logistic_regression(), _cfg(tse), device="cpu")
    cells = _own_cells(eng, ds, h_ref)[:5]
    whole = eng.run_batch(cells)
    carry = eng.init_carry(cells)
    carry, a = eng.run_segment(cells, carry, 0, 3)
    carry, b = eng.run_segment(cells, carry, 3, ROUNDS - 3)
    for i, h in enumerate(whole):
        assert np.array_equal(torch.cat([a["sel"][i], b["sel"][i]]).numpy(),
                              h.sel)
        assert np.array_equal(torch.cat([a["val_loss"][i],
                                         b["val_loss"][i]]).numpy(),
                              h.val_loss)
        assert np.array_equal(carry.tree["counts"][i].numpy(), h.counts)
    seg = eng.run_batch(cells, ckpt_every=3)
    for x, y in zip(seg, whole):
        _bitwise(x, y)


def test_dynamic_batch_bitwise_per_cell(dynamic_runs):
    teng, masks = dynamic_runs["engine"], dynamic_runs["masks"]
    other = teng.cell(seed=9, masks=masks,
                      sampler_process=tsd.make_sampler_process("md"))
    fedgs = dynamic_runs["fedgs"]
    batch = teng.run_batch([other, fedgs["cell"],
                            dynamic_runs["uniform"]["cell"]])
    assert np.array_equal(batch[1].sel, fedgs["tsel"])
    assert np.array_equal(batch[2].sel, dynamic_runs["uniform"]["tsel"])
    _bitwise(batch[0], teng.run(other))


def test_eval_cadence_and_history(synthetic_ds, h_ref):
    ds = synthetic_ds
    eng = tse.ScanEngine(ds, logistic_regression(),
                         tse.ScanConfig(rounds=7, m=M, local_steps=2,
                                        batch_size=5, eval_every=3,
                                        sampler="uniform"), device="cpu")
    h = eng.run(eng.cell(seed=0, mode=make_mode(
        "IDL", n_clients=ds.n_clients)))
    assert h.rounds.tolist() == [0, 3, 6]
    assert np.isnan(h.val_loss[1]) and np.isfinite(h.best_loss)
    assert h.counts.sum() == 7 * M and h.sel.dtype == np.int32


def test_stack_cells_pads_tables(synthetic_ds):
    ds = synthetic_ds
    eng = tse.ScanEngine(ds, logistic_regression(),
                         _cfg(tse, sampler="uniform"), device="cpu")
    cells = [eng.cell(seed=0, mode=_mode(make_mode, "LN", ds)),      # P = 1
             eng.cell(seed=1, mode=_mode(make_mode, "YC", ds))]      # P = 20
    stacked = tse.stack_cells(cells)
    assert stacked["proc"]["table"].shape[:2] == (2, 20)
    assert stacked["proc"]["table_b"].shape[:2] == (2, 20)
    assert stacked["proc"]["period"].tolist() == [1, 20]
    assert torch.equal(stacked["proc"]["table"][0, 1:],
                       torch.zeros(19, ds.n_clients))
    assert all(np.isfinite(h.val_loss).all() for h in eng.run_batch(cells))


# ------------------------------------------------------ sampler processes
@pytest.mark.parametrize("family", ["uniform", "md", "poc"])
@pytest.mark.parametrize("n_avail", [3, 12, 30])
def test_sampler_step_bitwise_given_the_draws(synthetic_ds, family, n_avail):
    ds, n, m = synthetic_ds, synthetic_ds.n_clients, 5
    rng = np.random.default_rng(n_avail)
    avail = np.zeros(n, bool)
    avail[rng.permutation(n)[:n_avail]] = True
    losses = rng.normal(size=n).astype(np.float32)
    d = min(n, 2 * m)
    jstep = jsd.make_sampler_step(n, m, d_cand=d)
    tstep = tsd.make_sampler_step(n, m, family=family, d_cand=d)
    jproc = jsd.make_sampler_process(family)
    tproc = tsd.make_sampler_process(family)
    for t in range(4):
        key = jax.random.fold_in(jax.random.PRNGKey(3), t)
        want, _ = jstep(jproc.params(data_sizes=ds.sizes), {}, key,
                        {"h": jnp.zeros((n, n)), "counts": jnp.zeros(n),
                         "losses": jnp.asarray(losses), "params": ()},
                        jnp.asarray(avail), t)
        got, _ = tstep(tproc.params(data_sizes=ds.sizes), {},
                       {"losses": torch.as_tensor(losses)},
                       torch.as_tensor(avail), t,
                       gumbel=torch.as_tensor(np.asarray(
                           jax.random.gumbel(key, (n,), jnp.float32))))
        assert np.array_equal(got.numpy(), np.asarray(want))
        assert int(got.sum()) == min(m, n_avail)


def test_sampler_process_params_and_fedgs_step(synthetic_ds, h_ref):
    ds, n = synthetic_ds, synthetic_ds.n_clients
    for name in tsd.FAMILIES:
        jp = jsd.make_sampler_process(name, alpha=0.7).params(
            data_sizes=ds.sizes)
        tp = tsd.make_sampler_process(name, alpha=0.7).params(
            data_sizes=ds.sizes)
        assert tp["family"] == int(jp["family"])
        assert np.float32(tp["alpha"]) == np.asarray(jp["alpha"])
        assert np.array_equal(tp["log_sizes"].numpy(),
                              np.asarray(jp["log_sizes"]))
    counts = np.arange(n) % 3
    avail = np.ones(n, bool)
    avail[::4] = False
    want, _ = jsd.FedGSProcess(alpha=1.5).select(
        {}, jax.random.PRNGKey(0), {"h": jnp.asarray(h_ref), "counts": jnp.asarray(
            counts, jnp.float32)}, jnp.asarray(avail), 0, m=6, max_sweeps=16)
    got, _ = tsd.FedGSProcess(alpha=1.5).select(
        {}, {"h": torch.as_tensor(h_ref), "counts": torch.as_tensor(
            counts, dtype=torch.float32)}, torch.as_tensor(avail), 0, m=6,
        max_sweeps=16)
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError, match="Gumbel"):
        tsd.UniformProcess().select({}, {}, torch.as_tensor(avail), 0, m=3)
    with pytest.raises(ValueError):
        tsd.make_sampler_process("nope")


def test_gumbel_topk_over_a_cell_axis_equals_rows():
    gen = torch.Generator().manual_seed(0)
    avail = torch.rand(4, 25, generator=gen) < 0.4
    lw = torch.randn(4, 25, generator=gen)
    g = tsd.gumbel_noise(gen, (4, 25))
    s = tsd.gumbel_topk_select(None, lw, avail, 6, gumbel=g)
    for i in range(4):
        assert torch.equal(s[i], tsd.gumbel_topk_select(None, lw[i], avail[i],
                                                        6, gumbel=g[i]))
        assert int(s[i].sum()) == min(6, int(avail[i].sum()))
        assert not bool((s[i] & ~avail[i]).any())
    sel, valid = tsd.select_k(s, 6)
    for i in range(4):
        si, vi = tsd.select_k(s[i], 6)
        assert torch.equal(sel[i], si) and torch.equal(valid[i], vi)


# ----------------------------------------------------- config and device
def test_scan_config_validation():
    with pytest.raises(ValueError):
        tse.ScanConfig(sampler="nope")
    with pytest.raises(ValueError):
        tse.ScanConfig(fault_frac=1.5)
    with pytest.raises(ValueError):
        tse.ScanConfig(mesh=(0,))
    # the mesh fields are ported: normalized and validated as the reference
    for kw in ({"mesh": (2,)}, {"mesh": [2, 4]}, {"silo_reduce": "psum"},
               {"cell_sharding": False}):
        cfg, ref = tse.ScanConfig(**kw), jse.ScanConfig(**kw)
        assert (cfg.mesh, cfg.silo_reduce, cfg.cell_sharding) == \
            (ref.mesh, ref.silo_reduce, ref.cell_sharding)
    with pytest.raises(ValueError):
        tse.ScanConfig(silo_reduce="allreduce")
    # the runtime knobs are ported; the compile cache has no torch meaning
    for kw in ({"telemetry": True}, {"donate_carry": False},
               {"async_pipeline": False}, {"program_cache_size": 4}):
        cfg = tse.ScanConfig(**kw)
        assert all(getattr(cfg, k) == v for k, v in kw.items())
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        tse.ScanConfig(compile_cache_dir="x")
    with pytest.raises(ValueError):
        tse.ScanConfig(program_cache_size=0)
    assert tse.ScanConfig().max_sweeps == jse.ScanConfig().max_sweeps


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                          synthetic_ds):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tse.ScanEngine(synthetic_ds, logistic_regression(), tse.ScanConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tse.oracle_h(synthetic_ds.opt_params)
    eng = tse.ScanEngine(synthetic_ds, logistic_regression(),
                         tse.ScanConfig(rounds=2), device="cpu")
    with pytest.raises(NotImplementedError, match="no torch meaning"):
        eng.lower_batch([])
    # carry_shapes is ported: a cell's carry as init_carry allocates it
    cell = eng.cell(seed=0, mode=make_mode("IDL", n_clients=30), h=None,
                    sampler_process=tsd.make_sampler_process("uniform"))
    shapes = eng.carry_shapes([cell])
    tree = eng.init_carry([cell]).tree
    assert shapes["counts"].shape == tuple(tree["counts"].shape)
    assert {k: v.shape for k, v in shapes["params"].items()} == \
        {k: tuple(v.shape) for k, v in tree["params"].items()}


def test_package_exports():
    from repro_torch import fed
    for name in ("ScanConfig", "ScanEngine", "ScanHistory", "oracle_h",
                 "precompute_masks"):
        assert getattr(fed, name) is getattr(tse, name)


def test_cell_input_checks(synthetic_ds, h_ref):
    ds = synthetic_ds
    masked = tse.ScanEngine(ds, logistic_regression(), _cfg(tse),
                            use_masks=True, device="cpu")
    with pytest.raises(ValueError, match="masks of shape"):
        masked.cell(seed=0, masks=np.ones((ROUNDS - 1, ds.n_clients), bool),
                    h=h_ref)
    dev = tse.ScanEngine(ds, logistic_regression(), _cfg(tse), device="cpu")
    with pytest.raises(ValueError, match="process or a mode"):
        dev.cell(seed=0, h=h_ref)
    mode = make_mode("IDL", n_clients=ds.n_clients)
    with pytest.raises(ValueError, match="normalized H"):
        dev.cell(seed=0, mode=mode)
    # H may come in as a tensor
    c = dev.cell(seed=0, mode=mode, h=torch.as_tensor(h_ref))
    assert torch.equal(c["h"], torch.as_tensor(h_ref))


def test_normalized_h_vs_reference(synthetic_ds):
    from repro.core.graph import build_3dg as jax_build_3dg
    _, _, h = jax_build_3dg(synthetic_ds.opt_params)      # raw, with inf
    want = np.asarray(jse.normalized_h(h))
    got = tse.normalized_h(h, device="cpu")
    assert np.array_equal(got, want)
    assert np.isfinite(got).all() and got.max() == 1.0


def test_host_draws_shapes_ranges_and_repeatability(synthetic_ds):
    ds = synthetic_ds
    eng = tse.ScanEngine(ds, logistic_regression(),
                         _cfg(tse, graph_refresh_every=2), device="cpu")
    proc = tad.DeadlineProcess(ds.n_clients)
    d = eng.host_draws(4, proc)
    n, sizes = ds.n_clients, np.asarray(ds.sizes)
    assert d["avail_draws"]("u", 3, (n,)).dtype == np.float32
    assert 0 <= int(d["avail_draws"]("force", 3, ())) < n
    assert d["avail_draws"]("step", 3, (n,)).min() < 0      # normal draws
    sel = np.arange(M)
    idx = d["batch_indices"](2, sel, sizes[sel])
    assert idx.shape == (M, E, B) and idx.dtype == np.int64
    assert np.all((idx >= 0) & (idx < np.maximum(sizes[sel], 1)[:, None,
                                                                 None]))
    probe = d["sampler_draws"]("probe", 2, sizes[:7])
    assert probe.shape == (7, eng.cfg.poc_probe)
    assert np.all(probe < np.maximum(sizes[:7], 1)[:, None])
    assert d["graph_batch_indices"].shape == (n, E, B)
    again = eng.host_draws(4, proc)
    assert np.array_equal(again["sampler_draws"]("gumbel", 5, (n,)),
                          d["sampler_draws"]("gumbel", 5, (n,)))
    assert not np.array_equal(eng.host_draws(5, proc)["avail_draws"](
        "u", 3, (n,)), d["avail_draws"]("u", 3, (n,)))
