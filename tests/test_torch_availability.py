"""The port's device availability processes against ``repro.core.
availability_device`` on the CPU, with the reference's threefry draws
handed in through the draw seam.

Contract (40 rounds, N = 30): per family the masks are bitwise; the Markov
and cluster chain states bitwise; the table probability rows bitwise; the
drift and deadline rows within one float32 ulp (XLA:CPU may contract ``(1 −
w)·A + w·B`` and the AR(1) update into an FMA, torch rounds twice); the
host face (``ProcessMode``) of the stateless families bitwise the
reference's ``host_trace``.  With the port's own draws: the stationary
rate and sojourn checks of ``tests/test_availability_device.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import availability as javail
from repro.core import availability_device as jad

from repro_torch.core import availability as tavail
from repro_torch.core import availability_device as tad

ROUNDS = 40
N = 30


def _pair(name, ds, **kw):
    """(reference process, port process) of one scenario."""
    args = dict(n_clients=ds.n_clients, data_sizes=ds.sizes,
                label_sets=ds.label_sets(), num_labels=ds.num_classes,
                seed=5, rounds=ROUNDS, **kw)
    return jad.make_process(name, **args), tad.make_process(name, **args)


def jax_avail_draws(dist, avail_seed, n):
    """The reference's draws for ``proc_draw``'s key layout: init on the raw
    key, u on fold_in(key, t), force on fold_in(·, 1), the transition on
    fold_in(·, 2)."""
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


_jit_step = jax.jit(jad.proc_step)
_jit_bern = jax.jit(jad.bernoulli_nonempty)


def _reference_trace(proc, avail_seed, rounds):
    key = jax.random.PRNGKey(avail_seed)
    params, state = proc.params(), proc.init(key)
    ps, states, masks = [], [], []
    for t in range(rounds):
        akey = jax.random.fold_in(key, t)
        p, state = _jit_step(params, state, jax.random.fold_in(akey, 2), t)
        masks.append(np.asarray(_jit_bern(akey, p)))
        ps.append(np.asarray(p))
        states.append({k: np.asarray(v) for k, v in state.items()})
    return np.stack(ps), states, np.stack(masks)


def _port_trace(proc, avail_seed, rounds, draws):
    dev = torch.device("cpu")
    n, dist = proc.n_clients, proc.draw_dist
    state = proc.init(tad.init_draw(dist, n, avail_seed, dev, draws=draws),
                      device="cpu")
    ps, states, masks = [], [], []
    for t in range(rounds):
        d = tad.round_draws(dist, n, avail_seed, t, dev, draws=draws)
        p, _ = proc.step(state, d["step"], t)
        avail, state = proc.draw(state, d, t)
        ps.append(p.numpy())
        states.append({k: v.numpy() for k, v in state.items()})
        masks.append(avail.numpy())
    return np.stack(ps), states, np.stack(masks)


def _ulps(got, want):
    """Per-entry distance in float32 ulps of ``want``."""
    spacing = np.spacing(np.abs(want).astype(np.float32))
    return np.abs(got.astype(np.float64) - want) / spacing


FAMILY_CASES = [("LN", {}), ("YC", {}), ("GE", {"mean_on": 6.0, "mean_off": 3.0}),
                ("CLUSTER", {"n_clusters": 3, "floor": 0.1}), ("DRIFT", {}),
                ("DRIFT", {"switch_period": 7}), ("DEADLINE", {"deadline": 1.1})]


@pytest.mark.parametrize("name,kw", FAMILY_CASES)
def test_family_trace_vs_reference(synthetic_ds, name, kw):
    jproc, tproc = _pair(name, synthetic_ds, **kw)
    assert tproc.family == jproc.family
    seed = 21
    want_p, want_s, want_m = _reference_trace(jproc, seed, ROUNDS)
    draws = jax_avail_draws(tproc.draw_dist, seed, N)
    got_p, got_s, got_m = _port_trace(tproc, seed, ROUNDS, draws)
    assert np.array_equal(got_m, want_m)
    if tproc.family in ("table", "markov", "cluster"):
        assert np.array_equal(got_p, want_p)
    else:
        assert _ulps(got_p, want_p).max() <= 1.0
    for gs, ws in zip(got_s, want_s):
        assert np.array_equal(gs["onoff"], ws["onoff"])
        if tproc.family == "deadline":
            np.testing.assert_allclose(gs["latency"], ws["latency"],
                                       rtol=1e-6, atol=1e-6)
    # device_trace through the same seam: the same masks
    tr = tad.device_trace(tproc, ROUNDS, seed, draws=draws, device="cpu")
    assert np.array_equal(tr, want_m)


def test_params_layout_matches_reference(synthetic_ds):
    for name, kw in FAMILY_CASES:
        jproc, tproc = _pair(name, synthetic_ds, **kw)
        jp, tp = jproc.params(), tproc.params()
        assert tp["family"] == int(jp["family"])
        assert int(tp["period"]) == int(jp["period"])
        for k in ("table", "table_b", "theta", "aux"):
            assert np.array_equal(tp[k].numpy(), np.asarray(jp[k])), (name, k)
        assert np.array_equal(tp["cluster"].numpy(), np.asarray(jp["cluster"]))
        assert tp["theta"].shape == (tad.THETA_DIM,)


def test_mixed_group_step_equals_single_steps(synthetic_ds):
    """Cells of one family stacked along the cell axis step as one call,
    bitwise the per-cell steps (the scan engine's grouping)."""
    procs = [tad.GilbertElliott(N, mean_on=m, mean_off=3.0)
             for m in (2.0, 6.0, 9.0)]
    dev = torch.device("cpu")
    states = [p.init(tad.init_draw("uniform", N, 3 + i, dev), device="cpu")
              for i, p in enumerate(procs)]
    params = tad.stack_params([p.params() for p in procs])
    group = tad.stack_state(states)
    for t in range(6):
        rows = [tad.round_draws("uniform", N, 3 + i, t, dev)
                for i in range(len(procs))]
        avail, group = tad.proc_draw(params, group, tad.stack_draws(rows), t)
        for i, p in enumerate(procs):
            a, states[i] = p.draw(states[i], rows[i], t)
            assert torch.equal(a, avail[i])
            assert torch.equal(states[i]["onoff"], group["onoff"][i])


@pytest.mark.parametrize("name", ["LN", "SLN", "YC"])
def test_process_mode_table_bitwise_host_trace(synthetic_ds, name):
    jproc, tproc = _pair(name, synthetic_ds)
    want = javail.host_trace(javail.ProcessMode(jproc, 9), ROUNDS, 9)
    got = tavail.host_trace(tavail.ProcessMode(tproc, 9), ROUNDS, 9)
    assert np.array_equal(got, want)
    mode = tavail.make_mode(name, n_clients=N, data_sizes=synthetic_ds.sizes,
                            label_sets=synthetic_ds.label_sets(), seed=5,
                            num_labels=synthetic_ds.num_classes)
    assert np.array_equal(mode.process().table, mode.probs_table())
    assert np.array_equal(tavail.host_trace(mode, ROUNDS, 9),
                          tavail.host_trace(tavail.ProcessMode(
                              mode.process(), 9), ROUNDS, 9))


@pytest.mark.parametrize("kw", [{}, {"switch_period": 6}])
def test_process_mode_drift_bitwise_host_trace(synthetic_ds, kw):
    jproc, tproc = _pair("DRIFT", synthetic_ds, **kw)
    for t in (0, 5, 17, 39, 60):
        assert np.array_equal(tavail.ProcessMode(tproc).probs(t),
                              javail.ProcessMode(jproc).probs(t))
    want = javail.host_trace(javail.ProcessMode(jproc, 4), ROUNDS, 4)
    got = tavail.host_trace(tavail.ProcessMode(tproc, 4), ROUNDS, 4)
    assert np.array_equal(got, want)


def test_process_mode_stateful_replays_injected_stream(synthetic_ds):
    """With the reference's draws handed in, the host face of a Markov
    process serves the reference chain's probability rows."""
    jproc, tproc = _pair("GE", synthetic_ds, mean_on=5.0, mean_off=5.0)
    want_p, _, _ = _reference_trace(jproc, 7, 12)
    pm = tavail.ProcessMode(tproc, 7, draws=jax_avail_draws("uniform", 7, N))
    for t in (11, 0, 5):                   # order-independent replay
        assert np.array_equal(pm.probs(t), want_p[t].astype(np.float64))


def test_process_mode_default_stream_is_the_cpu_scan_chain():
    """Without a seam, ProcessMode replays the port's own default stream:
    the chain ``device_trace`` on the CPU walks for the same seed."""
    proc = tad.GilbertElliott(12, mean_on=4.0, mean_off=4.0)
    pm = tavail.ProcessMode(proc, 3)
    dev = torch.device("cpu")
    state = proc.init(tad.init_draw("uniform", 12, 3, dev), device="cpu")
    for t in range(8):
        d = tad.round_draws("uniform", 12, 3, t, dev)
        p, state = proc.step(state, d["step"], t)
        assert np.array_equal(pm.probs(t), p.numpy().astype(np.float64))


def test_host_draw_rejects_mismatched_process_seed():
    pm = tavail.ProcessMode(tad.GilbertElliott(10, mean_on=4, mean_off=4),
                            avail_seed=7)
    with pytest.raises(ValueError, match="seed mismatch"):
        tavail.host_draw(pm, 0, avail_seed=8)
    assert tavail.host_trace(pm, 5, avail_seed=7).shape == (5, 10)


def test_ensure_nonempty_forces_one():
    avail = torch.zeros(3, 9, dtype=torch.bool)
    avail[1, 4] = True
    forced = torch.tensor([2, 7, 8])
    out = tad.ensure_nonempty(avail, forced)
    assert out.sum(1).tolist() == [1, 1, 1]
    assert out[0, 2] and out[1, 4] and out[2, 8]
    u = torch.ones(9)
    assert tad.bernoulli_nonempty(u, torch.zeros(9), torch.tensor(3)).sum() == 1


# ------------------------------------------------ the port's own draws
def test_gilbert_elliott_stationary_and_sojourn():
    ge = tad.GilbertElliott(80, mean_on=8.0, mean_off=4.0)
    tr = tad.device_trace(ge, 600, avail_seed=3, device="cpu")
    assert abs(tr.mean() - ge.pi_on) < 0.04
    runs = []
    for k in range(tr.shape[1]):
        col, r = tr[:, k], 0
        for v in col:
            if v:
                r += 1
            elif r:
                runs.append(r)
                r = 0
    assert abs(np.mean(runs) - ge.mean_on) / ge.mean_on < 0.3


def test_cluster_outage_correlated_within_region():
    cl = tad.ClusterOutage(60, n_clusters=4, p_fail=0.1, p_recover=0.3,
                           floor=0.0)
    tr = tad.device_trace(cl, 500, avail_seed=5, device="cpu")
    assert abs(tr.mean() - cl.pi_up) < 0.05
    ids = np.arange(60) % 4
    same = np.mean([np.all(tr[t, ids == 0] == tr[t, ids == 0][0])
                    for t in range(500)])
    assert same > 0.9


def test_drift_ramp_and_switch():
    n = 200
    dr = tad.DriftProcess(np.full((1, n), 0.9), np.full((1, n), 0.2),
                          t0=100, t1=400)
    tr = tad.device_trace(dr, 500, avail_seed=1, device="cpu")
    assert abs(tr[:100].mean() - 0.9) < 0.05
    assert abs(tr[450:].mean() - 0.2) < 0.05
    np.testing.assert_allclose(tavail.ProcessMode(dr).probs(250),
                               np.full(n, 0.55))
    sw = tad.DriftProcess(np.full((1, n), 0.9), np.full((1, n), 0.1),
                          switch_period=25)
    tr = tad.device_trace(sw, 75, avail_seed=2, device="cpu")
    assert tr[:25].mean() > 0.8 and tr[25:50].mean() < 0.2 \
        and tr[50:].mean() > 0.8


def test_deadline_stationary_rate_vs_reference():
    dl = tad.DeadlineProcess(80, deadline=1.0, rho=0.8, sigma=0.2, mu_seed=1)
    want = jad.DeadlineProcess(80, deadline=1.0, rho=0.8, sigma=0.2,
                               mu_seed=1).stationary_rate()
    # float64 CDF here, float32 in the reference
    np.testing.assert_allclose(dl.stationary_rate(), want, atol=2e-7)
    tr = tad.device_trace(dl, 800, avail_seed=11, device="cpu")
    assert abs(tr.mean() - dl.stationary_rate().mean()) < 0.04
    mu = dl._mu()
    emp = tr.mean(0)
    assert emp[mu < 0.6].mean() > 0.9 and emp[mu > 1.4].mean() < 0.1
    tight = tad.DeadlineProcess(80, deadline=0.7, rho=0.8, sigma=0.2,
                                mu_seed=1)
    assert tad.device_trace(tight, 800, avail_seed=11,
                            device="cpu").mean() < tr.mean()


def test_stateful_families_stay_in_range(synthetic_ds):
    for name in tad.ALL_SCENARIOS:
        proc = tad.make_process(name, n_clients=N, data_sizes=synthetic_ds.sizes,
                                rounds=50, seed=3)
        pm = tavail.ProcessMode(proc, 1)
        for t in range(0, 50, 7):
            p = pm.probs(t)
            assert p.shape == (N,) and np.all((p >= 0) & (p <= 1)), name


def test_flengine_runs_a_stateful_scenario(synthetic_ds):
    from repro_torch.core.sampler import UniformSampler
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import logistic_regression
    proc = tad.GilbertElliott(N, mean_on=6, mean_off=3)
    cfg = FLConfig(rounds=6, sample_frac=0.2, local_steps=2, batch_size=5,
                   eval_every=1)
    eng = FLEngine(synthetic_ds, logistic_regression(), UniformSampler(),
                   tavail.ProcessMode(proc, cfg.avail_seed), cfg, device="cpu")
    hist = eng.run()
    assert np.isfinite(hist.val_loss).all()
    masks = tavail.host_trace(tavail.ProcessMode(proc, cfg.avail_seed),
                              cfg.rounds, cfg.avail_seed)
    for t, sel in zip(hist.rounds, hist.sampled):
        assert set(sel) <= set(np.flatnonzero(masks[t]))


def test_process_init_without_device_raises_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tad.GilbertElliott(5).init(torch.zeros(5))
    with pytest.raises(ValueError, match="init draw"):
        tad.DeadlineProcess(5).init(device="cpu")
