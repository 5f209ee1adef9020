"""The port's five fault families and the robust slice against the JAX
package on the CPU.

Contracts:
* ``byz_mask`` and the straggler's ``mu`` are numpy draws: bitwise;
* each family against the reference branch, the reference's
  ``jax.random`` draws (gaussian noise, AR(1) innovations, the straggler's
  initial latency) computed with its key derivation and injected into the
  port: the identity, the straggler's outputs and stale panel bitwise;
  sign_flip / scaled / gaussian outputs and the latency chain to f32
  round-off (XLA contracts the multiply-add into an FMA), rtol 1e-6 /
  atol 1e-6;
* the slice: the quickstart configuration (Synthetic(0.5, 0.5), N = 30,
  LN availability, FedGS α = 1, M = 6, E = 10, B = 10) for 10 rounds
  through ``repro.fed.engine.FLEngine`` and the port's, under sign_flip
  × {median, multikrum, memory} and gaussian_noise × fedavg: the same
  sampled set in every round and val_loss within 1e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.availability import make_mode as jax_make_mode
from repro.core.graph import build_3dg as jax_build_3dg
from repro.core.sampler import FedGSSampler as JaxFedGSSampler
from repro.fed import faults_device as jfd
from repro.fed.aggregator_device import \
    make_aggregator_process as jax_make_aggregator_process
from repro.fed.engine import FLConfig as JaxFLConfig, FLEngine as JaxFLEngine
from repro.fed.models import logistic_regression as jax_logreg

from repro_torch.convert import params_from_jax
from repro_torch.core.availability import make_mode
from repro_torch.core.sampler import FedGSSampler
from repro_torch.fed import faults_device as tfd
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression

from test_torch_engine import _jax_params, jax_batch_indices

N, M, P = 12, 5, 32
KNOBS = {"sign_flip": {"scale": 3.0}, "gaussian_noise": {"sigma": 0.7},
         "scaled": {"boost": 7.0},
         "straggler_stale": {"rho": 0.7, "sigma": 0.3, "deadline": 1.0}}


def jax_fault_draws(fault_seed):
    """The reference's draws: init from PRNGKey(fault_seed); per round
    fkey = fold_in(key, t), noise from fkey, innovations from
    fold_in(fkey, 2)."""
    key = jax.random.PRNGKey(fault_seed)

    def draw(kind, t, shape):
        if kind == "init":
            return np.array(jax.random.normal(key, shape))
        fkey = jax.random.fold_in(key, t)
        if kind == "innovations":
            fkey = jax.random.fold_in(fkey, jfd._STEP_SALT)
        return np.array(jax.random.normal(fkey, shape))
    return draw


# ----------------------------------------------------- host numpy draws
@pytest.mark.parametrize("n,frac,seed", [(12, 0.3, 5), (30, 0.2, 0),
                                         (1024, 0.1, 7), (12, 0.0, 1)])
def test_byz_mask_and_mu_are_the_reference_draws(n, frac, seed):
    for fam in tfd.FAMILIES:
        tp = tfd.make_fault_process(fam, n, frac=frac, byz_seed=seed)
        jp = jfd.make_fault_process(fam, n, frac=frac, byz_seed=seed)
        np.testing.assert_array_equal(tp.byz_mask(), jp.byz_mask())
        tparams, jparams = tp.params(), jp.params()
        assert tparams["family"] == int(jparams["family"])
        for k in ("theta", "byz", "aux"):
            np.testing.assert_array_equal(tparams[k], np.asarray(jparams[k]))
    s = tfd.StragglerStaleFault(n, mu_seed=seed)
    np.testing.assert_array_equal(
        s._mu(), jfd.StragglerStaleFault(n, mu_seed=seed)._mu())
    with pytest.raises(ValueError):
        tfd.make_fault_process("nope", n)


# ------------------------------------------------ each family vs reference
@pytest.mark.parametrize("family", jfd.FAMILIES)
def test_family_matches_reference_with_injected_draws(rng, family):
    """Three rounds of carried state (the straggler's latency chain and
    stale panel) on seeded panels, sel and valid."""
    kw = KNOBS.get(family, {})
    jproc = jfd.make_fault_process(family, N, frac=0.4, **kw)
    tproc = tfd.make_fault_process(family, N, frac=0.4, **kw)
    stale = family == "straggler_stale"
    key = jax.random.PRNGKey(3)
    draw = jax_fault_draws(3)
    panel0 = rng.normal(size=(N, P)).astype(np.float32)
    jstate = {**jproc.init(key),
              "stale": jnp.asarray(panel0 if stale else panel0[:0])}
    tstate = {**tproc.init(torch.as_tensor(draw("init", None, (N,)))
                           if stale else None, device="cpu"),
              "stale": torch.as_tensor(panel0.copy() if stale
                                       else panel0[:0])}
    jstep = jax.jit(jfd.make_fault_step(N, M, stale_enabled=stale,
                                        family=family))
    tstep = tfd.make_fault_step(family)
    fp = tfd.device_params(tproc.params(), "cpu")
    for t in range(3):
        updf = rng.normal(size=(M, P)).astype(np.float32)
        prevf = rng.normal(size=(P,)).astype(np.float32)
        sel = rng.choice(N, size=M, replace=False)
        valid = rng.random(M) < 0.8
        avail = np.ones(N, bool)
        jout, jstate = jstep(jproc.params(), jstate,
                             jax.random.fold_in(key, t), jnp.asarray(updf),
                             jnp.asarray(prevf), jnp.asarray(avail), t,
                             jnp.asarray(sel, jnp.int32), jnp.asarray(valid))
        tout, tstate = tstep(fp, tstate, torch.as_tensor(updf),
                             torch.as_tensor(prevf), torch.as_tensor(avail),
                             t, torch.as_tensor(sel), torch.as_tensor(valid),
                             noise=torch.as_tensor(draw("noise", t, (M, P))),
                             innovations=torch.as_tensor(
                                 draw("innovations", t, (N,))))
        byzm = tproc.byz_mask()[sel] & valid
        if family in ("none", "straggler_stale"):
            np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
        else:
            np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                       rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tout.numpy()[~byzm], updf[~byzm])
        np.testing.assert_allclose(tstate["latency"].numpy(),
                                   np.asarray(jstate["latency"]),
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(tstate["stale"].numpy(),
                                      np.asarray(jstate["stale"]))
        if family != "none":
            assert byzm.any(), f"round {t}: no corrupted slot"


@pytest.mark.parametrize("family", ["none", "straggler_stale"])
def test_fault_init_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                              family):
    """A process builds its state on CUDA unless asked for the CPU: with no
    CUDA and no device it raises, never falling back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    proc = tfd.make_fault_process(family, N, frac=0.4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proc.init(torch.zeros(N))
    assert proc.init(torch.zeros(N), device="cpu")["latency"].shape == (N,)


def test_host_injector_matches_reference_injector(rng):
    """HostFaultInjector on stacked param dicts, the straggler over four
    rounds with the reference's draws injected through ``draws``."""
    p0 = {"w": rng.normal(size=(6, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    proc_kw = dict(frac=0.5, rho=0.7, sigma=0.3, deadline=0.9)
    jinj = jfd.HostFaultInjector(jfd.StragglerStaleFault(N, **proc_kw),
                                 fault_seed=11)
    tinj = tfd.HostFaultInjector(tfd.StragglerStaleFault(N, **proc_kw),
                                 fault_seed=11, draws=jax_fault_draws(11))
    jinj.init(p0)
    tinj.init(params_from_jax(p0))
    late_any = False
    for t in range(4):
        st = {k: rng.normal(size=(M, *v.shape)).astype(np.float32)
              for k, v in p0.items()}
        sel = np.sort(rng.choice(N, M, replace=False))
        jout = jinj.inject(st, p0, sel, np.ones(N, bool), t)
        tout = tinj.inject(params_from_jax(st), params_from_jax(p0), sel,
                           np.ones(N, bool), t)
        for k in p0:
            np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]))
            late_any |= not np.array_equal(tout[k].numpy(), st[k])
        np.testing.assert_array_equal(tinj.state["stale"].numpy(),
                                      np.asarray(jinj.state["stale"]))
    assert late_any, "no straggler was ever late: the test saw no stale row"


def test_default_draws_are_seeded_and_distinct():
    a = tfd.default_fault_draw(3, "noise", 4, (5, 7))
    assert a.shape == (5, 7) and a.dtype == torch.float32
    assert torch.equal(a, tfd.default_fault_draw(3, "noise", 4, (5, 7)))
    assert not torch.equal(a, tfd.default_fault_draw(3, "noise", 5, (5, 7)))
    assert not torch.equal(a[0], tfd.default_fault_draw(3, "innovations", 4,
                                                        (7,)))
    assert tfd.default_fault_draw(3, "init", None, (9,)).shape == (9,)
    proc = tfd.make_fault_process("gaussian_noise", N, frac=0.5)
    with pytest.raises(ValueError, match="noise draw"):
        tfd.make_fault_step("gaussian_noise")(
            tfd.device_params(proc.params(), "cpu"), {}, torch.zeros(M, P),
            torch.zeros(P), None, 0, torch.arange(M),
            torch.ones(M, dtype=torch.bool))


# ------------------------------------------------------------------ slice
def _cfg(cls, rounds=10):
    return cls(rounds=rounds, sample_frac=0.2, local_steps=10, batch_size=10,
               lr=0.1, eval_every=1, seed=0)


@pytest.mark.parametrize("fault,agg,agg_kw", [
    ("sign_flip", "median", {}),
    ("sign_flip", "multikrum", {"krum_f": 1, "krum_multi": 3}),
    ("sign_flip", "memory", {"gamma": 0.9}),
    ("gaussian_noise", "fedavg", {}),
])
def test_slice_robust_quickstart_matches_reference(synthetic_ds, fault, agg,
                                                   agg_kw):
    ds = synthetic_ds
    fkw = {"scale": 5.0} if fault == "sign_flip" else {}
    _, _, h = jax_build_3dg(ds.opt_params)
    jeng = JaxFLEngine(ds, jax_logreg(), JaxFedGSSampler(alpha=1.0),
                       jax_make_mode("LN", n_clients=ds.n_clients, beta=0.5,
                                     seed=99), _cfg(JaxFLConfig),
                       aggregator=jax_make_aggregator_process(agg, **agg_kw),
                       fault=jfd.make_fault_process(fault, ds.n_clients,
                                                    frac=0.2, **fkw))
    jeng.install_graph_from_H(h)
    jh = jeng.run()
    teng = FLEngine(ds, logistic_regression(),
                    FedGSSampler(alpha=1.0, device="cpu"),
                    make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99),
                    _cfg(FLConfig), device="cpu",
                    aggregator=make_aggregator_process(agg, **agg_kw),
                    fault=tfd.make_fault_process(fault, ds.n_clients,
                                                 frac=0.2, **fkw),
                    init_params=params_from_jax(_jax_params(0)),
                    batch_indices=jax_batch_indices(0),
                    fault_draws=jax_fault_draws(0 + 0xFA17))
    teng.install_graph_from_H(h)
    th = teng.run()
    assert th.all_sampled == jh.sampled
    np.testing.assert_allclose(th.val_loss, jh.val_loss, atol=1e-4)
    assert len(th.chosen) == (10 if agg == "multikrum" else 0)
    assert all(sum(c) == 3 for c in th.chosen)
