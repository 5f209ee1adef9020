"""The port's vision path against the JAX package on the CPU: the CIFAR/
Fashion surrogates, ``small_cnn``, the trainer and the loss prober, the
FedGS round engine on the CNN, and the dynamic (functional-similarity) 3DG.

Contracts:
* the numpy copies (``data/vision``, ``data/partition``): bitwise;
* ``small_cnn`` with JAX's params carried by ``convert.params_from_jax``:
  logits and loss within 1e-5 (f32 round-off: the convolutions sum in
  another order than XLA's), the trainer's params after E steps within
  1e-5, the prober's losses within rtol 1e-5, given the same indices;
* the slice: both ``FLEngine``s on ``make_cifar_like(10, 600)`` with
  ``small_cnn(width=4)``, FedGS α = 1 on JAX's H, JAX's init and index
  draws: the same set every round, val_loss within 1e-4 (the bound the
  JAX package holds FLEngine vs ScanEngine to);
* the dynamic 3DG: the probe round's embeddings within 1e-5 of JAX's, and
  H built from the same embeddings under the graph contract of
  ``test_torch_graph.py`` (inf pattern identical, rtol 1e-4, N·TINY
  absolute below the normal range: XLA:CPU flushes denormal exp results).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import graph as jgraph
from repro.core import graph_device as jgd
from repro.core.availability import make_mode as jax_make_mode
from repro.core.sampler import FedGSSampler as JaxFedGSSampler
from repro.data import partition as jpart
from repro.data.vision import make_cifar_like as jax_cifar
from repro.data.vision import make_fashion_like as jax_fashion
from repro.fed.client import make_local_trainer as jax_make_local_trainer
from repro.fed.client import make_loss_prober as jax_make_loss_prober
from repro.fed.engine import FLConfig as JaxFLConfig, FLEngine as JaxFLEngine
from repro.fed.models import small_cnn as jax_small_cnn

from repro_torch.convert import params_from_jax
from repro_torch.core import graph as tgraph
from repro_torch.core import graph_device as tgd
from repro_torch.core.availability import make_mode
from repro_torch.core.sampler import FedGSSampler, PowerOfChoiceSampler
from repro_torch.data import partition as tpart
from repro_torch.data.vision import make_cifar_like, make_fashion_like
from repro_torch.fed import engine as tengine
from repro_torch.fed.client import make_local_trainer, make_loss_prober
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import small_cnn

E, B, LR, WIDTH = 10, 32, 0.03, 4
TINY = float(np.finfo(np.float32).tiny)
FIELDS = ("x", "y", "sizes", "x_val", "y_val", "label_dist")


@pytest.fixture(scope="module")
def cifar():
    return make_cifar_like(n_clients=10, n_total=600, seed=0)


def _jax_params(seed, width=WIDTH):
    p = jax_small_cnn(width=width).init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def _key_indices(key, sizes, steps, batch):
    """The reference trainer's draws under ``key``: split(key, M) ->
    split(client, steps) -> randint(step, (batch,), 0, max(n_k, 1))."""
    out = []
    for ck, nk in zip(jax.random.split(key, len(sizes)), sizes):
        out.append([np.asarray(jax.random.randint(
            sk, (batch,), 0, max(int(nk), 1)))
            for sk in jax.random.split(ck, steps)])
    return np.asarray(out, np.int64)


def jax_batch_indices(seed):
    """The reference engine's per-round draws (no prober in the run)."""
    def draw(t, sel, sizes):
        _, sub = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                     t))
        return _key_indices(sub, sizes, E, B)
    return draw


# ------------------------------------------------------------------ copies
@pytest.mark.parametrize("maker", ["cifar", "fashion"])
def test_vision_copies_bitwise(maker):
    jmake, tmake = {"cifar": (jax_cifar, make_cifar_like),
                    "fashion": (jax_fashion, make_fashion_like)}[maker]
    want, got = jmake(n_clients=10, n_total=600), tmake(n_clients=10,
                                                        n_total=600)
    for f in FIELDS:
        a, b = getattr(want, f), getattr(got, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_partition_copies_bitwise():
    labels = np.random.default_rng(3).integers(0, 10, 500)
    for fn, args in (("lognormal_sizes", (500, 12)),
                     ("dirichlet_label_partition", (labels, 12, 0.5)),
                     ("two_label_partition", (labels, 12))):
        want = getattr(jpart, fn)(*args, np.random.default_rng(1))
        got = getattr(tpart, fn)(*args, np.random.default_rng(1))
        if isinstance(want, list):
            assert all(np.array_equal(a, b) for a, b in zip(want, got))
        else:
            assert np.array_equal(want, got)


# ---------------------------------------------------- model, trainer, probe
def test_small_cnn_logits_and_loss_vs_reference(cifar):
    p = _jax_params(1)
    x, y = cifar.x_val[:50], cifar.y_val[:50]
    jm, tm = jax_small_cnn(width=WIDTH), small_cnn(width=WIDTH)
    tp = params_from_jax(p)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y, dtype=torch.int64)
    np.testing.assert_allclose(tm.logits(tp, xt).numpy(),
                               np.asarray(jm.embed(p, x)), atol=1e-5)
    np.testing.assert_allclose(float(tm.loss(tp, xt, yt)),
                               float(jm.loss(p, x, y)), atol=1e-5)
    assert float(tm.accuracy(tp, xt, yt)) == pytest.approx(
        float(jm.accuracy(p, x, y)), abs=1e-6)
    assert torch.equal(tm.embed(tp, xt), tm.logits(tp, xt))
    # M stacked models at once: each its own
    p2 = _jax_params(2)
    st = {k: torch.stack([torch.tensor(p[k]), torch.tensor(p2[k])])
          for k in p}
    xs = torch.stack([xt[:20], xt[20:40]])
    out = tm.logits(st, xs)
    for i, pi in enumerate((p, p2)):
        np.testing.assert_allclose(out[i].numpy(),
                                   np.asarray(jm.embed(pi, x[20 * i:20 * i + 20])),
                                   atol=1e-5)
    assert not torch.backends.cudnn.allow_tf32
    assert torch.backends.cudnn.deterministic


def test_small_cnn_trainer_vs_reference(cifar):
    """E SGD steps on 3 clients from JAX's init with JAX's draws."""
    sel = np.array([0, 4, 7])
    p = _jax_params(3)
    jt = jax_make_local_trainer(jax_small_cnn(width=WIDTH).loss,
                                local_steps=E, batch_size=B)
    key = jax.random.PRNGKey(9)
    want = jt(p, jnp.asarray(cifar.x[sel]), jnp.asarray(cifar.y[sel]),
              jnp.asarray(cifar.sizes[sel]), jnp.float32(LR),
              jax.random.split(key, len(sel)))
    tt = make_local_trainer(small_cnn(width=WIDTH), local_steps=E,
                            batch_size=B)
    got = tt(params_from_jax(p), torch.as_tensor(cifar.x[sel]),
             torch.as_tensor(cifar.y[sel], dtype=torch.int64), LR,
             torch.as_tensor(_key_indices(key, cifar.sizes[sel], E, B)))
    for k in p:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)


def test_loss_prober_vs_reference(cifar):
    p = _jax_params(4)
    key = jax.random.PRNGKey(11)
    keys = jax.random.split(key, cifar.n_clients)
    want = jax_make_loss_prober(jax_small_cnn(width=WIDTH).loss)(
        p, jnp.asarray(cifar.x), jnp.asarray(cifar.y),
        jnp.asarray(cifar.sizes), keys)
    idx = np.stack([np.asarray(jax.random.randint(k, (64,), 0, max(int(n), 1)))
                    for k, n in zip(keys, cifar.sizes)]).astype(np.int64)
    got = make_loss_prober(small_cnn(width=WIDTH))(
        params_from_jax(p), torch.as_tensor(cifar.x),
        torch.as_tensor(cifar.y, dtype=torch.int64), torch.as_tensor(idx))
    assert got.shape == (cifar.n_clients,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    with pytest.raises(ValueError, match="probe indices"):
        make_loss_prober(small_cnn(width=WIDTH))(
            params_from_jax(p), torch.as_tensor(cifar.x),
            torch.as_tensor(cifar.y, dtype=torch.int64),
            torch.as_tensor(idx[:3]))


def test_probe_embeddings_vs_reference(rng):
    jm, tm = jax_small_cnn(width=WIDTH), small_cnn(width=WIDTH)
    ps = [_jax_params(s) for s in range(4)]
    stacked = {k: np.stack([p[k] for p in ps]) for k in ps[0]}
    probe = rng.normal(size=(16, 8, 8, 3)).astype(np.float32)
    want = jgraph.probe_embeddings(jm.embed, jax.tree_util.tree_map(
        jnp.asarray, stacked), jnp.asarray(probe))
    got = tgraph.probe_embeddings(tm.embed, params_from_jax(stacked),
                                  torch.as_tensor(probe))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


# ------------------------------------------------------------------ slice
def _cfg(cls, rounds=3):
    return cls(rounds=rounds, sample_frac=0.3, local_steps=E, batch_size=B,
               lr=LR, eval_every=1, seed=0)


def test_slice_vision_fedgs_matches_reference(cifar):
    ds = jax_cifar(n_clients=10, n_total=600, seed=0)
    _, _, h = jgraph.build_3dg(ds.label_dist)
    jeng = JaxFLEngine(ds, jax_small_cnn(width=WIDTH),
                       JaxFedGSSampler(alpha=1.0),
                       jax_make_mode("LN", n_clients=10, beta=0.5, seed=99),
                       _cfg(JaxFLConfig))
    jeng.install_graph_from_H(h)
    jh = jeng.run()
    teng = FLEngine(cifar, small_cnn(width=WIDTH),
                    FedGSSampler(alpha=1.0, device="cpu"),
                    make_mode("LN", n_clients=10, beta=0.5, seed=99),
                    _cfg(FLConfig), device="cpu",
                    init_params=params_from_jax(_jax_params(0)),
                    batch_indices=jax_batch_indices(0))
    teng.install_graph_from_H(h)
    th = teng.run()
    assert th.all_sampled == jh.sampled and len(th.all_sampled) == 3
    np.testing.assert_allclose(th.val_loss, jh.val_loss, atol=1e-4)
    assert np.array_equal(teng.counts, jeng.counts)


def test_dynamic_3dg_vs_reference(cifar):
    """The probe round from JAX's init and draws: the same embeddings to
    f32 round-off; H from the same embeddings under the graph contract."""
    ds = jax_cifar(n_clients=10, n_total=600, seed=0)
    mode = jax_make_mode("LN", n_clients=10, beta=0.5, seed=99)
    jeng = JaxFLEngine(ds, jax_small_cnn(width=WIDTH),
                       JaxFedGSSampler(alpha=1.0), mode, _cfg(JaxFLConfig))
    jeng.install_dynamic_graph(refresh_every=2)
    teng = FLEngine(cifar, small_cnn(width=WIDTH),
                    FedGSSampler(alpha=1.0, device="cpu"),
                    make_mode("LN", n_clients=10, beta=0.5, seed=99),
                    _cfg(FLConfig), device="cpu")
    key = jax.random.PRNGKey(0 + 778)
    teng.install_dynamic_graph(
        refresh_every=2, init_params=params_from_jax(_jax_params(778)),
        batch_indices=_key_indices(key, cifar.sizes, E, B))
    assert np.array_equal(teng._probe.numpy(), np.asarray(jeng._probe))
    np.testing.assert_allclose(teng._emb.numpy(), jeng._emb, atol=1e-5)
    cfg_j = jgd.GraphConfig(similarity="functional")
    _, jr, jh = jgd.build_3dg(jnp.asarray(jeng._emb), cfg_j)
    _, tr, th = tgd.build_3dg(torch.as_tensor(jeng._emb),
                              tgd.GraphConfig(similarity="functional"))
    for got, want, atol in ((tr, jr, TINY), (th, jh, 10 * TINY)):
        got, want = got.numpy(), np.asarray(want)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin], rtol=1e-4, atol=atol)


def test_dynamic_3dg_refresh_cadence(monkeypatch, cifar):
    """Participants are re-embedded every round and the graph rebuilt every
    ``refresh_every`` rounds (through the staged build_3dg)."""
    builds = []
    real = tengine.build_3dg
    monkeypatch.setattr(tengine, "build_3dg",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    eng = FLEngine(cifar, small_cnn(width=WIDTH),
                   FedGSSampler(alpha=1.0, device="cpu"),
                   make_mode("LN", n_clients=10, beta=0.5, seed=99),
                   _cfg(FLConfig, rounds=5), device="cpu")
    eng.install_dynamic_graph(refresh_every=2)
    emb0 = eng._emb.clone()
    hist = eng.run()
    assert eng.cfg.graph_refresh_every == 2 and len(builds) == 1 + 2
    touched = sorted({k for s in hist.all_sampled for k in s})
    changed = np.flatnonzero((eng._emb != emb0).any(1).numpy())
    assert changed.tolist() == touched
    assert np.all(np.isfinite(hist.val_loss))


def test_power_of_choice_engine_probes_losses(cifar):
    """PoC through the engine: every round probes the global model on all
    N clients with the injected (N, 64) indices, and keeps m of the
    candidates."""
    seen = []

    def probe_indices(t, sizes):
        seen.append(t)
        return np.zeros((len(sizes), 64), np.int64)
    eng = FLEngine(cifar, small_cnn(width=WIDTH), PowerOfChoiceSampler(),
                   make_mode("IDL", n_clients=10), _cfg(FLConfig),
                   device="cpu", probe_indices=probe_indices)
    hist = eng.run()
    assert seen == [0, 1, 2]
    assert all(len(s) == eng.m for s in hist.all_sampled)
    assert np.all(np.isfinite(hist.val_loss))
