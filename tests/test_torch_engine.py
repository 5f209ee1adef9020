"""The port's model, trainer, FedAvg and round engine against the JAX package
on the CPU, and the port's import boundary.

Slice contract: the quickstart configuration
through ``repro.fed.engine.FLEngine`` and ``repro_torch.fed.engine.FLEngine``
with JAX's H installed into both, the same availability masks, JAX's
``model.init(PRNGKey(0))`` carried over by ``params_from_jax`` and batch
indices recomputed from the reference's key chain selects the identical
set in every round, and val_loss agrees within 1e-4 (the bound
``tests/test_scan_engine.py`` holds FLEngine and ScanEngine to).
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core.availability import make_mode as jax_make_mode
from repro.core.graph import build_3dg as jax_build_3dg
from repro.core.sampler import FedGSSampler as JaxFedGSSampler
from repro.fed.aggregator_device import fedavg_combine as jax_fedavg_combine
from repro.fed.client import make_local_trainer as jax_make_local_trainer
from repro.fed.engine import FLConfig as JaxFLConfig, FLEngine as JaxFLEngine
from repro.fed.models import logistic_regression as jax_logreg

from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.availability import make_mode
from repro_torch.core.sampler import FedGSSampler, UniformSampler
from repro_torch.fed import engine as tengine
from repro_torch.fed.aggregator_device import fedavg_combine
from repro_torch.fed.client import default_batch_indices, make_local_trainer
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression

ROOT = Path(__file__).resolve().parents[1]
SEED, E, B = 0, 10, 10


def _jax_params(seed=SEED):
    p = jax_logreg().init(jax.random.PRNGKey(seed))
    return jax.tree_util.tree_map(np.asarray, p)


def jax_batch_indices(seed, local_steps=E, batch_size=B):
    """The reference engine's draws: fold_in(PRNGKey(seed), t) -> split ->
    split(sub, M) -> split(client, E) -> randint(step, (B,), 0, max(n_k, 1))."""
    def draw(t, sel, sizes):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        _, sub = jax.random.split(key)
        out = []
        for ck, nk in zip(jax.random.split(sub, len(sel)), sizes):
            steps = jax.random.split(ck, local_steps)
            out.append([np.asarray(jax.random.randint(
                sk, (batch_size,), 0, max(int(nk), 1))) for sk in steps])
        return np.asarray(out, np.int64)
    return draw


# ---------------------------------------------------------- import boundary
_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)|"
    r"from\s+repro(\.|\s)|.*\bimport\s+repro(\.|\s|$))")


@pytest.mark.parametrize("target", ["src/repro_torch", "chip_smoke.py"])
def test_port_imports_no_jax_and_no_repro(target):
    path = ROOT / target
    files = sorted(path.rglob("*.py")) if path.is_dir() else [path]
    assert files, f"nothing found at {target}"
    hits = [f"{f.relative_to(ROOT)}:{i}: {line.strip()}"
            for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if _FORBIDDEN.match(line)]
    assert not hits, "\n".join(hits)


def test_guard_covers_every_port_module():
    """The scan above reaches every module of the port, the robust
    server-update modules included, and importing all of them in a fresh
    interpreter loads neither jax nor repro."""
    pkg = ROOT / "src" / "repro_torch"
    mods = sorted(".".join(f.relative_to(pkg.parent).with_suffix("").parts)
                  for f in pkg.rglob("*.py"))
    for need in ("repro_torch.fed.aggregator_device",
                 "repro_torch.fed.faults_device", "repro_torch.fed.server",
                 "repro_torch.kernels.aggregate", "repro_torch.kernels.krum"):
        assert need in mods, need
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m == 'jax' or m == 'repro'\n"
            "       or m.startswith(('jax.', 'repro.'))]\n"
            "assert not bad, bad\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]


def test_import_guard_pattern():
    for bad in ("import jax", "from jax import numpy", "import jax.numpy as jnp",
                "from repro.core import graph", "from repro import fed",
                "import repro", "import repro.core", "    import repro.kernels"):
        assert _FORBIDDEN.match(bad), bad
    for ok in ("import repro_torch", "from repro_torch.core import graph",
               "import jaxlike", "from repro_torch import convert"):
        assert not _FORBIDDEN.match(ok), ok


def test_engine_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                          synthetic_ds):
    monkeypatch.setattr(tengine.torch.cuda, "is_available", lambda: False)
    mode = make_mode("IDL", n_clients=synthetic_ds.n_clients)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FLEngine(synthetic_ds, logistic_regression(), UniformSampler(), mode,
                 FLConfig(rounds=1))


# ------------------------------------------------------ model + trainer
def test_params_roundtrip_from_jax():
    p = _jax_params()
    t = params_from_jax(p)
    assert set(t) == {"w", "b"} and t["w"].shape == (60, 10)
    back = params_to_numpy(t)
    assert all(np.array_equal(back[k], p[k]) for k in p)
    nested = params_from_jax({"layer": {"w": p["w"]}, "b": p["b"]})
    assert set(nested) == {"layer.w", "b"}


def test_logistic_regression_loss_and_accuracy(synthetic_ds):
    p = _jax_params(3)
    x, y = synthetic_ds.x_val, synthetic_ds.y_val
    jm, tm = jax_logreg(), logistic_regression()
    tp = params_from_jax(p)
    np.testing.assert_allclose(float(tm.loss(tp, torch.as_tensor(x),
                                             torch.as_tensor(y, dtype=torch.int64))),
                               float(jm.loss(p, x, y)), rtol=1e-6)
    assert float(tm.accuracy(tp, torch.as_tensor(x),
                             torch.as_tensor(y, dtype=torch.int64))) == \
        pytest.approx(float(jm.accuracy(p, x, y)), abs=1e-6)
    with torch.no_grad():
        tm.w.copy_(tp["w"])
        tm.b.copy_(tp["b"])
    np.testing.assert_allclose(tm(torch.as_tensor(x)).detach().numpy(),
                               x @ p["w"] + p["b"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("prox_mu", [0.0, 0.5])
def test_local_trainer_vs_reference(synthetic_ds, prox_mu):
    """Same init and batch indices: each client's local params agree to
    f32 round-off, so autograd on the summed loss gives each client its own
    gradient."""
    ds = synthetic_ds
    sel = np.array([1, 4, 9, 22])
    p = _jax_params(1)
    jt = jax_make_local_trainer(jax_logreg().loss, local_steps=E,
                                batch_size=B, prox_mu=prox_mu)
    key = jax.random.PRNGKey(5)
    want = jt(p, jnp.asarray(ds.x[sel]), jnp.asarray(ds.y[sel]),
              jnp.asarray(ds.sizes[sel]), jnp.float32(0.1),
              jax.random.split(key, len(sel)))
    idx = []
    for ck, nk in zip(jax.random.split(key, len(sel)), ds.sizes[sel]):
        idx.append([np.asarray(jax.random.randint(sk, (B,), 0, int(nk)))
                    for sk in jax.random.split(ck, E)])
    tt = make_local_trainer(logistic_regression(), local_steps=E,
                            batch_size=B, prox_mu=prox_mu)
    got = tt(params_from_jax(p), torch.as_tensor(ds.x[sel]),
             torch.as_tensor(ds.y[sel], dtype=torch.int64), 0.1,
             torch.as_tensor(np.asarray(idx, np.int64)))
    for k in ("w", "b"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-6)


def test_default_batch_indices_in_range_and_reproducible():
    sizes = np.array([1, 5, 1000, 0])
    a = default_batch_indices(3, 7, sizes, E, B)
    assert a.shape == (4, E, B) and a.dtype == torch.int64
    assert torch.equal(a, default_batch_indices(3, 7, sizes, E, B))
    assert not torch.equal(a, default_batch_indices(3, 8, sizes, E, B))
    hi = torch.as_tensor(np.maximum(sizes, 1))[:, None, None]
    assert bool(((a >= 0) & (a < hi)).all())


@pytest.mark.parametrize("weights", [[3.0, 10.0, 1.0], [0.0, 0.0, 0.0]])
def test_fedavg_combine_vs_reference(rng, weights):
    stacked = {"w": rng.normal(size=(3, 6, 4)).astype(np.float32),
               "b": rng.normal(size=(3, 4)).astype(np.float32)}
    prev = {"w": np.ones((6, 4), np.float32), "b": np.zeros(4, np.float32)}
    w = np.asarray(weights, np.float32)
    want = jax_fedavg_combine(stacked, jnp.asarray(w), prev)
    got = fedavg_combine(params_from_jax(stacked), torch.as_tensor(w),
                         params_from_jax(prev))
    for k in stacked:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    if not any(weights):
        assert np.array_equal(got["w"].numpy(), prev["w"])


# ------------------------------------------------------------------ slice
def _quickstart_cfg(cls, rounds):
    return cls(rounds=rounds, sample_frac=0.2, local_steps=E, batch_size=B,
               lr=0.1, eval_every=1, seed=SEED)


def test_slice_quickstart_matches_reference(synthetic_ds):
    ds, rounds = synthetic_ds, 10
    _, _, h = jax_build_3dg(ds.opt_params)

    jeng = JaxFLEngine(ds, jax_logreg(), JaxFedGSSampler(alpha=1.0),
                       jax_make_mode("LN", n_clients=ds.n_clients, beta=0.5,
                                     seed=99),
                       _quickstart_cfg(JaxFLConfig, rounds))
    jeng.install_graph_from_H(h)
    jh = jeng.run()

    teng = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                    make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99),
                    _quickstart_cfg(FLConfig, rounds), device="cpu",
                    init_params=params_from_jax(_jax_params(SEED)),
                    batch_indices=jax_batch_indices(SEED))
    teng.install_graph_from_H(h)
    th = teng.run()

    assert th.rounds == jh.rounds == list(range(rounds))
    assert th.all_sampled == jh.sampled == th.sampled
    np.testing.assert_allclose(th.val_loss, jh.val_loss, atol=1e-4)
    np.testing.assert_allclose(th.val_acc, jh.val_acc, atol=0.01)
    assert np.array_equal(teng.counts, jeng.counts)
    assert th.count_var == jh.count_var


def test_slice_oracle_graph_and_uniform_run(synthetic_ds):
    """The port's own oracle 3DG and its own draws: FedGS and Uniform run
    and learn; FedGS balances the sampling counts better."""
    ds, rounds = synthetic_ds, 12
    mode = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)
    out = {}
    for name, sampler in (("fedgs", FedGSSampler(alpha=1.0)),
                          ("uniform", UniformSampler())):
        eng = FLEngine(ds, logistic_regression(), sampler, mode,
                       _quickstart_cfg(FLConfig, rounds), device="cpu")
        r = eng.install_oracle_graph(ds.opt_params)
        assert (r is None) == (name == "uniform")
        hist = eng.run()
        assert np.all(np.isfinite(hist.val_loss))
        assert hist.val_loss[-1] < hist.val_loss[0]
        out[name] = eng.counts
    assert np.var(out["fedgs"]) < np.var(out["uniform"])
