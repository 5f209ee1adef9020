"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode.  The file imports torch, numpy and the port
only, so it runs where the JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Contracts, kernel against plain version on the same device:
* Floyd–Warshall, the greedy masked argmax and the swap reduction: bitwise;
* fused adjacency: lo/hi bitwise (V is summed in the same order), the same
  inf pattern, finite R within rtol 1e-4 (``expf`` in the kernel and
  ``torch.exp`` may differ in the last bits);
* FedGS selected sets and the quickstart slice: the card run (kernels) and
  a CPU run given the card's H select the same clients every round, and
  val_loss agrees within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sampler_device as tsd
from repro_torch.core.availability import make_mode
from repro_torch.core.sampler import FedGSSampler
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression
from repro_torch.kernels import floyd_warshall as tfw
from repro_torch.kernels import graph_fused as tgf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import solver as tsolver

pytestmark = pytest.mark.gpu

NEG = -1e18
TINY = float(np.finfo(np.float32).tiny)
SIZES = [30, 130, 1024, 4096]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _features(rng, n, d=610):
    """Rows shaped like the Synthetic dataset's local optima (N, 610)."""
    mu = rng.normal(0.0, np.sqrt(0.5), (n, 1))
    return torch.as_tensor(rng.normal(mu, 1.0, (n, d)), dtype=torch.float32)


def _h(rng, n):
    h = rng.random((n, n)).astype(np.float32)
    h = 0.5 * (h + h.T)
    np.fill_diagonal(h, 0)
    return torch.from_numpy(h)


@pytest.mark.parametrize("n", SIZES[:3])
def test_fused_adjacency_kernel_vs_plain(cuda, n):
    u = _features(np.random.default_rng(n), n).to(cuda)
    r_p, s_p = tgf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    r_k, s_k = tgf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)
    assert torch.equal(s_k, s_p)
    r_k, r_p = r_k.cpu().numpy(), r_p.cpu().numpy()
    assert np.array_equal(np.isinf(r_k), np.isinf(r_p))
    fin = np.isfinite(r_p)
    np.testing.assert_allclose(r_k[fin], r_p[fin], rtol=1e-4, atol=TINY)


@pytest.mark.parametrize("n", SIZES[:3])
def test_floyd_warshall_kernel_vs_plain(cuda, n):
    u = _features(np.random.default_rng(n), n).to(cuda)
    r, _ = tgf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    assert torch.equal(tfw.floyd_warshall_cuda(r), tfw.floyd_warshall_plain(r))


@pytest.mark.parametrize("n", SIZES)
def test_greedy_argmax_kernel_vs_plain(cuda, n):
    rng = np.random.default_rng(n)
    diag = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    r = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(n) < 0.6)
    nan_diag = diag.clone()
    nan_diag[::7] = float("nan")
    cases = [(diag, r, mask), (torch.ones(n), torch.zeros(n), mask),
             (nan_diag, r, torch.ones(n, dtype=torch.bool)),
             (diag, r, torch.zeros(n, dtype=torch.bool))]
    for args in cases:
        args = [a.to(cuda) for a in args]
        kv, ki = tsolver.masked_argmax_cuda(*args)
        pv, pi = tsolver.masked_argmax_plain(*args)
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


# panel rows m = ceil(0.1 N), and the engine's own M where the quickstart
# (N = 30, M = 6) and the N = 1024 scale run (M = 102) drive the kernel
@pytest.mark.parametrize("n,m", [(30, 3), (30, 6), (130, 13), (1024, 103),
                                 (1024, 102), (4096, 410)])
def test_swap_best_kernel_vs_plain(cuda, n, m):
    rng = np.random.default_rng(n + m)
    h = _h(rng, n)
    h[:, 3] = float("nan")
    z = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    s = np.zeros(n, bool)
    s[rng.choice(n, m, replace=False)] = True
    sel = torch.as_tensor(np.concatenate([np.flatnonzero(s), [n - 1, n - 1]]))
    valid = torch.arange(m + 2) < m
    rr = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    a = torch.where(valid, (-2.0 * rr)[sel], torch.tensor(NEG))
    b = torch.where(torch.as_tensor(~s & (rng.random(n) < 0.7)), 2.0 * rr,
                    torch.tensor(NEG))
    al = float(np.float32(1.0) / np.float32(n))
    args = [h.to(cuda), z.to(cuda), al] + [x.to(cuda) for x in (sel, valid, a, b)]
    k = tsolver.swap_best_cuda(*args)
    p = tsolver.swap_best_plain(*args)
    assert float(k[0]) > NEG / 2
    assert all(torch.equal(x, y) for x, y in zip(k, p))


@pytest.mark.parametrize("n", [7, 100, 130, 1024])
def test_fedgs_select_on_card_equals_cpu(cuda, n):
    rng = np.random.default_rng(n)
    h = _h(rng, n)
    counts = torch.as_tensor(rng.integers(0, 6, n), dtype=torch.float32)
    avail = torch.as_tensor(rng.random(n) < 0.8)
    mt = max(1, n // 10)
    m = min(mt, int(avail.sum()))
    want = tsd.fedgs_select(h, counts, avail, 1.0, m=m, max_sweeps=16,
                            m_target=mt)
    got = tsd.fedgs_select(h.to(cuda), counts.to(cuda), avail.to(cuda), 1.0,
                           m=m, max_sweeps=16, m_target=mt)
    assert torch.equal(got.cpu(), want)


def test_engine_on_card_equals_cpu(cuda):
    """The quickstart slice: the card run goes through all four kernels;
    a CPU run given the card's H selects the same clients every round."""
    ds = make_synthetic(n_clients=30, seed=0)
    cfg = FLConfig(rounds=10, sample_frac=0.2, local_steps=10, batch_size=10,
                   lr=0.1, eval_every=1, seed=0)
    mode = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)
    tops.reset_launches()
    card = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0), mode,
                    cfg)
    card.install_oracle_graph(ds.opt_params)
    hc = card.run()
    assert all(v > 0 for v in tops.launches().values()), tops.launches()
    cpu = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0), mode,
                   cfg, device="cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    hp = cpu.run()
    assert hc.all_sampled == hp.all_sampled
    np.testing.assert_allclose(hc.val_loss, hp.val_loss, atol=1e-4)
