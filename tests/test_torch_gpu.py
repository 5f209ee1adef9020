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
* memagg: the panel bitwise (a row copy), the reduction within atol = rtol
  = 1e-5 (the reference's own bound; the kernel sums in a fixed order of
  its own) and bitwise from one launch to the next;
* krum: the distance panel within ``krum_panel_bound`` (f32 round-off of
  a length-P dot product, scaled by ‖xᵢ‖² + ‖xⱼ‖²), exactly symmetric, and
  the Krum selection bitwise;
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
from repro_torch.fed import aggregator_device as tad
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression
from repro_torch.kernels import floyd_warshall as tfw
from repro_torch.kernels import aggregate as tag
from repro_torch.kernels import graph_fused as tgf
from repro_torch.kernels import krum as tkr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import solver as tsolver

pytestmark = pytest.mark.gpu

NEG = -1e18
TINY = float(np.finfo(np.float32).tiny)
SIZES = [30, 130, 1024, 4096]
FEDGS_KERNELS = ("fused_adjacency", "floyd_warshall", "greedy_argmax",
                 "swap_best_fused")


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
    launched = tops.launches()
    assert all(launched[k] > 0 for k in FEDGS_KERNELS), launched
    cpu = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0), mode,
                   cfg, device="cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    hp = cpu.run()
    assert hc.all_sampled == hp.all_sampled
    np.testing.assert_allclose(hc.val_loss, hp.val_loss, atol=1e-4)


# ------------------------------------------------- robust server update
# memagg at the quickstart's memory panel (N = 30, P = 610, M = 6), the
# N = 1024 scale run's (M = 102), a multi-chunk m and a large panel
@pytest.mark.parametrize("n,p,m", [(30, 610, 6), (1024, 610, 102),
                                   (2000, 300, 700), (4096, 2048, 410)])
def test_memagg_kernel_vs_plain(cuda, n, p, m):
    rng = np.random.default_rng(n + m)
    mem = torch.as_tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                          device=cuda)
    upd = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32,
                          device=cuda)
    upd[0, 1] = float("nan")
    sel = torch.as_tensor(np.sort(rng.choice(n, m, replace=False)),
                          device=cuda)
    valid = torch.as_tensor(rng.random(m) < 0.8, device=cuda)
    valid[0] = True
    w = torch.as_tensor(rng.random(n), dtype=torch.float32, device=cuda)
    w = w / w.sum()
    pm, pr = tag.memory_scatter_reduce_ref(mem.clone(), upd, sel, valid, w)
    kmem = mem.clone()
    km, kr = tag.memory_aggregate_cuda(kmem, upd, sel, valid, w)
    assert km is kmem
    assert torch.equal(torch.isnan(km), torch.isnan(pm))
    assert torch.equal(torch.nan_to_num(km), torch.nan_to_num(pm))
    assert bool(torch.isnan(kr[1])) and bool(torch.isnan(pr[1]))
    keep = torch.arange(p, device=cuda) != 1
    np.testing.assert_allclose(kr[keep].cpu().numpy(), pr[keep].cpu().numpy(),
                               atol=1e-5, rtol=1e-5)
    _, kr2 = tag.memory_aggregate_cuda(mem.clone(), upd, sel, valid, w)
    assert torch.equal(torch.nan_to_num(kr2), torch.nan_to_num(kr))


def test_memagg_kernel_empty_and_invalid(cuda):
    rng = np.random.default_rng(5)
    n, p = 16, 9
    mem = torch.as_tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                          device=cuda)
    w = torch.full((n,), 1.0 / n, device=cuda)
    for m in (0, 3):
        upd = torch.ones((m, p), device=cuda)
        sel = torch.arange(m, device=cuda)
        km, kr = tag.memory_aggregate_cuda(mem.clone(), upd, sel,
                                           torch.zeros(m, dtype=torch.bool,
                                                       device=cuda), w)
        assert torch.equal(km, mem)
        np.testing.assert_allclose(kr.cpu().numpy(), (w @ mem).cpu().numpy(),
                                   atol=1e-6)
    with pytest.raises(ValueError, match="not CUDA"):
        tag.memory_aggregate_cuda(mem, torch.ones((1, p)), sel[:1],
                                  torch.ones(1, dtype=torch.bool,
                                             device=cuda), w)


def krum_panel_bound(x: torch.Tensor) -> torch.Tensor:
    """|D_kernel − D_plain| allowed per entry: 8·sqrt(P)·2⁻²⁴·(‖xᵢ‖² +
    ‖xⱼ‖²), a random-walk round-off bound for two length-P f32 sums taken
    in different orders (both sides' norms and cross terms)."""
    n2 = torch.sum(x.double() ** 2, dim=1)
    return 8.0 * np.sqrt(x.shape[1]) * 2.0 ** -24 * (n2[:, None] + n2[None, :])


# the main path's (M, P) = (6, 610), then the robustness bench's tiers on
# its own data recipe (default_rng(0), normal rows, valid < 0.95)
@pytest.mark.parametrize("m,p", [(6, 610), (64, 512), (128, 2048),
                                 (256, 4096), (512, 16384)])
def test_krum_kernel_vs_plain(cuda, m, p):
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(m, p)).astype(np.float32),
                        device=cuda)
    valid = torch.as_tensor(rng.random(m) < 0.95, device=cuda)
    dk = tkr.krum_distances_cuda(x)
    dp = tkr.krum_pairwise_ref(x)
    assert torch.equal(dk, dk.T)
    err = (dk.double() - dp.double()).abs()
    assert bool((err <= krum_panel_bound(x)).all()), float(err.max())
    f = max(1, m // 5)
    chosen_k, _ = tad.krum_select(x, valid, f, 3)
    chosen_p, _ = tad.krum_select(x.cpu(), valid.cpu(), f, 3)
    assert torch.equal(chosen_k.cpu(), chosen_p)


@pytest.mark.parametrize("agg", ["memory", "multikrum"])
def test_robust_engine_on_card_equals_cpu(cuda, agg):
    """sign_flip (frac 0.2, scale 5) against a robust server on the card:
    one memagg or krum launch per round, and a CPU run given the card's H
    selects the same clients (and, for multikrum, the same rows)."""
    from repro_torch.fed.faults_device import make_fault_process
    ds = make_synthetic(n_clients=30, seed=0)
    cfg = FLConfig(rounds=8, sample_frac=0.2, local_steps=10, batch_size=10,
                   lr=0.1, eval_every=1, seed=0)
    mode = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)

    def run(device, h=None):
        eng = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                       mode, cfg, device=device,
                       aggregator=tad.make_aggregator_process(
                           agg, krum_f=1, krum_multi=3),
                       fault=make_fault_process("sign_flip", ds.n_clients,
                                                frac=0.2, scale=5.0))
        if h is None:
            eng.install_oracle_graph(ds.opt_params)
        else:
            eng.install_graph_from_H(h)
        return eng, eng.run()

    tops.reset_launches()
    card, hc = run(cuda)
    kernel = "memagg" if agg == "memory" else "krum"
    assert tops.launches()[kernel] == cfg.rounds, tops.launches()
    _, hp = run("cpu", card.sampler._h.cpu())
    assert hc.all_sampled == hp.all_sampled
    assert hc.chosen == hp.chosen
    np.testing.assert_allclose(hc.val_loss, hp.val_loss, atol=1e-4)
