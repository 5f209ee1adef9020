"""The port's CUDA kernels against their plain versions, on the card.

Every test here carries the ``gpu`` marker and skips without a CUDA device:
a CUDA kernel has no CPU mode.  The file imports torch, numpy and the port
only, so it runs where the JAX package is not installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Contracts, kernel against plain version on the same device:
* Floyd–Warshall, the greedy masked argmax and the swap reduction: bitwise
  (the Q-free swap on both its paths, at its small path's threshold ± 1
  entry, on all-masked and all-equal panels, in calls back to back with no
  memset, and replayed from a CUDA graph);
* fused adjacency: lo/hi bitwise (V is summed in the same order), the same
  inf pattern, finite R within rtol 1e-4 (``expf`` in the kernel and
  ``torch.exp`` may differ in the last bits);
* the staged similarity: V bitwise in each of its plans (split over
  chunks, serial, big tiles) and exactly symmetric; the staged adjacency:
  as the fused;
  on the card the staged R is bitwise the fused R, and ``build_h``'s H
  bitwise cap(staged H) (both share the tile product and the epilogue);
* the dense swap: (best, rank, j) bitwise; ``fedgs_solve`` on the card
  (greedy + dense swap kernels) selects the CPU's set;
* memagg: the panel bitwise (a row copy), the reduction within atol = rtol
  = 1e-5 (the reference's own bound; the kernel sums in a fixed order of
  its own) and bitwise from one launch to the next;
* krum: the distance panel within ``krum_panel_bound`` (f32 round-off of
  a length-P dot product, scaled by ‖xᵢ‖² + ‖xⱼ‖²), exactly symmetric with
  a zero diagonal and bitwise call to call, in either plan, and the Krum
  selection bitwise, NaN and inf rows included;
* FedGS selected sets, the quickstart slice and the vision slice
  (``small_cnn``, cuDNN with TF32 off): the card run (kernels) and a CPU
  run given the card's H select the same clients every round, and
  val_loss agrees within 1e-4;
* window attention: f32 within 1e-5 absolute on N(0, 1) inputs; bf16
  within one bf16 ulp of the plain output (2⁻⁷·|o| + 1e-6): both keep
  scores and V exact and round the output once; the tensor-core body
  (bf16, D <= 128) carries p in three bf16 terms (about 24 bits), the
  CUDA-core body in f32;
* the LM: a smollm-135m prefill launches the attention kernel once per
  layer (30) and decode not at all; the reduced LM (f32) on the card
  agrees with the CPU (the plain version) within 1e-4.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import graph_device as tgd
from repro_torch.core import sampler_device as tsd
from repro_torch.core.availability import make_mode
from repro_torch.core.sampler import FedGSSampler
from repro_torch.data.synthetic import make_synthetic
from repro_torch.data.vision import make_cifar_like
from repro_torch.fed import aggregator_device as tad
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression, small_cnn
from repro_torch.kernels import floyd_warshall as tfw
from repro_torch.kernels import aggregate as tag
from repro_torch.kernels import graph_fused as tgf
from repro_torch.kernels import krum as tkr
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_similarity as tps
from repro_torch.kernels import solver as tsolver
from repro_torch.kernels import window_attention as twa
from repro_torch.kernels.ref import SIM_CHUNK
from repro_torch.models import lm as tlm

pytestmark = pytest.mark.gpu

NEG = -1e18
TINY = float(np.finfo(np.float32).tiny)
SIZES = [30, 130, 1024, 4096]
FEDGS_KERNELS = ("pairwise_similarity", "adjacency", "floyd_warshall",
                 "greedy_argmax", "swap_best_fused")


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


def _fw_same_on_every_plan(r):
    """The kernel on its own plan and on every plan that takes N: bitwise
    the plain version."""
    n = r.shape[0]
    want = tfw.floyd_warshall_plain(r)
    assert torch.equal(tfw.floyd_warshall_cuda(r), want)
    for plan in tfw.PLANS:
        if plan != "single" or n <= tfw.SINGLE_MOST:
            assert torch.equal(tfw.floyd_warshall_cuda(r, plan=plan), want), \
                (n, plan)


@pytest.mark.parametrize("n", SIZES[:3])
def test_floyd_warshall_kernel_vs_plain(cuda, n):
    u = _features(np.random.default_rng(n), n).to(cuda)
    r, _ = tgf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    assert torch.equal(tfw.floyd_warshall_cuda(r), tfw.floyd_warshall_plain(r))
    _fw_same_on_every_plan(r)


def _fw_adjacency(n, seed, inf_frac=0.4):
    """A directed adjacency, ``inf_frac`` of entries inf, weights in [0, 10);
    at (130, 0) the fixture on which the blocked order that reads the final
    pivot panels (the TPU kernel's) parts from the per-pivot order
    (test_torch_graph.py holds a plain model of both)."""
    rng = np.random.default_rng(seed)
    r = (rng.random((n, n)) * 10).astype(np.float32)
    r[rng.random((n, n)) < inf_frac] = np.inf
    np.fill_diagonal(r, 0)
    return torch.from_numpy(r)


# 1, the pivot blocks' edges T - 1, T, T + 1, 2T + 1 (T = 32 and 64), and
# 238 and 239 (where one block's shared memory would run out), and the
# single plan's largest N (8 x 8 cells per thread) and one past
@pytest.mark.parametrize("n", [1, 31, 32, 33, 63, 64, 65, 129, 238, 239, 256,
                               257])
def test_floyd_warshall_plans_at_tile_edges(cuda, n):
    _fw_same_on_every_plan(_fw_adjacency(n, n).to(cuda))


def test_floyd_warshall_on_the_sensitive_fixture(cuda):
    _fw_same_on_every_plan(_fw_adjacency(130, 0).to(cuda))


def test_floyd_warshall_single_plan_rejects_a_large_matrix(cuda):
    with pytest.raises(ValueError):
        tfw.floyd_warshall_cuda(torch.zeros(257, 257, device=cuda),
                                plan="single")


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


def _swap_args(rng, n, m, dev):
    """A Q-free swap panel of m selected rows plus two pad rows (valid
    False, clamped to N − 1, as the solve hands them over), with a
    NaN-poisoned column."""
    h = _h(rng, n)
    h[:, 3 % n] = float("nan")
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
    return [h.to(dev), z.to(dev), al] + [x.to(dev) for x in (sel, valid, a, b)]


def _swap_same(args, **kw):
    k = tsolver.swap_best_fused_cuda(*args, **kw)
    p = tsolver.swap_best_fused_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(k, p)), (k, p)
    return k


# the small path's last panel: SWAP_SMALL entries (``swap_best_plan_kind``)
SWAP_SMALL = 2048


# panel rows m = ceil(0.1 N), and the engine's own M where the quickstart
# (N = 30, M = 6) and the N = 1024 scale run (M = 102) drive the kernel;
# then panels of (m + 2)·N = SWAP_SMALL − 1, SWAP_SMALL, SWAP_SMALL + 1
@pytest.mark.parametrize("n,m", [(30, 3), (30, 6), (130, 13), (1024, 103),
                                 (1024, 102), (4096, 410), (89, 21),
                                 (512, 2), (683, 1)])
def test_swap_best_kernel_vs_plain(cuda, n, m):
    args = _swap_args(np.random.default_rng(n + m), n, m, cuda)
    k = _swap_same(args)
    assert float(k[0]) > NEG / 2
    entries = (m + 2) * n
    want = "small" if entries <= SWAP_SMALL else "tiled"
    assert tsolver.swap_best_fused_plan(m + 2, n) == want
    if entries <= 4096:                     # the small path takes this many
        _swap_same(args, plan="small")
    _swap_same(args, plan="tiled")


@pytest.mark.parametrize("n,m", [(30, 6), (1024, 102)])
def test_swap_best_kernel_all_masked_and_all_equal(cuda, n, m):
    """No column to swap in (b all −1e18): every delta is −1e18 and the
    lowest flat index wins, (−1e18, 0, 0); equal deltas everywhere: rank 0,
    column 0.  On each path the panel fits."""
    rng = np.random.default_rng(n)
    masked = _swap_args(rng, n, m, cuda)
    masked[6] = torch.full((n,), NEG, device=cuda)
    equal = _swap_args(rng, n, m, cuda)
    equal[0] = torch.full((n, n), 0.25, device=cuda)
    equal[1] = torch.zeros(n, device=cuda)
    equal[4] = torch.ones(m + 2, dtype=torch.bool, device=cuda)
    equal[5] = torch.full((m + 2,), 1.5, device=cuda)
    equal[6] = torch.full((n,), -0.5, device=cuda)
    for plan in ("small", "tiled") if (m + 2) * n <= 4096 else ("tiled",):
        k = _swap_same(masked, plan=plan)
        assert (float(k[0]), int(k[1]), int(k[2])) == \
            (float(np.float32(NEG)), 0, 0)
        k = _swap_same(equal, plan=plan)
        assert (int(k[1]), int(k[2])) == (0, 0)


@pytest.mark.parametrize("n,m", [(30, 6), (4096, 410)])
def test_swap_best_kernel_back_to_back_without_memset(cuda, n, m):
    """Calls in a row on one stream, with no memset and no sync between
    them: the tiled path's state for the stream is zero again for each."""
    args = [_swap_args(np.random.default_rng(seed), n, m, cuda)
            for seed in range(4)]
    outs = [tsolver.swap_best_fused_cuda(*a, plan="tiled") for a in args]
    outs += [tsolver.swap_best_fused_cuda(*a) for a in args]
    for a, k in zip(args + args, outs):
        p = tsolver.swap_best_fused_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(k, p))


@pytest.mark.parametrize("n,m", [(30, 6), (130, 13), (4096, 410)])
def test_swap_best_kernel_replays_from_a_cuda_graph(cuda, n, m):
    """One call captured in a CUDA graph, replayed on new inputs copied
    into its buffers: bitwise the plain version each time."""
    static = _swap_args(np.random.default_rng(0), n, m, cuda)
    tsolver.swap_best_fused_cuda(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tsolver.swap_best_fused_cuda(*static)
    for seed in (1, 2, 3):
        for dst, src in zip(static, _swap_args(np.random.default_rng(seed), n,
                                               m, cuda)):
            if isinstance(dst, torch.Tensor):
                dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = tsolver.swap_best_fused_plain(*static)
        assert all(torch.equal(x, y) for x, y in zip(out, want))


@pytest.mark.parametrize("mode", ["eager", "graphs"])
def test_swap_best_kernel_on_two_streams_at_once(cuda, mode):
    """Tiled calls on two streams with no sync between them, as calls or
    as two captured graphs replayed: each stream (each graph) has its own
    cross-block state, so every result is the plain version's."""
    n, m = 4096, 410
    args = [_swap_args(np.random.default_rng(seed), n, m, cuda)
            for seed in (5, 6)]
    streams = [torch.cuda.Stream() for _ in args]
    if mode == "graphs":
        graphs, outs = [], []
        for a in args:
            tsolver.swap_best_fused_cuda(*a, plan="tiled")
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                outs.append(tsolver.swap_best_fused_cuda(*a, plan="tiled"))
            graphs.append(g)
        torch.cuda.synchronize()
        for _ in range(16):
            for g, st in zip(graphs, streams):
                with torch.cuda.stream(st):
                    g.replay()
        results = [[o] for o in outs]
    else:
        torch.cuda.synchronize()
        results = [[], []]
        for _ in range(16):
            for r, a, st in zip(results, args, streams):
                with torch.cuda.stream(st):
                    r.append(tsolver.swap_best_fused_cuda(*a, plan="tiled"))
    torch.cuda.synchronize()
    for a, r in zip(args, results):
        want = tsolver.swap_best_fused_plain(*a)
        for k in r:
            assert all(torch.equal(x, y) for x, y in zip(k, want))


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


def _krum_crossover(p: int) -> int:
    """The last m the small plan takes at P = p (krum_plan_kind)."""
    return next(m for m in range(1, 1 << 14)
                if tkr.krum_plan(m + 1, p) != "small")


# the main path's (M, P) = (6, 610), then the robustness bench's tiers on
# its own data recipe (default_rng(0), normal rows, valid < 0.95); then one
# and two rows, P below 32 and no multiple of 4 (4-byte loads), just past
# 32, the two plans' crossover at P = 610 (its last small m, ± 1), and the
# small plan's longest rows (P = 8192) and one column past them
@pytest.mark.parametrize("m,p", [(6, 610), (64, 512), (128, 2048),
                                 (256, 4096), (512, 16384), (1, 1), (1, 31),
                                 (2, 33), (2, 610), (6, 1), (6, 31),
                                 ("crossover-1", 610), ("crossover", 610),
                                 ("crossover+1", 610), (8, 8192),
                                 (8, 8193)])
def test_krum_kernel_vs_plain(cuda, m, p):
    if isinstance(m, str):
        m = _krum_crossover(p) + {"crossover-1": -1, "crossover": 0,
                                  "crossover+1": 1}[m]
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(m, p)).astype(np.float32),
                        device=cuda)
    valid = torch.as_tensor(rng.random(m) < 0.95, device=cuda)
    dp = tkr.krum_pairwise_ref(x)
    for plan in (None, "small", "split"):
        dk = tkr.krum_distances_cuda(x, plan=plan)
        assert torch.equal(dk, dk.T)
        assert torch.equal(torch.diagonal(dk), torch.zeros_like(dk[0]))
        err = (dk.double() - dp.double()).abs()
        assert bool((err <= krum_panel_bound(x)).all()), (plan, float(err.max()))
    f = max(1, m // 5)
    chosen_k, _ = tad.krum_select(x, valid, f, 3)
    chosen_p, _ = tad.krum_select(x.cpu(), valid.cpu(), f, 3)
    assert torch.equal(chosen_k.cpu(), chosen_p)


@pytest.mark.parametrize("m,p", [(6, 610), (300, 610), (8, 8193)])
def test_krum_kernel_is_bitwise_call_to_call(cuda, m, p):
    """No float atomics: the same panel twice gives the same D, bit for
    bit, in either plan."""
    x = torch.as_tensor(np.random.default_rng(m).normal(size=(m, p)),
                        dtype=torch.float32, device=cuda)
    for plan in ("small", "split"):
        assert torch.equal(tkr.krum_distances_cuda(x, plan=plan),
                           tkr.krum_distances_cuda(x, plan=plan))


@pytest.mark.parametrize("plan", ["small", "split"])
def test_krum_select_nan_and_inf_rows_card_equals_cpu(cuda, plan,
                                                       monkeypatch):
    """A row of NaN and a row holding inf: krum_select's clamps (NaN ->
    inf, at least 0) give the card's panel the CPU's selection and the
    same non-finite scores."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(9, 610)), dtype=torch.float32)
    x[2] = float("nan")
    x[5, 7] = float("inf")
    valid = torch.ones(9, dtype=torch.bool)
    forced = tkr.krum_distances_cuda
    monkeypatch.setattr(tkr, "krum_distances_cuda",
                        lambda t: forced(t, plan=plan))
    for multi in (1, 3):
        ck, sk = tad.krum_select(x.to(cuda), valid.to(cuda), 1, multi)
        cp, sp = tad.krum_select(x, valid, 1, multi)
        assert torch.equal(ck.cpu(), cp)
        assert not bool(ck[2]) and not bool(ck[5])
        assert torch.equal(torch.isfinite(sk.cpu()), torch.isfinite(sp))


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


# ------------------------------------------ staged 3DG route, dense swap
# the quickstart's N at d = 610, larger N, and the vision shapes: the
# oracle's (100, 10) label distributions and (100, 13946) CNN updates;
# then the similarity's plans at their edges: split over chunks (a ragged
# N at d = KS and KS + 1, one column), serial (N = 1000), big tiles
# (N = 2900)
STAGED_SHAPES = [(30, 610), (130, 610), (1024, 610), (100, 10),
                 (100, 13946), (70, SIM_CHUNK), (70, SIM_CHUNK + 1), (33, 1),
                 (1000, 520), (2900, 300)]


@pytest.mark.parametrize("n,d", STAGED_SHAPES)
def test_staged_kernels_vs_plain(cuda, n, d):
    u = _features(np.random.default_rng(n + d), n, d).to(cuda)
    v_k = tps.similarity_cuda(u)
    assert torch.equal(v_k, tps.similarity_plain(u))
    assert torch.equal(v_k, v_k.T)
    stats = torch.stack([v_k.min(), v_k.max()])
    r_k = tps.adjacency_cuda(v_k, stats, eps=0.1, sigma2=0.01).cpu().numpy()
    r_p = tps.adjacency_plain(v_k, stats, eps=0.1, sigma2=0.01).cpu().numpy()
    assert np.array_equal(np.isinf(r_k), np.isinf(r_p))
    assert np.array_equal(np.diag(r_k), np.zeros(n, np.float32))
    fin = np.isfinite(r_p)
    np.testing.assert_allclose(r_k[fin], r_p[fin], rtol=1e-4, atol=TINY)


@pytest.mark.parametrize("d", [520, 610, 611])
def test_similarity_kernel_on_a_row_offset_view(cuda, d):
    """U starting one row into its storage: its rows are 16-, 8- or only
    4-byte aligned, and the kernel stages them with copies that wide."""
    full = _features(np.random.default_rng(d), 101, d).to(cuda)
    u = full[1:]
    assert u.is_contiguous() and u.data_ptr() != full.data_ptr()
    assert torch.equal(tps.similarity_cuda(u), tps.similarity_plain(u))


@pytest.mark.parametrize("n,d", [(33, 1), (100, 13946), (2900, 300)])
def test_similarity_serial_plan_is_bitwise_the_planned_one(cuda, n, d):
    """The serial plan that chip_smoke.py times beside the planned one (the
    split plan at N = 100, the big plan at N = 2900) gives the same V."""
    u = _features(np.random.default_rng(n * d), n, d).to(cuda)
    assert torch.equal(tps.similarity_serial_cuda(u), tps.similarity_cuda(u))


def _chunked_order_pair(a: np.ndarray, b: np.ndarray) -> np.float32:
    """One entry of V in the kernels' order, vectorised over the chunks:
    each chunk's partial summed in ascending k from 0, then the partials
    added in ascending order (numpy's float32 cumsum is sequential)."""
    nch = -(-a.size // SIM_CHUNK)
    prod = np.zeros(nch * SIM_CHUNK, np.float32)
    prod[:a.size] = a * b
    prod = prod.reshape(nch, SIM_CHUNK)
    part = np.zeros(nch, np.float32)
    for k in range(SIM_CHUNK):
        part = part + prod[:, k]
    return np.cumsum(part, dtype=np.float32)[-1]


@pytest.mark.parametrize("n,d", [(500, 61517), (2, 65535 * SIM_CHUNK + 1)])
def test_similarity_kernel_past_one_window_of_partials(cuda, n, d):
    """The split plan's partials go in windows of at most 64 MiB (and at
    most 65535 chunks, the grid's y limit): N = 500 spans three windows,
    N = 2 at d past 65535 chunks four.  V stays bitwise the plain order."""
    u_np = np.random.default_rng(d).standard_normal((n, d), dtype=np.float32)
    v = tps.similarity_cuda(torch.as_tensor(u_np).to(cuda))
    assert torch.equal(v, v.T)
    if n > 2:
        want = tps.similarity_plain(torch.as_tensor(u_np).to(cuda))
        assert torch.equal(v, want)
    else:
        for i, j in ((0, 0), (0, 1), (1, 1)):
            assert float(v[i, j]) == float(_chunked_order_pair(u_np[i],
                                                               u_np[j]))


# (100, 13946) spans 55 chunks: the fused kernel runs them in series, the
# staged kernel splits them over blocks
@pytest.mark.parametrize("n,d", [(30, 610), (100, 10), (1024, 610),
                                 (100, 13946)])
@pytest.mark.parametrize("sim", ["dot", "cosine", "functional"])
def test_fused_and_staged_routes_bitwise_on_card(cuda, n, d, sim):
    u = _features(np.random.default_rng(n), n, d).to(cuda)
    cfg = tgd.GraphConfig(similarity=sim)
    tops.reset_launches()
    vn, r_staged, h_staged = tgd.build_3dg(u, cfg)
    assert vn is not None and vn.is_cuda
    r_fused, _ = tops.build_3dg_fused(tgd._features(u, cfg), eps=cfg.eps,
                                      sigma2=cfg.sigma2,
                                      clamp=sim == "functional")
    assert torch.equal(r_staged, r_fused)
    assert torch.equal(tgd.build_h(u, cfg), tgd.cap_and_normalize(h_staged))
    launched = tops.launches()
    assert launched["pairwise_similarity"] == 1 and launched["adjacency"] == 1
    assert launched["fused_adjacency"] == 2


def test_precomputed_build_on_card_equals_cpu(cuda):
    """SSPP's V through similarity="precomputed" on the card."""
    from repro_torch.core.sspp import secure_similarity_matrix
    ds = make_cifar_like(n_clients=40, n_total=2000, seed=0)
    v = torch.as_tensor(secure_similarity_matrix(ds.label_dist),
                        dtype=torch.float32)
    cfg = tgd.GraphConfig(similarity="precomputed")
    got = [t.cpu().numpy() for t in tgd.build_3dg(v.to(cuda), cfg)]
    want = [t.numpy() for t in tgd.build_3dg(v, cfg)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-7)
    for g, w in zip(got[1:], want[1:]):
        assert np.array_equal(np.isinf(g), np.isinf(w))
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-4, atol=40 * TINY)


def _gain_args(rng, n, m, dev):
    """A dense-Q swap panel of m selected rows plus two pad rows (clamped to
    N − 1, a = −1e18), with a NaN-poisoned column 3."""
    q = _h(rng, n) - torch.diag(torch.as_tensor(rng.normal(size=n),
                                                dtype=torch.float32))
    q[:, 3 % n] = float("nan")
    s = np.zeros(n, bool)
    s[rng.choice(n, m, replace=False)] = True
    sel = torch.as_tensor(np.concatenate([np.flatnonzero(s), [n - 1, n - 1]]))
    valid = torch.arange(m + 2) < m
    rr = torch.as_tensor(rng.normal(size=n), dtype=torch.float32)
    a = torch.where(valid, (-2.0 * rr)[sel], torch.tensor(NEG))
    b = torch.where(torch.as_tensor(~s & (rng.random(n) < 0.7)), 2.0 * rr,
                    torch.tensor(NEG))
    return [x.to(dev) for x in (q, sel, a, b)]


def _gain_same(args, **kw):
    k = tsolver.swap_gain_cuda(*args, **kw)
    p = tsolver.swap_gain_plain(*args)
    assert all(torch.equal(x, y) for x, y in zip(k, p)), (k, p)
    return k


# the dense swap's small path's last panel (``swap_gain_plan_kind``)
GAIN_SMALL = 4096


def _gain_paths(entries):
    """The paths that take a panel of this many entries."""
    return tsolver.SWAP_GAIN_PLANS \
        if entries <= tsolver.SWAP_GAIN_SMALL_MOST else ("grid",)


@pytest.mark.parametrize("n,m", [(100, 10), (30, 3), (1024, 103),
                                 (4096, 410)])
def test_swap_gain_kernel_vs_plain(cuda, n, m):
    args = _gain_args(np.random.default_rng(n + m), n, m, cuda)
    k = _gain_same(args)
    assert float(k[0]) > NEG / 2 and int(k[2]) != 3
    entries = (m + 2) * n
    want = "small" if entries <= GAIN_SMALL else "grid"
    assert tsolver.swap_gain_plan(m + 2, n) == want
    for plan in _gain_paths(entries):
        _gain_same(args, plan=plan)


# panels of (m + 2)·N = GAIN_SMALL − 1, GAIN_SMALL, GAIN_SMALL + 1 entries,
# and an N that is no multiple of 4 (the grid path's scalar loads)
@pytest.mark.parametrize("n,m", [(585, 5), (1024, 2), (241, 15), (1001, 48)])
def test_swap_gain_kernel_at_its_threshold(cuda, n, m):
    args = _gain_args(np.random.default_rng(n), n, m, cuda)
    entries = (m + 2) * n
    if n != 1001:
        assert tsolver.swap_gain_plan(m + 2, n) == \
            ("small" if entries <= GAIN_SMALL else "grid")
    _gain_same(args)
    for plan in _gain_paths(entries):
        _gain_same(args, plan=plan)


@pytest.mark.parametrize("n,m", [(100, 10), (1024, 102)])
def test_swap_gain_kernel_all_masked_and_all_equal(cuda, n, m):
    """No column to swap in (b all −1e18): (−1e18, 0, 0); equal deltas
    everywhere: rank 0, column 0.  On each path the panel fits."""
    rng = np.random.default_rng(n)
    masked = _gain_args(rng, n, m, cuda)
    masked[3] = torch.full((n,), NEG, device=cuda)
    equal = _gain_args(rng, n, m, cuda)
    equal[0] = torch.full((n, n), 0.25, device=cuda)
    equal[2] = torch.full((m + 2,), 1.5, device=cuda)
    equal[3] = torch.full((n,), -0.5, device=cuda)
    for plan in _gain_paths((m + 2) * n):
        k = _gain_same(masked, plan=plan)
        assert (float(k[0]), int(k[1]), int(k[2])) == \
            (float(np.float32(NEG)), 0, 0)
        k = _gain_same(equal, plan=plan)
        assert (int(k[1]), int(k[2])) == (0, 0)


@pytest.mark.parametrize("n,m", [(100, 10), (4096, 410)])
def test_swap_gain_kernel_back_to_back_without_memset(cuda, n, m):
    """Calls in a row on one stream, with no memset and no sync between
    them, the Q-free swap's tiled calls between them (the two share the
    stream's state): the state is zero again for each."""
    args = [_gain_args(np.random.default_rng(seed), n, m, cuda)
            for seed in range(4)]
    fused = _swap_args(np.random.default_rng(9), n, m, cuda)
    outs = []
    for a in args:
        outs.append(tsolver.swap_gain_cuda(*a, plan="grid"))
        tsolver.swap_best_fused_cuda(*fused, plan="tiled")
    outs += [tsolver.swap_gain_cuda(*a) for a in args]
    for a, k in zip(args + args, outs):
        p = tsolver.swap_gain_plain(*a)
        assert all(torch.equal(x, y) for x, y in zip(k, p))
    _swap_same(fused, plan="tiled")


@pytest.mark.parametrize("n,m", [(100, 10), (130, 13), (4096, 410)])
def test_swap_gain_kernel_replays_from_a_cuda_graph(cuda, n, m):
    """One call captured in a CUDA graph, replayed on new inputs copied
    into its buffers: bitwise the plain version each time."""
    static = _gain_args(np.random.default_rng(0), n, m, cuda)
    tsolver.swap_gain_cuda(*static)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = tsolver.swap_gain_cuda(*static)
    for seed in (1, 2, 3):
        for dst, src in zip(static, _gain_args(np.random.default_rng(seed), n,
                                               m, cuda)):
            dst.copy_(src)
        graph.replay()
        torch.cuda.synchronize()
        want = tsolver.swap_gain_plain(*static)
        assert all(torch.equal(x, y) for x, y in zip(out, want))


@pytest.mark.parametrize("mode", ["eager", "graphs"])
def test_swap_gain_kernel_on_two_streams_at_once(cuda, mode):
    """Grid-path calls on two streams with no sync between them, as calls
    or as two captured graphs replayed: each stream (each graph) has its
    own cross-block state, so every result is the plain version's."""
    n, m = 4096, 410
    args = [_gain_args(np.random.default_rng(seed), n, m, cuda)
            for seed in (5, 6)]
    streams = [torch.cuda.Stream() for _ in args]
    if mode == "graphs":
        graphs, outs = [], []
        for a in args:
            tsolver.swap_gain_cuda(*a, plan="grid")
            torch.cuda.synchronize()
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                outs.append(tsolver.swap_gain_cuda(*a, plan="grid"))
            graphs.append(g)
        torch.cuda.synchronize()
        for _ in range(16):
            for g, st in zip(graphs, streams):
                with torch.cuda.stream(st):
                    g.replay()
        results = [[o] for o in outs]
    else:
        torch.cuda.synchronize()
        results = [[], []]
        for _ in range(16):
            for r, a, st in zip(results, args, streams):
                with torch.cuda.stream(st):
                    r.append(tsolver.swap_gain_cuda(*a, plan="grid"))
    torch.cuda.synchronize()
    for a, r in zip(args, results):
        want = tsolver.swap_gain_plain(*a)
        for k in r:
            assert all(torch.equal(x, y) for x, y in zip(k, want))


@pytest.mark.parametrize("n", [7, 100, 1024])
def test_fedgs_solve_on_card_equals_cpu(cuda, n):
    rng = np.random.default_rng(n)
    z = tsd.balance_z(torch.as_tensor(rng.integers(0, 6, n),
                                      dtype=torch.float32), max(1, n // 10))
    q = tsd._f32_ratio(1.0, n) * _h(rng, n) - torch.diag(z)
    q = 0.5 * (q + q.T)
    avail = torch.as_tensor(rng.random(n) < 0.8)
    m = min(max(1, n // 10), int(avail.sum()))
    want = tsd.fedgs_solve(q, avail, m=m, max_sweeps=16)
    tops.reset_launches()
    got = tsd.fedgs_solve(q.to(cuda), avail.to(cuda), m=m, max_sweeps=16)
    launched = tops.launches()
    assert launched["greedy_argmax"] == m and launched["swap_best"] == 16
    assert torch.equal(got.cpu(), want)


def test_vision_engine_on_card_equals_cpu(cuda):
    """small_cnn(width=4) on make_cifar_like(20, 1200): the card run builds
    the oracle 3DG through the staged kernels; a CPU run given the card's
    H selects the same clients every round."""
    ds = make_cifar_like(n_clients=20, n_total=1200, seed=0)
    cfg = FLConfig(rounds=6, sample_frac=0.1, local_steps=10, batch_size=32,
                   lr=0.03, eval_every=1, seed=0)
    mode = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)
    tops.reset_launches()
    card = FLEngine(ds, small_cnn(width=4), FedGSSampler(alpha=1.0), mode,
                    cfg)
    card.install_oracle_graph()
    hc = card.run()
    launched = tops.launches()
    assert all(launched[k] > 0 for k in FEDGS_KERNELS), launched
    assert not torch.backends.cudnn.allow_tf32
    cpu = FLEngine(ds, small_cnn(width=4), FedGSSampler(alpha=1.0), mode,
                   cfg, device="cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    hp = cpu.run()
    assert hc.all_sampled == hp.all_sampled
    np.testing.assert_allclose(hc.val_loss, hp.val_loss, atol=1e-4)


# (B, S, Hq, Hkv, D, dtype, window): chip_smoke's four (smollm's prefill,
# the long window, a window that is not a multiple of the tile, an S that
# is not), then edges: one position, window 1, D = 48 / 192 / 256
WA_SHAPES = [(8, 512, 9, 3, 64, torch.bfloat16, 512),
             (1, 8192, 9, 3, 64, torch.bfloat16, 4096),
             (2, 384, 4, 2, 32, torch.float32, 100),
             (1, 1000, 3, 3, 128, torch.float32, 1000),
             (1, 1, 2, 1, 16, torch.float32, 1),
             (2, 65, 4, 4, 16, torch.float32, 1),
             (1, 130, 2, 2, 48, torch.bfloat16, 63),
             (1, 200, 6, 2, 256, torch.float32, 65),
             (1, 300, 2, 1, 192, torch.bfloat16, 300)] + [
    # the tensor-core body (bf16, D <= 128) at S in {1, 65, 1000}, window
    # in {1, 63, S}
    (2, s, 4, 2, d, torch.bfloat16, w) for d in (16, 32, 64, 128)
    for s in (1, 65, 1000) for w in (1, 63, s)]


def _qkv(rng, b, s, hq, hkv, d, dtype, dev):
    return [torch.as_tensor(rng.normal(size=(b, s, h, d)),
                            dtype=torch.float32).to(dtype).to(dev)
            for h in (hq, hkv, hkv)]


@pytest.mark.parametrize("b,s,hq,hkv,d,dtype,window", WA_SHAPES)
def test_window_attention_kernel_vs_plain(cuda, b, s, hq, hkv, d, dtype,
                                          window):
    q, k, v = _qkv(np.random.default_rng(s + d), b, s, hq, hkv, d, dtype,
                   cuda)
    tops.reset_launches()
    got = tops.window_attention(q, k, v, window=window)
    assert tops.launches()["window_attention"] == 1
    want = twa.window_attention_plain(q, k, v, window=window)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    got, want = got.float().cpu(), want.float().cpu()
    if dtype == torch.float32:
        assert float((got - want).abs().max()) <= 1e-5
    else:
        assert bool(((got - want).abs() <=
                     2.0 ** -7 * want.abs() + 1e-6).all())


def test_window_attention_tensor_cores_on_a_cancelling_row(cuda):
    """The last row's output is the small difference of two large terms
    (tests/test_torch_lm.py: two bf16 terms of p miss the gate there)."""
    q, k, v = (torch.zeros(1, 3, 1, 16) for _ in range(3))
    q[0, 2, 0, 0], q[0, 2, 0, 1] = 1.0, 2.0 ** -10
    k[0, 2, 0, 0], k[0, 1, 0, 1] = 2.34375, 1.0625
    v[0, 0], v[0, 1] = 100.0, -100.0
    q, k, v = (t.to(torch.bfloat16).to(cuda) for t in (q, k, v))
    got = twa.window_attention_cuda(q, k, v, window=3).float().cpu()
    want = twa.window_attention_plain(q, k, v, window=3).float().cpu()
    assert bool(((got - want).abs() <= 2.0 ** -7 * want.abs() + 1e-6).all())


def test_window_attention_kernel_rejects(cuda):
    q = torch.zeros(1, 8, 2, 64, device=cuda)
    for bad, match in [((q[..., :24].contiguous(),) * 3, "multiple of 16"),
                       ((q.transpose(1, 2),) * 3, "contiguous"),
                       ((q, q.half(), q), "float32 or bfloat16"),
                       ((q.double(),) * 3, "float32 or bfloat16")]:
        with pytest.raises(ValueError, match=match):
            twa.window_attention_cuda(*bad, window=4)


def test_prefill_launches_the_kernel_once_per_layer(cuda):
    cfg = get_config("smollm-135m")
    params = tlm.init_params(cfg, seed=0, device=cuda)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)), device=cuda)
    tops.reset_launches()
    logits, cache = tlm.prefill(params, cfg, {"tokens": tokens}, max_len=66)
    assert tops.launches()["window_attention"] == cfg.n_layers == 30
    for _ in range(2):
        logits, cache = tlm.decode_step(params, cfg, logits.argmax(-1),
                                        cache)
    assert tops.launches()["window_attention"] == 30
    assert logits.shape == (2, cfg.padded_vocab)
    assert bool(torch.isfinite(logits.float()).all())


def test_reduced_lm_on_card_equals_cpu(cuda):
    cfg = get_config("smollm-135m").reduced()
    params = tlm.init_params(cfg, seed=0, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 100)))
    out = []
    for dev in (cuda, torch.device("cpu")):
        p = {k: v.to(dev) for k, v in params.items()}
        logits, cache = tlm.prefill(p, cfg, {"tokens": tokens[:, :96].to(dev)},
                                    max_len=100)
        steps = [logits]
        for t in range(96, 99):
            logits, cache = tlm.decode_step(p, cfg, tokens[:, t].to(dev),
                                            cache)
            steps.append(logits)
        out.append(torch.stack(steps).cpu())
    np.testing.assert_allclose(out[0].numpy(), out[1].numpy(), atol=1e-4,
                               rtol=1e-4)
