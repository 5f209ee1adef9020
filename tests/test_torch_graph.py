"""The port's data, availability, fairness and 3DG graph modules against the
JAX package (``repro``) on the CPU.  The kernels against their plain
versions on the card are in ``test_torch_gpu.py``.

Contracts:
* the SSPP copy: bitwise (numpy);
* the staged route (similarity -> adjacency -> Floyd–Warshall) against the
  reference's ``backend="pallas"``: V within rtol 1e-4 / atol 1e-2 (the
  reference's own bound for its kernel against the jnp product), Vn
  returned for every similarity, R and H as below; the port's staged R is
  bitwise its fused R (the same V order and epilogue);
* dataset arrays and availability masks: bitwise (both are numpy);
* Floyd–Warshall: bitwise given the same R;
* R and H from features: identical inf pattern, finite entries within
  rtol 1e-4 (V's f32 sums run in another order than XLA's matmul, and
  exp(-Vn/σ²) multiplies Vn's error by 1/σ² = 100).  Below the smallest
  normal float32, TINY = 1.2e-38, the bound is absolute instead: XLA:CPU's
  float32 exp flushes denormal results to zero where torch keeps them, so
  an edge of R may differ by up to TINY and a path of H (at most N − 1
  edges) by up to N·TINY.  At σ² = 0.01 cosine graphs live entirely in
  that range (max H ≈ 1e-33); the oracle dot graphs do not.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import availability as javail
from repro.core import fairness as jfair
from repro.core import graph as jgraph
from repro.core import graph_device as jgd
from repro.core import sspp as jsspp
from repro.data.synthetic import make_synthetic as jax_make_synthetic
from repro.kernels import ops as jops
from repro.kernels.ref import floyd_warshall_ref as jax_fw_ref

from repro_torch.core import availability as tavail
from repro_torch.core import fairness as tfair
from repro_torch.core import graph as tgraph
from repro_torch.core import graph_device as tgd
from repro_torch.core import sspp as tsspp
from repro_torch.data.synthetic import make_synthetic
from repro_torch.kernels import graph_fused as tgf
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pairwise_similarity as tps
from repro_torch.kernels.ref import (SIM_CHUNK, floyd_warshall_ref,
                                    similarity_ref)

R_RTOL = 1e-4
TINY = float(np.finfo(np.float32).tiny)


@pytest.fixture(scope="module")
def datasets():
    return (jax_make_synthetic(n_clients=30, seed=0),
            make_synthetic(n_clients=30, seed=0))


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _assert_graph_close(got, want, *, paths=False):
    """R (``paths=False``) or H: same inf pattern, finite entries within
    rtol 1e-4, absolute TINY per edge below the normal range."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert not np.isnan(got).any()
    fin = np.isfinite(want)
    atol = TINY * (len(want) if paths else 1)
    np.testing.assert_allclose(got[fin], want[fin], rtol=R_RTOL, atol=atol)


def _adjacency(rng, n):
    r = (rng.random((n, n)) * 10).astype(np.float32)
    r[rng.random((n, n)) < 0.4] = np.inf
    r = np.minimum(r, r.T)
    np.fill_diagonal(r, 0)
    return r


# ------------------------------------------------------------ data + masks
@pytest.mark.parametrize("field", ["x", "y", "sizes", "x_val", "y_val",
                                   "label_dist", "opt_params"])
def test_dataset_bitwise(datasets, field):
    want, got = datasets
    a, b = getattr(want, field), getattr(got, field)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("name", tavail.ALL_MODES)
def test_availability_masks_bitwise(datasets, name):
    ds = datasets[1]
    kw = dict(n_clients=ds.n_clients, data_sizes=ds.sizes,
              label_sets=ds.label_sets(), num_labels=ds.num_classes, seed=99)
    want = javail.host_trace(javail.make_mode(name, **kw), 25, 1234)
    got = tavail.host_trace(tavail.make_mode(name, **kw), 25, 1234)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_force_one_active_bitwise():
    """An all-zero probability row takes the force-one draw in both."""
    p = np.zeros(17)
    for t in range(5):
        want = javail.sample_bernoulli_np(p, javail.host_round_rng(7, t))
        got = tavail.sample_bernoulli_np(p, tavail.host_round_rng(7, t))
        assert np.array_equal(got, want) and got.sum() == 1


@pytest.mark.parametrize("counts", [np.array([0, 3, 1, 7, 7, 2]),
                                    np.zeros(9), np.arange(30) % 4])
def test_fairness_matches_reference(counts):
    assert tfair.count_variance(counts) == jfair.count_variance(counts)
    assert tfair.count_range(counts) == jfair.count_range(counts)
    assert tfair.gini(counts) == jfair.gini(counts)
    c = counts.astype(np.float32)
    for tf, jf in ((tfair.count_variance_device, jfair.count_variance_device),
                   (tfair.count_range_device, jfair.count_range_device),
                   (tfair.gini_device, jfair.gini_device)):
        np.testing.assert_allclose(float(tf(_t(c))), float(jf(jnp.asarray(c))),
                                   rtol=1e-6, atol=1e-7)


# --------------------------------------------------------- Floyd–Warshall
@pytest.mark.parametrize("n", [4, 60, 130])
def test_floyd_warshall_bitwise_vs_reference(rng, n):
    r = _adjacency(rng, n)
    want = np.asarray(jax_fw_ref(jnp.asarray(r)))
    for got in (floyd_warshall_ref(_t(r)), tops.floyd_warshall(_t(r))):
        assert np.array_equal(got.numpy(), want)


def test_floyd_warshall_bitwise_vs_pallas_kernel(rng):
    r = _adjacency(rng, 60)
    want = np.asarray(jops.floyd_warshall(jnp.asarray(r)))
    assert np.array_equal(tops.floyd_warshall(_t(r)).numpy(), want)


@pytest.mark.parametrize("n", [30, 130])
def test_floyd_warshall_bitwise_on_oracle_adjacency(n):
    """Given JAX's R of the oracle 3DG, the port's APSP is JAX's H bit for
    bit (denormal edge weights included)."""
    ds = jax_make_synthetic(n_clients=n, seed=0)
    _, r, h = jgraph.build_3dg(ds.opt_params)
    assert np.array_equal(tops.floyd_warshall(_t(r)).numpy(), h)


@pytest.mark.parametrize("n", [31, 32, 33, 65, 129])
def test_floyd_warshall_bitwise_at_tile_edges(rng, n):
    """Around the blocked plan's pivot blocks of 32 and 64."""
    r = _adjacency(rng, n)
    want = np.asarray(jax_fw_ref(jnp.asarray(r)))
    assert np.array_equal(tops.floyd_warshall(_t(r)).numpy(), want)


def _sensitive_adjacency(n=130, seed=0):
    """A directed adjacency, 40% of entries inf, weights in [0, 10): the
    fixture on which the two blocked orders below part."""
    rng = np.random.default_rng(seed)
    r = (rng.random((n, n)) * 10).astype(np.float32)
    r[rng.random((n, n)) < 0.4] = np.inf
    np.fill_diagonal(r, 0)
    return torch.from_numpy(r)


def _blocked_order(h, t, *, snapshots):
    """A plain model of the CUDA kernel's blocked plan with pivot blocks of
    t: per block, the pivot rows and columns step through the block's
    pivots k ascending, then every other cell steps through them with h_ik
    and h_kj read from the snapshots (their values at step k) or, with
    ``snapshots=False``, from the final pivot panels (the TPU kernel's
    order)."""
    h = h.clone()
    n = h.shape[0]
    for k0 in range(0, n, t):
        ks = range(k0, min(n, k0 + t))
        inb = torch.zeros(n, dtype=torch.bool)
        inb[k0:k0 + t] = True
        snaps = []
        for k in ks:
            col, row = h[:, k].clone(), h[k, :].clone()
            snaps.append((col, row))
            h[inb, :] = torch.minimum(h[inb, :], col[inb, None] + row[None, :])
            h[:, inb] = torch.minimum(h[:, inb], col[:, None] + row[None, inb])
        rest = torch.nonzero(~inb)[:, 0]
        sub = h[rest[:, None], rest[None, :]]
        for k, (col, row) in zip(ks, snaps):
            if not snapshots:
                col, row = h[:, k], h[k, :]
            sub = torch.minimum(sub, col[rest, None] + row[None, rest])
        h[rest[:, None], rest[None, :]] = sub
    return h


@pytest.mark.parametrize("t", [32, 64])
def test_blocked_order_with_snapshots_is_the_per_pivot_order(t):
    """The kernel's blocked order is bitwise the per-pivot reference (the
    port's and repro's); the final-panel order is not, on this fixture, so
    the bitwise gate on the card can tell the two apart."""
    r = _sensitive_adjacency()
    want = floyd_warshall_ref(r)
    assert np.array_equal(want.numpy(), np.asarray(jax_fw_ref(jnp.asarray(
        r.numpy()))))
    assert torch.equal(_blocked_order(r, t, snapshots=True), want)
    assert not torch.equal(_blocked_order(r, t, snapshots=False), want)


def test_floyd_warshall_disconnected_stays_inf():
    r = np.full((8, 8), np.inf, np.float32)
    np.fill_diagonal(r, 0)
    r[0, 1] = r[1, 0] = 1.0
    h = tops.floyd_warshall(_t(r)).numpy()
    assert h[0, 1] == 1.0 and np.isinf(h[0, 7])


# ---------------------------------------------------- similarity + adjacency
@pytest.mark.parametrize("n,d", [(10, 3), (50, 300)])
def test_similarity_ref_vs_reference(rng, n, d):
    u = rng.normal(size=(n, d)).astype(np.float32)
    np.testing.assert_allclose(similarity_ref(_t(u)).numpy(), u @ u.T,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("d", [1, SIM_CHUNK - 1, SIM_CHUNK, SIM_CHUNK + 1,
                               3 * SIM_CHUNK + 5])
def test_similarity_ref_follows_the_chunked_order(rng, d):
    """similarity_ref is bitwise an explicit float32 loop in the order the
    kernels follow: per chunk of SIM_CHUNK columns a partial p = p + a·b
    in ascending k from 0, the partials added in ascending order from 0;
    for d <= SIM_CHUNK that is one ascending sum."""
    u = rng.normal(size=(9, d)).astype(np.float32)
    v = np.zeros((9, 9), np.float32)
    for c0 in range(0, d, SIM_CHUNK):
        p = np.zeros((9, 9), np.float32)
        for k in range(c0, min(d, c0 + SIM_CHUNK)):
            p = p + u[:, k:k + 1] * u[:, k]
        v = v + p
    got = similarity_ref(_t(u)).numpy()
    assert np.array_equal(got, v)
    if d <= SIM_CHUNK:
        one = np.zeros((9, 9), np.float32)
        for k in range(d):
            one = one + u[:, k:k + 1] * u[:, k]
        assert np.array_equal(got, one)


def test_similarity_chunk_is_the_kernels():
    """SIM_CHUNK mirrors the one constant the CUDA kernels sum by."""
    src = (Path(tgf.__file__).parent / "csrc" / "common.cuh").read_text()
    assert re.findall(r"constexpr int KS = (\d+);", src) == [str(SIM_CHUNK)]


@pytest.mark.parametrize("n", [7, 100, 130])
def test_fused_adjacency_plain_vs_pallas(rng, n):
    u = rng.normal(size=(n, 16)).astype(np.float32)
    want = np.asarray(jops.fused_adjacency(jnp.asarray(u), eps=0.1,
                                           sigma2=0.01))
    got, stats = tgf.fused_adjacency(_t(u), eps=0.1, sigma2=0.01)
    _assert_graph_close(got.numpy(), want)
    v = u.astype(np.float64) @ u.T.astype(np.float64)
    np.testing.assert_allclose(stats.numpy(), [v.min(), v.max()], rtol=1e-5)
    assert np.array_equal(tops.fused_adjacency(_t(u), eps=0.1,
                                               sigma2=0.01).numpy(),
                          got.numpy())


def _fused_order(u, *, eps, sigma2, clamp, plan):
    """A plain model of the fused kernel's order: V's upper triangle in the
    chunked order (``plan="tiles"``: 32 x 32 tiles, each tile's partials
    per chunk over its row blocks, as the tile kernels; ``"entries"``: one
    chain per (upper entry, chunk), the partials then added in ascending
    chunk order, as the small plan), each value (clamped) written raw
    into R's own buffer at (i, j) and (j, i), lo/hi folded per tile or per
    block of entries, then the epilogue turns R's V into R in place."""
    n, d = u.shape
    r = torch.empty((n, n), dtype=torch.float32)
    lo, hi = torch.tensor(float("inf")), torch.tensor(float("-inf"))
    chunks = range(0, max(d, 1), SIM_CHUNK)

    def chained(a, b):
        v = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]))
        for c0 in chunks:
            p = torch.zeros_like(v)
            for k in range(c0, min(d, c0 + SIM_CHUNK)):
                p = p + a[..., k] * b[..., k]
            v = v + p
        return torch.clamp_min(v, 0.0) if clamp else v

    if plan == "tiles":
        for i0 in range(0, n, 32):
            for j0 in range(i0, n, 32):
                v = chained(u[i0:i0 + 32, None, :], u[None, j0:j0 + 32, :])
                r[i0:i0 + 32, j0:j0 + 32] = v
                r[j0:j0 + 32, i0:i0 + 32] = v.T
                lo, hi = torch.minimum(lo, v.min()), torch.maximum(hi, v.max())
    else:
        iu, ju = torch.triu_indices(n, n)
        for e0 in range(0, len(iu), 21):
            i, j = iu[e0:e0 + 21], ju[e0:e0 + 21]
            v = chained(u[i], u[j])
            r[i, j] = v
            r[j, i] = v
            lo, hi = torch.minimum(lo, v.min()), torch.maximum(hi, v.max())
    vn = (r - lo) / torch.clamp_min(hi - lo, 1e-12)
    return tgd.to_adjacency(vn, eps=eps, sigma2=sigma2), torch.stack([lo, hi])


@pytest.mark.parametrize("plan", ["tiles", "entries"])
@pytest.mark.parametrize("clamp", [False, True])
@pytest.mark.parametrize("n,d", [(30, 610), (100, 10), (130, 610)])
def test_fused_order_model_is_the_plain_version(n, d, clamp, plan):
    """Raw V written in place, lo/hi folded per tile (or block of entries),
    then the epilogue: bitwise fused_adjacency_plain, R and stats, with the
    functional similarity's clamp on and off."""
    rng = np.random.default_rng(n + d)
    mu = rng.normal(0.0, np.sqrt(0.5), (n, 1))
    u = torch.as_tensor(rng.normal(mu, 1.0, (n, d)), dtype=torch.float32)
    if clamp:
        u = u - u.mean(0)                    # some similarities below 0
    got_r, got_s = _fused_order(u, eps=0.1, sigma2=0.01, clamp=clamp,
                                plan=plan)
    want_r, want_s = tgf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01,
                                               clamp=clamp)
    assert torch.equal(got_s, want_s)
    assert torch.equal(got_r, want_r)
    assert bool(torch.isinf(want_r).any()) and bool(torch.isfinite(want_r).any())


@pytest.mark.parametrize("n", [7, 100, 130])
def test_build_3dg_fused_vs_pallas(rng, n):
    u = rng.normal(size=(n, 16)).astype(np.float32)
    jr, jh = jops.build_3dg_fused(jnp.asarray(u), eps=0.1, sigma2=0.01)
    r, h = tops.build_3dg_fused(_t(u), eps=0.1, sigma2=0.01)
    _assert_graph_close(r.numpy(), jr)
    _assert_graph_close(h.numpy(), jh, paths=True)


@pytest.mark.parametrize("n", [30, 130])
def test_oracle_3dg_vs_reference(n):
    """The quickstart's oracle 3DG (features = local optima, (N, 610))."""
    ds = jax_make_synthetic(n_clients=n, seed=0)
    jv, jr, jh = jgraph.build_3dg(ds.opt_params)
    tv, tr, th = tgraph.build_3dg(ds.opt_params, device="cpu")
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-6)
    _assert_graph_close(tr, jr)
    _assert_graph_close(th, jh, paths=True)
    # edge weights reach the denormal range: flush-to-zero would show here
    fin = np.isfinite(tr) & ~np.eye(n, dtype=bool)
    assert tr[fin].min() > 0


@pytest.mark.parametrize("sim", ["dot", "cosine", "functional"])
def test_build_h_vs_reference(rng, sim):
    """The capped H first, then the [0, 1]-normalized H: normalizing by the
    max carries the absolute bound N·TINY up to N·TINY / max H."""
    u = jnp.asarray(rng.normal(size=(67, 8)).astype(np.float32))
    raw = {}
    for normalize in (False, True):
        cfg_j = jgd.GraphConfig(similarity=sim, normalize=normalize)
        cfg_t = tgd.GraphConfig(similarity=sim, normalize=normalize)
        want = np.asarray(jgd.build_h(u, cfg_j, backend="ref"))
        got = tgd.build_h(_t(u), cfg_t).numpy()
        if not normalize:
            raw = want
            _assert_graph_close(got, want, paths=True)
        else:
            np.testing.assert_allclose(got, want, rtol=R_RTOL,
                                       atol=len(raw) * TINY / raw.max())


def test_build_3dg_precomputed_vs_reference(rng):
    v = rng.normal(size=(40, 40)).astype(np.float32)
    v = 0.5 * (v + v.T)
    cfg_j = jgd.GraphConfig(similarity="precomputed")
    cfg_t = tgd.GraphConfig(similarity="precomputed")
    jvn, jr, jh = jgd.build_3dg(jnp.asarray(v), cfg_j)
    tvn, tr, th = tgd.build_3dg(_t(v), cfg_t)
    np.testing.assert_allclose(tvn.numpy(), jvn, rtol=1e-6, atol=1e-7)
    _assert_graph_close(tr.numpy(), jr)
    _assert_graph_close(th.numpy(), jh, paths=True)


def test_to_adjacency_high_eps_no_nan(rng):
    """eps so high most edges drop: inf no-edge entries never leak NaN onto
    the diagonal (the inf·0 hazard of multiplying by 1 − eye)."""
    u = rng.normal(size=(33, 16)).astype(np.float32)
    r = tops.fused_adjacency(_t(u), eps=0.95, sigma2=0.01).numpy()
    assert not np.isnan(r).any()
    assert np.array_equal(np.diag(r), np.zeros(33, np.float32))
    vn = tgd.minmax01(_t(u) @ _t(u).T)
    vn[3, 3] = 0.0                       # self-similarity below eps
    assert tgd.to_adjacency(vn, eps=0.5)[3, 3] == 0.0


def test_fused_pipeline_disconnected_clusters(rng):
    n = 20
    u = np.zeros((2 * n, 4), np.float32)
    u[:n, 0] = 1.0 + 0.1 * rng.random(n).astype(np.float32)
    u[n:, 1] = 1.0 + 0.1 * rng.random(n).astype(np.float32)
    _, h = tops.build_3dg_fused(_t(u), eps=0.1, sigma2=0.01)
    h = h.numpy()
    assert np.all(np.isinf(h[:n, n:])) and np.all(np.isinf(h[n:, :n]))
    assert np.all(np.isfinite(h[:n, :n])) and np.all(np.isfinite(h[n:, n:]))


@pytest.mark.parametrize("normalize", [True, False])
def test_cap_and_normalize_bitwise(rng, normalize):
    h = (rng.random((25, 25)) * 3).astype(np.float32)
    h[rng.random((25, 25)) < 0.3] = np.inf
    want = np.asarray(jgd.cap_and_normalize(jnp.asarray(h), scale=2.0,
                                            normalize=normalize))
    got = tgd.cap_and_normalize(_t(h), scale=2.0, normalize=normalize)
    assert np.array_equal(got.numpy(), want)
    if not normalize:
        assert np.array_equal(tgraph.finite_cap(h, device="cpu"),
                              jgraph.finite_cap(h))


@pytest.mark.parametrize("fn", ["build_3dg", "finite_cap", "normalize_01",
                                "oracle_similarity",
                                "update_cosine_similarity",
                                "functional_similarity",
                                "similarity_to_adjacency", "shortest_paths"])
def test_graph_face_without_device_raises_when_cuda_is_absent(monkeypatch,
                                                              fn):
    """The numpy face runs on CUDA unless asked for the CPU: with no CUDA
    and no device it raises, never falling back silently."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(tgraph, fn)(np.ones((4, 4), np.float32))


# ------------------------------------------------------- the staged route
@pytest.mark.parametrize("n,d", [(7, 3), (100, 13), (130, 200)])
def test_pairwise_similarity_vs_pallas(rng, n, d):
    """V within rtol 1e-4 / atol 1e-2 of the Pallas kernel (the bound
    tests/test_kernels.py holds it to against u @ u.T: the sums run in
    another order); bitwise the fused kernel's order."""
    u = rng.normal(size=(n, d)).astype(np.float32)
    want = np.asarray(jops.pairwise_similarity(jnp.asarray(u)))
    got = tops.pairwise_similarity(_t(u)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)
    assert np.array_equal(got, similarity_ref(_t(u)).numpy())


@pytest.mark.parametrize("n,eps", [(7, 0.1), (100, 0.1), (130, 0.1),
                                   (100, 0.95)])
def test_similarity_to_adjacency_vs_pallas(rng, n, eps):
    """The same raw V into both: the same inf pattern, a 0 diagonal, finite
    R within rtol 1e-4 (TINY absolute below the normal range)."""
    u = rng.normal(size=(n, 16)).astype(np.float32)
    v = u @ u.T
    want = np.asarray(jops.similarity_to_adjacency(jnp.asarray(v), eps=eps,
                                                   sigma2=0.01))
    got = tops.similarity_to_adjacency(_t(v), eps=eps, sigma2=0.01).numpy()
    _assert_graph_close(got, want)
    assert np.array_equal(np.diag(got), np.zeros(n, np.float32))


def _adjacency_walk(n, width, head_bytes, threads=256):
    """The adjacency kernel's walk over the flat n x n array, modelled in
    numpy (csrc/similarity.cuh adjacency_kernel): a thread for every
    access, ceil(ceil(n² / width) / 256) blocks of 256.  On 16-byte
    vectors (``width`` 4), a scalar head up to v's first 16-byte boundary
    (``head_bytes`` its offset; its diagonal entry f = 0) and a scalar tail
    (its diagonal entry f = n² − 1), thread t taking head entry t and tail
    entry t; between them, or over every entry (``width`` 1), thread t
    takes access t, with its first entry's residue f % (n + 1).
    Returns (visits per entry, the diagonal flag each entry got)."""
    nn, np1 = n * n, n + 1
    head = min(nn, (16 - head_bytes) % 16 // 4) if width == 4 else 0
    nvec = (nn - head) // width
    tail = head + width * nvec
    visits = np.zeros(nn, np.int64)
    diag = np.zeros(nn, bool)
    t = np.arange(max(1, -(-(-(-nn // width)) // threads)) * threads)
    for f in t[t < head]:
        visits[f] += 1
        diag[f] = f == 0
    for f in tail + t[t < nn - tail]:
        visits[f] += 1
        diag[f] = f == nn - 1
    on = t[t < nvec]
    q = (head + width * on) % np1
    for k in range(width):
        f = head + width * on + k
        visits[f] += 1
        diag[f] = (q == 0) if k == 0 else (q + k == np1)
    return visits, diag


@pytest.mark.parametrize("n", [1, 2, 3, 31, 33, 34, 130, 513, 1024])
def test_adjacency_walk_visits_each_entry_once(n):
    """Every entry once, the diagonal exactly where f % (n + 1) == 0, on
    single entries and on 16-byte vectors at any alignment of V."""
    for width, head_bytes in ((1, 0), (4, 0), (4, 4), (4, 8), (4, 12)):
        visits, diag = _adjacency_walk(n, width, head_bytes)
        assert (visits == 1).all(), (width, head_bytes)
        assert np.array_equal(diag, np.arange(n * n) % (n + 1) == 0)


def test_adjacency_grid_has_a_thread_for_every_access():
    """Single entries up to 2^18 of them (N = 512), then 16-byte vectors,
    a thread for each, 256 a block, at every N."""
    assert [tps.adjacency_grid(n) for n in (0, 1, 30, 100, 130, 367, 512,
                                            513, 1024, 4096, 8191, 8192,
                                            46340)] == \
        [(1, 1), (1, 1), (1, 4), (1, 40), (1, 67), (1, 527), (1, 1024),
         (4, 258), (4, 1024), (4, 16384), (4, 65521), (4, 65536),
         (4, 2097067)]
    assert tps.ADJ_THREADS == 256 and tps.ADJ_ENTRIES_MOST == 1 << 18


@pytest.mark.parametrize("n", [7, 130])
def test_build_3dg_kernel_vs_pallas(rng, n):
    """ops.build_3dg_kernel, the staged (V, R, H), against the
    reference's."""
    u = rng.normal(size=(n, 24)).astype(np.float32)
    jv, jr, jh = jops.build_3dg_kernel(jnp.asarray(u))
    tv, tr, th = tops.build_3dg_kernel(_t(u))
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-4, atol=1e-2)
    _assert_graph_close(tr.numpy(), jr)
    _assert_graph_close(th.numpy(), jh, paths=True)


def _graph_input(rng, sim):
    if sim == "precomputed":
        v = rng.normal(size=(40, 40)).astype(np.float32)
        return 0.5 * (v + v.T)
    return rng.normal(size=(67, 8)).astype(np.float32)


@pytest.mark.parametrize("sim", ["dot", "cosine", "functional",
                                 "precomputed"])
def test_build_3dg_staged_vs_pallas(rng, sim):
    """Vn returned for every similarity (the reference returns it on every
    backend), R and H under the graph contract."""
    x = _graph_input(rng, sim)
    jvn, jr, jh = jgd.build_3dg(jnp.asarray(x),
                                jgd.GraphConfig(similarity=sim),
                                backend="pallas")
    tvn, tr, th = tgd.build_3dg(_t(x), tgd.GraphConfig(similarity=sim))
    np.testing.assert_allclose(tvn.numpy(), jvn, rtol=1e-4, atol=1e-6)
    _assert_graph_close(tr.numpy(), jr)
    _assert_graph_close(th.numpy(), jh, paths=True)


@pytest.mark.parametrize("sim", ["dot", "cosine", "functional",
                                 "precomputed"])
def test_build_3dg_takes_the_staged_kernels(monkeypatch, rng, sim):
    """build_3dg goes through the staged kernel wrappers on every device
    (on CUDA they launch B5a, B5b and Floyd–Warshall) and returns Vn, also
    for a precomputed V; the numpy face returns V."""
    calls = []
    for name in ("pairwise_similarity", "similarity_to_adjacency",
                 "floyd_warshall"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    x = _graph_input(rng, sim)
    vn, r, h = tgd.build_3dg(_t(x), tgd.GraphConfig(similarity=sim))
    want = ["similarity_to_adjacency", "floyd_warshall"]
    assert calls == (want if sim == "precomputed"
                     else ["pairwise_similarity"] + want)
    assert vn.shape == r.shape == h.shape == (len(x), len(x))
    v, _, _ = tgraph.build_3dg(x, sim_kind=sim, device="cpu")
    assert isinstance(v, np.ndarray) and np.array_equal(v, vn.numpy())


@pytest.mark.parametrize("sim", ["dot", "functional", "precomputed"])
def test_build_h_routes(monkeypatch, rng, sim):
    """build_h: fused for a feature similarity, staged for a precomputed
    V, as the reference's ``graph_device.build_h``."""
    calls = []
    for name in ("build_3dg_fused", "similarity_to_adjacency"):
        fn = getattr(tops, name)
        monkeypatch.setattr(tops, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    tgd.build_h(_t(_graph_input(rng, sim)), tgd.GraphConfig(similarity=sim))
    assert calls == (["similarity_to_adjacency"] if sim == "precomputed"
                     else ["build_3dg_fused"])


@pytest.mark.parametrize("n", [7, 100, 130])
@pytest.mark.parametrize("sim", ["dot", "cosine", "functional"])
def test_staged_r_and_h_bitwise_fused(rng, n, sim):
    """The staged route's R is bitwise the fused route's (the same V order
    and the same epilogue), so build_h's H is bitwise cap(staged H)."""
    u = _t(rng.normal(size=(n, 16)).astype(np.float32))
    cfg = tgd.GraphConfig(similarity=sim)
    _, r_staged, h_staged = tgd.build_3dg(u, cfg)
    r_fused, _ = tops.build_3dg_fused(tgd._features(u, cfg), eps=cfg.eps,
                                      sigma2=cfg.sigma2,
                                      clamp=sim == "functional")
    assert torch.equal(r_staged, r_fused)
    assert torch.equal(tgd.build_h(u, cfg), tgd.cap_and_normalize(h_staged))


# -------------------------------------------------------------------- SSPP
def test_sspp_copy_bitwise(rng):
    feats = rng.normal(size=(9, 5))
    for seed in (0, 3):
        assert np.array_equal(tsspp.secure_similarity_matrix(feats, seed=seed),
                              jsspp.secure_similarity_matrix(feats, seed=seed))
    tj, tt = [], []
    a, b = rng.normal(size=16), rng.normal(size=16)
    assert tsspp.secure_dot(a, b, seed=7, transcript=tt) == \
        jsspp.secure_dot(a, b, seed=7, transcript=tj)
    assert all(np.array_equal(x, y) for x, y in zip(tt, tj))


def test_sspp_precomputed_3dg_vs_reference():
    """SSPP's V over the label distributions (paper Appendix D) builds a
    precomputed 3DG: the same as the reference's, under the graph
    contract."""
    ds = jax_make_synthetic(n_clients=30, seed=0)
    v = jsspp.secure_similarity_matrix(ds.label_dist, seed=0)
    jv, jr, jh = jgraph.build_3dg(v, sim_kind="precomputed",
                                  backend="pallas")
    tv, tr, th = tgraph.build_3dg(tsspp.secure_similarity_matrix(
        ds.label_dist, seed=0), sim_kind="precomputed", device="cpu")
    np.testing.assert_allclose(tv, jv, rtol=1e-4, atol=1e-6)
    _assert_graph_close(tr, jr)
    _assert_graph_close(th, jh, paths=True)


# ------------------------------------------------- similarity sources, F1
@pytest.mark.parametrize("fn", ["normalize_01", "oracle_similarity/dot",
                                "oracle_similarity/cosine",
                                "update_cosine_similarity",
                                "functional_similarity",
                                "similarity_to_adjacency", "shortest_paths"])
def test_graph_face_vs_reference(rng, fn):
    """The numpy face against ``repro.core.graph``: similarities within
    f32 round-off (rtol 1e-4 / atol 1e-6), adjacency under the graph
    contract, APSP bitwise given the same R."""
    feats = rng.random((30, 10)).astype(np.float32)
    if fn == "shortest_paths":
        r = _adjacency(rng, 30)
        assert np.array_equal(tgraph.shortest_paths(r, device="cpu"),
                              jgraph.shortest_paths(r))
        return
    if fn == "similarity_to_adjacency":
        vn = jgraph.oracle_similarity(feats)
        _assert_graph_close(tgraph.similarity_to_adjacency(vn, device="cpu"),
                            jgraph.similarity_to_adjacency(vn))
        return
    name, _, kind = fn.partition("/")
    kw = {"kind": kind} if kind else {}
    x = feats if name != "update_cosine_similarity" else \
        rng.normal(size=(30, 50)).astype(np.float32)
    got = getattr(tgraph, name)(x, device="cpu", **kw)
    want = getattr(jgraph, name)(x, **kw)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_edge_f1_matches_reference(rng):
    r_true = _adjacency(rng, 25)
    for _ in range(3):
        r_pred = _adjacency(rng, 25)
        assert tgraph.edge_f1(r_pred, r_true) == jgraph.edge_f1(r_pred, r_true)
    assert tgraph.edge_f1(r_true, r_true)[2] == pytest.approx(1.0)
