"""The port's FedGS solver against the JAX package on the CPU.  The solver
kernels against their plain versions on the card are in
``test_torch_gpu.py``.

Contracts:
* ``q_diag`` / ``q_row`` and ``greedy_argmax``: bitwise (value and index),
  including exact ties, NaN and the all-masked lane; with a ``taken`` set
  (the greedy step's S, which the kernel reads itself) bitwise the
  reference's ``greedy_argmax`` on ``mask & ~taken``;
* ``swap_best_fused`` and the dense ``swap_best``: (best, rank, j) bitwise
  whenever best > −1e18/2, NaN entries included; ``swap_best_fused`` also
  on a panel with no column to swap in ((−1e18, 0, 0)) and on one of equal
  deltas (rank 0, column 0), the edges its CUDA kernel is held to.
  The fixtures use H with a zero diagonal, as every H from
  ``cap_and_normalize`` has: XLA:CPU contracts a·H_kk − z_k into an FMA
  under jit (DESIGN assumption #23), so a nonzero diagonal can differ by
  one ulp for a reason that is not the port's;
* FedGS selected sets: identical given the same (H, counts, A_t, α, m,
  m_target), on the port's Q-free route and on its dense one; given the
  same dense Q, ``fedgs_solve``'s kernel route (its plain versions here)
  selects the reference's ``backend="pallas"`` sets;
* the MD and PoC samplers draw from torch generators: shape, support and
  rate checks, and PoC's deterministic step (top-m by loss among the
  candidates) equal to the reference's given the same candidates.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import sampler as jsampler
from repro.core.sampler_device import _fedgs_select, _fedgs_solve
from repro.core.sampler_device import md_select as jax_md_select
from repro.core.sampler_device import select_k as jax_select_k
from repro.kernels import ops as jops
from repro.kernels import solver as jsolver

from repro_torch.core import sampler as tsampler
from repro_torch.core import sampler_device as tsd
from repro_torch.core.sampler import (FedGSSampler, MDSampler,
                                      PowerOfChoiceSampler, UniformSampler,
                                      make_sampler)
from repro_torch.kernels import ops as tops
from repro_torch.kernels import solver as tsolver

NEG = -1e18


def _t(a):
    return torch.as_tensor(np.array(a, copy=True))


def _h(rng, n, *, integer=False):
    h = (rng.integers(0, 3, (n, n)) if integer else rng.random((n, n)))
    h = h.astype(np.float32)
    h = 0.5 * (h + h.T)
    np.fill_diagonal(h, 0)
    return h


def _rand_q(rng, n):
    q = rng.random((n, n)).astype(np.float32)
    q = 0.5 * (q + q.T)
    q -= np.diag(rng.normal(size=n).astype(np.float32))
    return q


def _z(rng, n):
    return rng.normal(size=n).astype(np.float32)


# ----------------------------------------------------- factored-Q providers
def test_q_diag_and_rows_bitwise(rng):
    n = 37
    h, z, al = _h(rng, n), _z(rng, n), float(np.float32(1.3) / np.float32(n))
    assert np.array_equal(tsolver.q_diag(_t(h), _t(z), al).numpy(),
                          np.asarray(jsolver.q_diag(jnp.asarray(h),
                                                    jnp.asarray(z), al)))
    for k in (0, 5, n - 1):
        got = tsolver.q_row(_t(h), _t(z), al, torch.tensor(k)).numpy()
        want = np.asarray(jsolver.q_row(jnp.asarray(h), jnp.asarray(z), al, k))
        assert np.array_equal(got, want)


# ----------------------------------------------------------- greedy argmax
def _greedy_cases(rng):
    n = 300
    diag = rng.normal(size=n).astype(np.float32)
    r = rng.normal(size=n).astype(np.float32)
    mask = rng.random(n) < 0.6
    yield "random", diag, r, mask
    yield "ties", np.ones(n, np.float32), np.zeros(n, np.float32), mask
    nan_d = diag.copy()
    nan_d[[3, 17, 40]] = np.nan
    yield "nan", nan_d, r, np.ones(n, bool)
    yield "all_masked", diag, r, np.zeros(n, bool)
    yield "ragged", diag[:7], r[:7], mask[:7]


@pytest.mark.parametrize("case", ["random", "ties", "nan", "all_masked",
                                  "ragged"])
def test_greedy_argmax_bitwise_vs_pallas(rng, case):
    _, diag, r, mask = next(c for c in _greedy_cases(rng) if c[0] == case)
    jv, ji = jops.greedy_argmax(jnp.asarray(diag), jnp.asarray(r),
                                jnp.asarray(mask))
    tv, ti = tops.greedy_argmax(_t(diag), _t(r), _t(mask))
    assert np.asarray(tv).tobytes() == np.asarray(jv, np.float32).tobytes()
    assert int(ti) == int(ji)
    if case == "all_masked":
        assert float(tv) == np.float32(NEG) and int(ti) == 0


@pytest.mark.parametrize("case", ["random", "ties", "nan", "all_masked",
                                  "ragged", "taken_covers_avail"])
def test_greedy_argmax_with_taken_bitwise_vs_pallas(rng, case):
    """greedy_argmax(diag, r, mask, taken) and its plain version against the
    reference's greedy_argmax on mask & ~taken: the same (value, index)."""
    if case == "taken_covers_avail":
        _, diag, r, mask = next(c for c in _greedy_cases(rng)
                                if c[0] == "random")
        taken = mask.copy()
    else:
        _, diag, r, mask = next(c for c in _greedy_cases(rng) if c[0] == case)
        taken = rng.random(len(diag)) < 0.3
    jv, ji = jops.greedy_argmax(jnp.asarray(diag), jnp.asarray(r),
                                jnp.asarray(mask & ~taken))
    for tv, ti in (tops.greedy_argmax(_t(diag), _t(r), _t(mask), _t(taken)),
                   tsolver.masked_argmax_plain(_t(diag), _t(r), _t(mask),
                                               _t(taken))):
        assert np.asarray(tv).tobytes() == np.asarray(jv, np.float32).tobytes()
        assert int(ti) == int(ji)
    if case in ("all_masked", "taken_covers_avail"):
        assert float(jv) == np.float32(NEG) and int(ji) == 0


@pytest.mark.parametrize("case", ["7", "fewer_than_m"])
def test_solve_kernel_hands_avail_and_s_to_the_greedy_step(rng, monkeypatch,
                                                           case):
    """Each greedy step passes A_t and S to greedy_argmax (no mask op of its
    own), and the Q-free solve still selects the reference's set."""
    h, counts, avail, alpha, m, mt, sweeps = _fedgs_case(rng, case)
    calls = []
    real = tops.greedy_argmax

    def spy(diag, r, mask, taken=None):
        calls.append((mask.clone(), None if taken is None else taken.clone()))
        return real(diag, r, mask, taken)

    monkeypatch.setattr(tops, "greedy_argmax", spy)
    got = _port_select(h, counts, avail, alpha, m, mt, sweeps)
    want = _jax_select(h, counts, avail, alpha, m, mt, "ref", sweeps)
    assert np.array_equal(got, want)
    assert len(calls) == m
    for step, (mask, taken) in enumerate(calls):
        assert np.array_equal(mask.numpy(), avail)
        assert taken is not None and int(taken.sum()) == step


# -------------------------------------------------------------- swap sweep
def _swap_inputs(rng, n, m, *, integer=False, pad=0):
    h = _h(rng, n, integer=integer)
    z = _z(rng, n) if not integer else rng.integers(-2, 3, n).astype(np.float32)
    s = np.zeros(n, bool)
    s[rng.choice(n, m, replace=False)] = True
    avail = rng.random(n) < 0.7
    sel = np.sort(np.flatnonzero(s))
    sel = np.concatenate([sel, np.full(pad, n - 1)])
    valid = np.arange(len(sel)) < m
    rr = rng.normal(size=n).astype(np.float32)
    a = np.where(valid, (-2.0 * rr + 0.1)[sel], NEG).astype(np.float32)
    b = np.where(~s & avail, 2.0 * rr + 0.1, NEG).astype(np.float32)
    return h, z, sel, valid, a, b


# the last two cases pin the contract the CUDA kernel is held to on its
# edges: no column to swap in (b all −1e18: every delta is −1e18, the lowest
# flat index wins) and equal deltas everywhere (rank 0, column 0)
@pytest.mark.parametrize("n,m,integer,pad,case", [
    pytest.param(7, 2, False, 0, "random", id="7-2-False-0"),
    pytest.param(100, 10, False, 0, "random", id="100-10-False-0"),
    pytest.param(130, 13, False, 3, "random", id="130-13-False-3"),
    pytest.param(52, 9, True, 0, "random", id="52-9-True-0"),
    pytest.param(30, 6, False, 2, "all_masked", id="30-6-all_masked"),
    pytest.param(30, 6, False, 2, "all_equal", id="30-6-all_equal")])
def test_swap_best_fused_bitwise_vs_pallas(rng, n, m, integer, pad, case):
    h, z, sel, valid, a, b = _swap_inputs(rng, n, m, integer=integer, pad=pad)
    if case == "all_masked":
        b = np.full(n, NEG, np.float32)
    elif case == "all_equal":
        h = np.full((n, n), 0.25, np.float32)
        z = np.zeros(n, np.float32)
        valid = np.ones(len(sel), bool)
        a = np.full(len(sel), 1.5, np.float32)
        b = np.full(n, -0.5, np.float32)
    al = 1.0 if integer else float(np.float32(1.3) / np.float32(n))
    jb, jr, jj = jops.swap_best_fused(jnp.asarray(h), jnp.asarray(z),
                                      jnp.float32(al), jnp.asarray(sel),
                                      jnp.asarray(valid), jnp.asarray(a),
                                      jnp.asarray(b))
    tb, tr, tj = tops.swap_best_fused(_t(h), _t(z), al, _t(sel), _t(valid),
                                      _t(a), _t(b))
    if case == "all_masked":
        assert (float(tb), int(tr), int(tj)) == (float(np.float32(NEG)), 0, 0)
    else:
        assert float(jb) > NEG / 2
    if case == "all_equal":
        assert (int(tr), int(tj)) == (0, 0)
    assert np.asarray(tb).tobytes() == np.asarray(jb, np.float32).tobytes()
    assert (int(tr), int(tj)) == (int(jr), int(jj))


def test_swap_best_fused_nan_entries(rng):
    n, m = 40, 5
    h, z, sel, valid, a, b = _swap_inputs(rng, n, m)
    h[:, 11] = np.nan
    al = float(np.float32(1.0) / np.float32(n))
    args_j = (jnp.asarray(h), jnp.asarray(z), jnp.float32(al),
              jnp.asarray(sel), jnp.asarray(valid), jnp.asarray(a),
              jnp.asarray(b))
    jb, jr, jj = jops.swap_best_fused(*args_j)
    tb, tr, tj = tops.swap_best_fused(_t(h), _t(z), al, _t(sel), _t(valid),
                                      _t(a), _t(b))
    assert int(tj) != 11
    assert np.asarray(tb).tobytes() == np.asarray(jb, np.float32).tobytes()
    assert (int(tr), int(tj)) == (int(jr), int(jj))


# ------------------------------------------------------------- FedGS solver
def _jax_select(h, counts, avail, alpha, m, m_target, backend, sweeps):
    return np.asarray(_fedgs_select(
        jnp.asarray(h), jnp.asarray(counts), jnp.asarray(avail),
        jnp.float32(alpha), m=m, max_sweeps=sweeps, m_target=m_target,
        backend=backend))


def _port_select(h, counts, avail, alpha, m, m_target, sweeps):
    """The port's Q-free route (the one FedGSSampler takes)."""
    return tsd.fedgs_select(_t(h), _t(counts), _t(avail), alpha, m=m,
                            max_sweeps=sweeps, m_target=m_target).numpy()


def _port_dense(h, counts, avail, alpha, m, m_target, sweeps):
    """The port's dense route: Q = sym(alpha/N · H − diag(z)), then the
    plain solver, as the reference's ``backend="ref"`` builds it."""
    n = h.shape[0]
    z = tsd.balance_z(_t(counts), m_target)
    q = tsd._f32_ratio(alpha, n) * _t(h) - torch.diag(z)
    q = 0.5 * (q + q.T)
    return tsd.fedgs_solve(q, _t(avail), m=m, max_sweeps=sweeps).numpy()


def _fedgs_case(rng, case):
    m_target, alpha, sweeps = 5, 1.3, 12
    if case in ("7", "100", "130"):
        n = int(case)
        h, avail = _h(rng, n), rng.random(n) < 0.8
        avail[0] = True
        counts = rng.integers(0, 6, n).astype(np.float32)
    elif case == "all_unavailable":
        n = 33
        h, avail = _h(rng, n), np.zeros(n, bool)
        counts = rng.integers(0, 6, n).astype(np.float32)
    elif case == "fewer_than_m":
        n = 40
        h, avail = _h(rng, n), np.zeros(n, bool)
        avail[[3, 17, 29]] = True
        counts = rng.integers(0, 6, n).astype(np.float32)
    elif case == "ties":
        # alpha = N makes Q = H − diag(z) integer-valued: exact float ties
        n, m_target = 52, 9
        h, avail = _h(rng, n, integer=True), np.ones(n, bool)
        counts, alpha = np.zeros(n, np.float32), float(n)
    else:                                   # "nan": a NaN-poisoned client
        n, m_target = 24, 6
        h, avail = _h(rng, n), np.ones(n, bool)
        h[5, :] = np.nan
        h[:, 5] = np.nan
        counts = rng.integers(0, 6, n).astype(np.float32)
    m = min(m_target, int(avail.sum()))
    return h, counts, avail, alpha, m, m_target, sweeps


@pytest.mark.parametrize("case", ["7", "100", "130", "all_unavailable",
                                  "fewer_than_m", "ties", "nan"])
def test_fedgs_select_identical_sets(rng, case):
    h, counts, avail, alpha, m, mt, sweeps = _fedgs_case(rng, case)
    want = _jax_select(h, counts, avail, alpha, m, mt, "ref", sweeps)
    assert np.array_equal(_jax_select(h, counts, avail, alpha, m, mt,
                                      "pallas", sweeps), want)
    assert np.array_equal(_port_dense(h, counts, avail, alpha, m, mt,
                                      sweeps), want)
    got = _port_select(h, counts, avail, alpha, m, mt, sweeps)
    assert np.array_equal(got, want)
    assert got.sum() == m and not np.any(got & ~avail)
    if case == "nan":
        assert not got[5]
    if case == "fewer_than_m":
        assert set(np.flatnonzero(got)) == {3, 17, 29}


@pytest.mark.parametrize("case", ["random", "ties", "nan", "all_unavailable"])
def test_fedgs_solve_dense_q_vs_reference(rng, case):
    n = 52 if case == "ties" else 33
    q = (rng.integers(0, 3, (n, n)).astype(np.float32) if case == "ties"
         else _rand_q(rng, n))
    if case == "ties":
        q = 0.5 * (q + q.T)
    if case == "nan":
        q[5, :] = np.nan
        q[:, 5] = np.nan
    avail = np.zeros(n, bool) if case == "all_unavailable" else np.ones(n, bool)
    for m in (3, 6):
        want = np.asarray(_fedgs_solve(jnp.asarray(q), jnp.asarray(avail),
                                       m=m, max_sweeps=16, backend="ref"))
        got = tsd.fedgs_solve(_t(q), _t(avail), m=m, max_sweeps=16).numpy()
        assert np.array_equal(got, want)


def test_fedgs_sampler_host_face(rng):
    """FedGSSampler.sample == fedgs_select on the capped, normalized H."""
    n = 30
    h = _h(rng, n) * 5
    h[0, 1] = h[1, 0] = np.inf
    counts = rng.integers(0, 4, n).astype(np.float64)
    avail = rng.random(n) < 0.7
    sp = FedGSSampler(alpha=1.0, device="cpu")
    sp.set_graph(h)
    got = sp.sample(avail=avail, m=6, rng=np.random.default_rng(0),
                    counts=counts)
    from repro.core.sampler import FedGSSampler as JaxFedGSSampler
    jsp = JaxFedGSSampler(alpha=1.0)
    jsp.set_graph(h)
    want = jsp.sample(avail=avail, m=6, rng=np.random.default_rng(0),
                      counts=counts)
    assert np.array_equal(got, want)


def test_select_k_matches_reference(rng):
    s = rng.random(20) < 0.4
    for k in (1, 5, 12):
        ws, wv = jax_select_k(jnp.asarray(s), k)
        gs, gv = tsd.select_k(_t(s), k)
        assert np.array_equal(gs.numpy(), ws) and np.array_equal(gv.numpy(), wv)


def test_uniform_select_invariants_and_spread():
    """Uniform without replacement among A_t: exact size, never outside
    A_t, and every available client drawn near m/|A| of the time."""
    n, m = 12, 4
    avail = np.ones(n, bool)
    avail[[2, 7]] = False
    hits = np.zeros(n)
    rounds = 600
    for t in range(rounds):
        sel = UniformSampler().sample(avail=avail, m=m,
                                      rng=np.random.default_rng(t))
        assert len(sel) == m and np.all(avail[sel])
        hits[sel] += 1
    freq = hits[avail] / rounds
    assert np.all(np.abs(freq - m / avail.sum()) < 0.08)
    few = UniformSampler().sample(avail=np.eye(n, dtype=bool)[3], m=m,
                                  rng=np.random.default_rng(0))
    assert few.tolist() == [3]


# ------------------------------------------------------ dense-Q swap (B8)
@pytest.mark.parametrize("n,m,case", [(7, 2, "random"), (100, 10, "random"),
                                      (130, 13, "pad"), (52, 9, "ties"),
                                      (40, 5, "nan")])
def test_swap_best_dense_bitwise_vs_pallas(rng, n, m, case):
    """The dense swap reads Q[sel] in place; the reference takes the
    gathered panel (padded with 0 and −1e18): the same winner bit for bit,
    ties to the lowest flat index, NaN entries never win."""
    _, _, sel, valid, a, b = _swap_inputs(rng, n, m, integer=case == "ties",
                                          pad=3 if case == "pad" else 0)
    q = (rng.integers(0, 3, (n, n)).astype(np.float32) if case == "ties"
         else _rand_q(rng, n))
    if case == "nan":
        q[:, 11] = np.nan
    jb, jr, jj = jops.swap_best(jnp.asarray(q[sel]), jnp.asarray(a),
                                jnp.asarray(b))
    tb, tr, tj = tops.swap_best(_t(q), _t(sel), _t(a), _t(b))
    assert float(jb) > NEG / 2
    assert np.asarray(tb).tobytes() == np.asarray(jb, np.float32).tobytes()
    assert (int(tr), int(tj)) == (int(jr), int(jj))
    if case == "nan":
        assert int(tj) != 11


@pytest.mark.parametrize("case", ["7", "100", "130", "all_unavailable",
                                  "fewer_than_m", "ties", "nan"])
def test_fedgs_solve_kernel_route_vs_pallas(rng, case):
    """fedgs_solve's CUDA route (greedy argmax + dense swap over a given Q),
    run here on its plain versions, against the reference's
    ``fedgs_solve(backend="pallas")`` on the same Q: the same set."""
    h, counts, avail, alpha, m, mt, sweeps = _fedgs_case(rng, case)
    n = h.shape[0]
    z = tsd.balance_z(_t(counts), mt)
    q = tsd._f32_ratio(alpha, n) * _t(h) - torch.diag(z)
    q = (0.5 * (q + q.T)).numpy()
    want = np.asarray(_fedgs_solve(jnp.asarray(q), jnp.asarray(avail), m=m,
                                   max_sweeps=sweeps, backend="pallas"))
    got = tsd._solve_dense(_t(q), _t(avail), m=m, max_sweeps=sweeps).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(tsd.fedgs_solve(_t(q), _t(avail), m=m,
                                          max_sweeps=sweeps).numpy(), want)
    assert got.sum() == m and not np.any(got & ~avail)


# --------------------------------------------------------- host samplers
def test_fedgs_sampler_without_device_raises_when_cuda_is_absent(
        monkeypatch):
    """FedGSSampler runs on CUDA unless asked for the CPU: with no CUDA
    and no device it raises; an engine hands it the engine's device."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FedGSSampler(alpha=1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_sampler("fedgs")
    sp = FedGSSampler(alpha=1.0, device="cpu")
    sp.set_graph(np.ones((4, 4), np.float32) - np.eye(4, dtype=np.float32))
    assert sp.device.type == "cpu" and sp._h.device.type == "cpu"
    assert sp.to("cpu") is sp


def test_make_sampler_factory():
    assert isinstance(make_sampler("uniform"), UniformSampler)
    assert isinstance(make_sampler("md"), MDSampler)
    assert isinstance(make_sampler("poc"), PowerOfChoiceSampler)
    g = make_sampler("fedgs", alpha=2.0, device="cpu")
    assert isinstance(g, FedGSSampler) and g.alpha == 2.0
    assert make_sampler("poc").needs_losses and not g.needs_losses
    with pytest.raises(ValueError):
        make_sampler("nope")


def test_md_sampler_weights_by_size():
    """Shape and support as the reference's; the inclusion rates of both
    packages' MD draws agree (they match in distribution only)."""
    sizes = np.array([1.0, 2.0, 4.0, 8.0, 1.0, 0.0])
    avail = np.ones(6, bool)
    avail[4] = False
    draws = 400
    hits_t, hits_j = np.zeros(6), np.zeros(6)
    for t in range(draws):
        sel = MDSampler().sample(avail=avail, m=2, data_sizes=sizes,
                                 rng=np.random.default_rng(t))
        assert len(sel) == 2 and np.all(avail[sel])
        assert np.array_equal(sel, np.sort(sel))
        hits_t[sel] += 1
        s = np.asarray(jax_md_select(jax.random.PRNGKey(t),
                                     jnp.asarray(sizes), jnp.asarray(avail),
                                     2))
        hits_j += s
    assert hits_t[4] == 0 and hits_t[3] > hits_t[2] > hits_t[1] > hits_t[0]
    np.testing.assert_allclose(hits_t / draws, hits_j / draws, atol=0.1)


def test_md_select_degenerate_sizes():
    """The log floor makes all-zero sizes equal weights (never NaN); a
    single positive-size client is always taken, zero-size ones fill."""
    avail = torch.ones(10, dtype=torch.bool)
    s = tsd.md_select(torch.Generator().manual_seed(0), np.zeros(10), avail, 4)
    assert int(s.sum()) == 4
    sizes = np.zeros(10)
    sizes[7] = 100.0
    for i in range(30):
        s = tsd.md_select(torch.Generator().manual_seed(i), sizes, avail, 3)
        assert int(s.sum()) == 3 and bool(s[7])
    assert torch.equal(tsd.log_size_weights(sizes).isfinite(),
                       torch.ones(10, dtype=torch.bool))


def test_power_of_choice_picks_high_loss(rng):
    s = PowerOfChoiceSampler(d_factor=10)
    losses = np.arange(20, dtype=float)
    sel = s.sample(avail=np.ones(20, bool), m=3, rng=rng,
                   data_sizes=np.ones(20), losses=losses)
    assert len(sel) == 3 and set(sel) <= set(range(20))
    assert list(sel) == [17, 18, 19]           # d = 20: every client probed
    sel = PowerOfChoiceSampler().sample(
        avail=np.ones(12, bool), m=3, rng=rng, data_sizes=np.zeros(12),
        losses=np.arange(12, dtype=float))
    assert len(sel) == 3


@pytest.mark.parametrize("case", ["distinct", "ties", "fewer_avail"])
def test_poc_deterministic_step_matches_reference(monkeypatch, case):
    """Given the same candidate mask, PoC keeps the same m clients as the
    reference: top-m by loss, stable on ties, returned sorted."""
    n, m = 16, 3
    rng = np.random.default_rng(5)
    avail = np.ones(n, bool)
    if case == "fewer_avail":
        avail[:] = False
        avail[[2, 9, 11, 14]] = True
    cand = np.zeros(n, bool)
    cand[rng.choice(np.flatnonzero(avail), min(2 * m, avail.sum()),
                    replace=False)] = True
    losses = (np.repeat([1.0, 2.0], n // 2) if case == "ties"
              else rng.normal(size=n))
    monkeypatch.setattr(jsampler, "gumbel_topk_select",
                        lambda key, lw, av, d: jnp.asarray(cand))
    monkeypatch.setattr(tsampler, "gumbel_topk_select",
                        lambda gen, lw, av, d: torch.as_tensor(cand))
    kw = dict(avail=avail, m=m, data_sizes=np.ones(n), losses=losses)
    want = jsampler.PowerOfChoiceSampler().sample(
        rng=np.random.default_rng(0), **kw)
    got = PowerOfChoiceSampler().sample(rng=np.random.default_rng(0), **kw)
    assert np.array_equal(got, want) and np.all(cand[got])


def test_host_samplers_empty_availability_return_empty(rng):
    n = 9
    avail = np.zeros(n, bool)
    for s in (UniformSampler(), MDSampler(), PowerOfChoiceSampler()):
        sel = s.sample(avail=avail, m=3, rng=rng, data_sizes=np.ones(n),
                       losses=np.arange(n, dtype=float))
        assert sel.size == 0 and sel.dtype.kind == "i", s.name
    g = FedGSSampler(alpha=1.0, max_sweeps=4, device="cpu")
    g.set_graph(np.ones((n, n)) - np.eye(n))
    assert g.sample(avail=avail, m=3, rng=rng, counts=np.zeros(n)).size == 0
