"""The FedGS Eq. 16 solver and the baseline selects (the part of
``repro.core.sampler_device`` this slice needs).

FedGS solves, each round,
    max_s  sᵀ (alpha/N · H − diag(z)) s   s.t. |s| = m, s ⊆ A_t
with a deterministic greedy pass of m steps and then ``max_sweeps``
best-swap sweeps.  :func:`fedgs_select` solves Q-free (:func:`_solve_kernel`):
on the factored (H, z, alpha/N) through ``kernels/solver.q_diag``/``q_row``,
the greedy masked argmax and the fused swap reduction
(``kernels/ops.greedy_argmax`` / ``swap_best_fused``), which launch the CUDA
kernels for CUDA tensors and take their plain versions on the CPU.
:func:`fedgs_solve` solves over a dense (N, N) Q that the caller hands
over: on CUDA through the greedy kernel and the dense best-swap kernel
(:func:`_solve_dense`, ``kernels/ops.swap_best``), on the CPU with the plain
solver (:func:`_solve_ref`).  Given the same Q every route selects the same
set bit for bit.

The loops are Python loops whose branches are ``torch.where`` selects (the
reference's ``lax.cond``): the solve never syncs with the host, so a round
costs one sync, when the caller reads the selection.  Tie-breaks (first
max, row-major flat order) and the NaN guard (NaN -> −1e18) are the
reference's (DESIGN.md assumption log #12/#13).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

NEG = -1e18                 # masked-entry sentinel (== kernels/solver.NEG)
SWAP_TOL = 1e-9             # a swap must improve Eq. 16 by more than this


# ------------------------------------------------------------ shared helpers
def select_k(s: torch.Tensor, k: int):
    """Mask (N,) bool -> (sorted selected indices (k,), valid (k,)): selected
    indices ascending, then pad slots (``valid`` False) ascending."""
    n = s.shape[0]
    iota = torch.arange(n, device=s.device)
    order = torch.argsort(torch.where(s, iota, n + iota))
    sel = order[:k]
    return sel, s[sel]


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim index tensor, without a host sync."""
    return torch.index_select(x, 0, i.reshape(1))[0]


def _f32_ratio(alpha: float, n: int) -> float:
    """alpha/N in float32 arithmetic, as the reference computes it."""
    return float(np.float32(alpha) / np.float32(n))


def log_size_weights(data_sizes) -> torch.Tensor:
    """The MD/PoC Gumbel log-weights with the reference's degenerate-size
    guard: the 1e-12 floor turns all-zero data sizes into EQUAL finite
    weights (uniform sampling) instead of NaNs, and zero-size clients keep
    a finite score so they can still fill the mask."""
    sizes = torch.as_tensor(np.asarray(data_sizes), dtype=torch.float32)
    return torch.log(torch.clamp_min(sizes, 1e-12))


# --------------------------------------------------- baseline sampling draws
def gumbel_topk_select(generator: torch.Generator, log_weights: torch.Tensor,
                       avail: torch.Tensor, m: int) -> torch.Tensor:
    """Weighted sampling WITHOUT replacement among available clients (Gumbel
    top-k), drawn from ``generator``.  Returns s (N,) bool with exactly
    min(m, |avail|) True entries.  Torch's generator cannot replay JAX's
    draws: this matches the reference in distribution only."""
    u = torch.rand(log_weights.shape, generator=generator,
                   device=generator.device, dtype=torch.float32)
    g = -torch.log(-torch.log(u.to(log_weights.device)))
    scores = torch.where(avail, log_weights + g,
                         torch.full_like(g, float("-inf")))
    idx = torch.topk(scores, m).indices
    s = torch.zeros(log_weights.shape, dtype=torch.bool,
                    device=log_weights.device)
    return s.scatter(0, idx, avail[idx])


def uniform_select(generator: torch.Generator, avail: torch.Tensor,
                   m: int) -> torch.Tensor:
    """Uniform without replacement among A_t."""
    return gumbel_topk_select(
        generator, torch.zeros(avail.shape, dtype=torch.float32,
                               device=avail.device), avail, m)


def md_select(generator: torch.Generator, data_sizes, avail: torch.Tensor,
              m: int) -> torch.Tensor:
    """Without replacement, P(k) ∝ n_k, among A_t (degenerate sizes handled
    by the :func:`log_size_weights` floor)."""
    return gumbel_topk_select(
        generator, log_size_weights(data_sizes).to(avail.device), avail, m)


# ------------------------------------------------------------- FedGS solver
def _solve_ref(q: torch.Tensor, avail: torch.Tensor, *, m: int,
               max_sweeps: int) -> torch.Tensor:
    """The plain solver: greedy construction + dense best-swap sweeps."""
    n = q.shape[0]
    dev = q.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iota = torch.arange(n, device=dev)
    diag = torch.diagonal(q)
    s = torch.zeros(n, dtype=torch.bool, device=dev)
    r = torch.zeros(n, dtype=torch.float32, device=dev)

    for _ in range(m):
        gain = diag + 2.0 * r
        gain = torch.where(s | ~avail, neg, gain)
        gain = torch.where(torch.isnan(gain), neg, gain)
        k = torch.argmax(gain)
        ok = _at(gain, k) > NEG / 2
        s = s | ((iota == k) & ok)
        r = r + torch.where(ok, _at(q, k), zero)

    for _ in range(max_sweeps):
        out_term = -2.0 * r + diag
        in_term = 2.0 * r + diag
        delta = out_term[:, None] + in_term[None, :] - 2.0 * q
        delta = torch.where(s[:, None], delta, neg)
        delta = torch.where((~s & avail)[None, :], delta, neg)
        delta = torch.where(torch.isnan(delta), neg, delta)
        flat = torch.argmax(delta.reshape(-1))
        i, j = flat // n, flat % n
        best = _at(delta.reshape(-1), flat)
        s2 = (s & (iota != i)) | (iota == j)
        r2 = r - _at(q, i) + _at(q, j)
        swap = best > SWAP_TOL
        s = torch.where(swap, s2, s)
        r = torch.where(swap, r2, r)
    return s


def _solve_kernel(diag: torch.Tensor, row_fn: Callable, swap_fn: Callable,
                  avail: torch.Tensor, *, m: int,
                  max_sweeps: int) -> torch.Tensor:
    """The kernel-backed solve over a PROVIDED Q (no (N, N) intermediate):

    diag     (N,) = diag(Q).
    row_fn   ``row_fn(k) -> (N,)`` row k of Q for a 0-dim index tensor.
    swap_fn  ``swap_fn(sel, valid, a, b) -> (best, rank, j)`` the best-swap
             reduction over the |S| ≤ m selected rows (``sel`` ascending,
             clamped; ``valid`` marks real rows).

    The greedy step is ``kernels/ops.greedy_argmax``, handed A_t and S: it
    masks ``avail & ~s`` itself, so the step launches no mask op; the sweep
    restricts delta to the selected rows (ascending, which keeps the dense
    path's row-major tie-break)."""
    from repro_torch.kernels.ops import greedy_argmax
    n = diag.shape[0]
    dev = diag.device
    if m == 0:
        return torch.zeros(n, dtype=torch.bool, device=dev)
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iota = torch.arange(n, device=dev)
    s = torch.zeros(n, dtype=torch.bool, device=dev)
    r = torch.zeros(n, dtype=torch.float32, device=dev)

    for _ in range(m):
        val, k = greedy_argmax(diag, r, avail, s)
        ok = val > NEG / 2
        s = s | ((iota == k) & ok)
        r = r + torch.where(ok, row_fn(k), zero)

    for _ in range(max_sweeps):
        out_term = -2.0 * r + diag
        in_term = 2.0 * r + diag
        sel = torch.sort(torch.where(s, iota, n)).values[:m]
        valid = sel < n
        selc = torch.clamp_max(sel, n - 1)
        a = torch.where(valid, out_term[selc], neg)
        b = torch.where(~s & avail, in_term, neg)
        best, rank, j = swap_fn(selc, valid, a, b)
        i = _at(selc, torch.clamp_max(rank, m - 1))
        s2 = (s & (iota != i)) | (iota == j)
        r2 = r - row_fn(i) + row_fn(j)
        swap = best > SWAP_TOL
        s = torch.where(swap, s2, s)
        r = torch.where(swap, r2, r)
    return s


def _solve_dense(q: torch.Tensor, avail: torch.Tensor, *, m: int,
                 max_sweeps: int) -> torch.Tensor:
    """The kernel-backed solve over a materialized Q: the greedy masked
    argmax, then the dense best-swap reduction reading Q's selected rows in
    place (``kernels/ops.swap_best``), as the reference's
    ``fedgs_solve(backend="pallas")``."""
    from repro_torch.kernels.ops import swap_best

    def swap_fn(selc, valid, a, b):
        return swap_best(q, selc, a, b)

    return _solve_kernel(torch.diagonal(q).contiguous(),
                         lambda k: _at(q, k), swap_fn, avail, m=m,
                         max_sweeps=max_sweeps)


def fedgs_solve(q: torch.Tensor, avail: torch.Tensor, *, m: int,
                max_sweeps: int) -> torch.Tensor:
    """Greedy + best-swap local search on  max sᵀQs,  |s| = m,  s ⊆ avail,
    over a dense (N, N) Q (symmetric, diagonal −z).  On CUDA it runs the
    greedy and dense-swap kernels (:func:`_solve_dense`), on the CPU the
    plain solver; both select the same set.  If fewer than ``m`` clients
    are available pass m = |A|.  Returns s (N,) bool."""
    q = q.to(torch.float32)
    if q.is_cuda:
        return _solve_dense(q, avail, m=m, max_sweeps=max_sweeps)
    if q.device.type != "cpu":
        raise ValueError(f"fedgs_solve: no kernel for {q.device}")
    return _solve_ref(q, avail, m=m, max_sweeps=max_sweeps)


def balance_z(counts: torch.Tensor, m_target: int) -> torch.Tensor:
    """Eq. 14's count-balance penalty z = 2(c − mean(c) − M/N) + 1, float32
    in the reference's op order."""
    n = counts.shape[0]
    counts = counts.to(torch.float32)
    # sum / n as a true division (CUDA's mean multiplies by 1/n)
    mean = torch.sum(counts) / torch.full((), n, dtype=torch.float32,
                                          device=counts.device)
    return 2.0 * (counts - mean - m_target / n) + 1.0


def fedgs_select(h: torch.Tensor, counts: torch.Tensor, avail: torch.Tensor,
                 alpha: float, *, m: int, max_sweeps: int,
                 m_target: int | None = None) -> torch.Tensor:
    """Eq. 14/16 end to end: z from the counts, then the Q-free solve
    (CUDA kernels on CUDA tensors, their plain versions on the CPU).

    ``m`` is the solver budget (min(M, |A_t|)); ``m_target`` is the M of the
    count-balance penalty z (defaults to ``m``).  The dense route,
    ``fedgs_solve`` on Q = sym(alpha/N · H − diag(z)), selects the same
    set."""
    from repro_torch.kernels.ops import swap_best_fused
    from repro_torch.kernels.solver import q_diag, q_row
    z = balance_z(counts, m if m_target is None else m_target)
    al = _f32_ratio(alpha, h.shape[0])
    hf = h.to(torch.float32)

    def swap_fn(selc, valid, a, b):
        return swap_best_fused(hf, z, al, selc, valid, a, b)

    return _solve_kernel(q_diag(hf, z, al), lambda k: q_row(hf, z, al, k),
                         swap_fn, avail, m=m, max_sweeps=max_sweeps)
