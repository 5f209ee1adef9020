"""Device-native samplers (the port of ``repro.core.sampler_device``): the
FedGS Eq. 16 solver, the baseline selects and the sampler processes the
scan engine carries.

FedGS solves, each round,
    max_s  sᵀ (alpha/N · H − diag(z)) s   s.t. |s| = m, s ⊆ A_t
with a deterministic greedy pass of m steps and then ``max_sweeps``
best-swap sweeps.  :func:`fedgs_select_cells` solves B cells Q-free, on
the factored (H, z, alpha/N): where one cell's panel fits a block, each
greedy step and each sweep is one launch for all of them
(``kernels/ops.greedy_cells`` / ``swap_cells``); elsewhere each cell runs
:func:`_solve_kernel` over ``kernels/solver.q_diag``/``q_row``, the greedy
masked argmax and the fused swap reduction (``kernels/ops.greedy_argmax`` /
``swap_best_fused``).  Each launches the CUDA kernels for CUDA tensors and
takes its plain version on the CPU, and a cell's set is the same on every
route.  :func:`fedgs_select` is its one-cell case.
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

A :class:`SamplerProcess` packs one cell's sampler (``params()``: family
index, alpha, log-size weights) and :func:`make_sampler_step` builds the
per-round step of one family — the family is host data, so the dispatch is
a Python lookup (the reference's ``lax.switch``).  RNG seam: the reference's
``jax.random.gumbel`` noise comes in as a tensor (``gumbel=``), and the
Power-of-Choice probe reads its loss through a ``probe_losses`` callable
that owns its index draws.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

FAMILIES = ("fedgs", "uniform", "md", "poc")

NEG = -1e18                 # masked-entry sentinel (== kernels/solver.NEG)
SWAP_TOL = 1e-9             # a swap must improve Eq. 16 by more than this


# ------------------------------------------------------------ shared helpers
def select_k(s: torch.Tensor, k: int):
    """Mask (..., N) bool -> (sorted selected indices (..., k), valid (...,
    k)): selected indices ascending, then pad slots (``valid`` False)
    ascending, per row."""
    n = s.shape[-1]
    iota = torch.arange(n, device=s.device)
    order = torch.argsort(torch.where(s, iota, n + iota), dim=-1)
    sel = order[..., :k]
    return sel, torch.gather(s, -1, sel)


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
def gumbel_noise(generator: torch.Generator, shape,
                 device=None) -> torch.Tensor:
    """Standard Gumbel noise ``−log(−log u)`` from ``generator``."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return -torch.log(-torch.log(u.to(device or u.device)))


def gumbel_topk_select(generator, log_weights: torch.Tensor,
                       avail: torch.Tensor, m: int, *,
                       gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Weighted sampling WITHOUT replacement among available clients (Gumbel
    top-k) over the last axis: ``gumbel`` is the noise (e.g. the
    reference's ``jax.random.gumbel`` draw), else drawn from ``generator``
    (torch's generator cannot replay JAX's draws: that matches the
    reference in distribution only).  Returns s (..., N) bool with exactly
    min(m, |avail|) True entries per row."""
    g = gumbel_noise(generator, avail.shape, log_weights.device) \
        if gumbel is None else gumbel.to(log_weights.device)
    scores = torch.where(avail, log_weights + g,
                         torch.full_like(g, float("-inf")))
    idx = torch.topk(scores, m, dim=-1).indices
    s = torch.zeros(avail.shape, dtype=torch.bool, device=avail.device)
    return s.scatter(-1, idx, torch.gather(avail, -1, idx))


def uniform_select(generator, avail: torch.Tensor, m: int, *,
                   gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Uniform without replacement among A_t."""
    return gumbel_topk_select(
        generator, torch.zeros(avail.shape, dtype=torch.float32,
                               device=avail.device), avail, m, gumbel=gumbel)


def md_select(generator, data_sizes, avail: torch.Tensor, m: int, *,
              gumbel: torch.Tensor | None = None) -> torch.Tensor:
    """Without replacement, P(k) ∝ n_k, among A_t (degenerate sizes handled
    by the :func:`log_size_weights` floor)."""
    return gumbel_topk_select(
        generator, log_size_weights(data_sizes).to(avail.device), avail, m,
        gumbel=gumbel)


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
    in the reference's op order.  XLA computes ``counts.mean()`` as the sum
    times the float32 reciprocal of N (its divide by a constant becomes a
    multiply), so the mean here is that product too: an IEEE multiply,
    the same on the CPU and on CUDA.  Over the last axis: (B, N) counts
    give each row its own z; whole-number counts below 2^24 sum exactly in
    any order, so a row's z is bitwise its own run's."""
    n = counts.shape[-1]
    counts = counts.to(torch.float32)
    mean = torch.sum(counts, -1, keepdim=True) * \
        float(np.float32(1.0) / np.float32(n))
    return 2.0 * (counts - mean - m_target / n) + 1.0


def fedgs_select(h: torch.Tensor, counts: torch.Tensor, avail: torch.Tensor,
                 alpha: float, *, m: int, max_sweeps: int,
                 m_target: int | None = None) -> torch.Tensor:
    """Eq. 14/16 end to end: z from the counts, then the Q-free solve
    (CUDA kernels on CUDA tensors, their plain versions on the CPU): the
    one-cell case of :func:`fedgs_select_cells`.

    ``m`` is the solver budget (min(M, |A_t|)); ``m_target`` is the M of the
    count-balance penalty z (defaults to ``m``).  The dense route,
    ``fedgs_solve`` on Q = sym(alpha/N · H − diag(z)), selects the same
    set."""
    scale = torch.full((1,), _f32_ratio(alpha, h.shape[0]),
                       dtype=torch.float32, device=avail.device)
    return fedgs_select_cells(h, counts[None], avail[None], [alpha], m=m,
                              max_sweeps=max_sweeps, m_target=m_target,
                              scales=scale)[0]


def _select_steps(hf, z, al: float, avail, *, m: int, max_sweeps: int):
    """One cell's Q-free solve on the per-step kernels (:func:`_solve_kernel`
    over ``q_diag``/``q_row`` and ``swap_best_fused``)."""
    from repro_torch.kernels.ops import swap_best_fused
    from repro_torch.kernels.solver import q_diag, q_row

    def swap_fn(selc, valid, a, b):
        return swap_best_fused(hf, z, al, selc, valid, a, b)

    return _solve_kernel(q_diag(hf, z, al), lambda k: q_row(hf, z, al, k),
                         swap_fn, avail, m=m, max_sweeps=max_sweeps)


def alpha_scales(alphas, n: int, device=None) -> torch.Tensor:
    """(B,) float32 alpha/N of each cell, as :func:`_f32_ratio` computes it."""
    return torch.tensor([_f32_ratio(a, n) for a in alphas],
                        dtype=torch.float32, device=device)


def _solve_cells(h, z, scale, avail, *, m: int, max_sweeps: int):
    """The batched solve: m greedy steps and ``max_sweeps`` sweeps, each one
    call for every cell (``kernels/ops.greedy_cells`` / ``swap_cells``, in
    place on the (B, N) state).  Returns (s, r)."""
    from repro_torch.kernels.ops import greedy_cells, swap_cells
    b, n = avail.shape
    s = torch.empty((b, n), dtype=torch.bool, device=z.device)
    r = torch.empty((b, n), dtype=torch.float32, device=z.device)
    for step in range(m):          # the first step writes s and r whole
        greedy_cells(h, z, scale, avail, s, r, first=step == 0)
    for _ in range(max_sweeps):
        swap_cells(h, z, scale, avail, s, r, m)
    return s, r


def fedgs_select_cells(h, counts: torch.Tensor, avail: torch.Tensor, alphas,
                       *, m: int, max_sweeps: int,
                       m_target: int | None = None,
                       scales: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`fedgs_select` for B cells at once: every cell's set bitwise
    what it selects alone.

    ``h`` is one (N, N) H shared by every cell, a (B, N, N) stack, or a
    list of B (N, N) tensors (one object repeated counts as shared);
    ``counts`` (B, N) whole numbers, ``avail`` (B, N) bool, ``alphas`` the B
    cells' alpha; ``scales`` their (B,) float32 alpha/N on the device
    (:func:`alpha_scales`), when the caller keeps it.  z comes from one
    :func:`balance_z` over (B, N).  Where the panel fits one block
    (``kernels/solver.solve_cells_takes``) the solve is batched: each
    greedy step and each sweep is one call for every cell, the CUDA
    kernels' m + ``max_sweeps`` launches a solve.  Elsewhere (m = 0, or a
    panel past one block) each cell runs the per-step kernels in turn.
    Returns s (B, N) bool."""
    from repro_torch.kernels.solver import solve_cells_takes
    b, n = avail.shape
    z = balance_z(counts, m if m_target is None else m_target)
    if isinstance(h, (list, tuple)):
        h = h[0] if all(x is h[0] for x in h) else torch.stack(list(h))
    hf = h.to(torch.float32)
    if not solve_cells_takes(m, n):
        return torch.stack([
            _select_steps(hf if hf.dim() == 2 else hf[i], z[i],
                          _f32_ratio(alphas[i], n), avail[i], m=m,
                          max_sweeps=max_sweeps) for i in range(b)])
    if scales is None:
        scales = alpha_scales(alphas, n, avail.device)
    return _solve_cells(hf.contiguous(), z.contiguous(), scales,
                        avail.contiguous(), m=m, max_sweeps=max_sweeps)[0]


# ------------------------------------------------------- the family step
def make_sampler_step(n: int, m: int, *, family: str, max_sweeps: int = 32,
                      d_cand: int | None = None,
                      probe_losses: Callable | None = None):
    """The per-round sampler step of one family,

        ``step(sparams, state, inputs, avail, t, *, gumbel=None)
            -> (s (N,) bool, state)``

    ``inputs`` carries the round context: ``h`` (N, N) normalized H and
    ``counts`` (N,) for FedGS, and whatever ``probe_losses(inputs, cidx,
    cvalid) -> (d,)`` reads for Power-of-Choice (the scan engine closes
    over the model and reads ``inputs["params"]``; the default reads a
    precomputed ``inputs["losses"]`` (N,)).  ``gumbel`` is the round's (N,)
    Gumbel noise of the uniform, MD and PoC families; FedGS reads none
    (deterministic given (H, counts, A_t)).  |s| = min(m, |A_t|)."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, not {family!r}")
    d = int(n if d_cand is None else d_cand)
    if probe_losses is None:
        def probe_losses(inputs, cidx, cvalid):
            return inputs["losses"][cidx]

    def _fedgs(sp, state, inputs, avail, t, gumbel):
        s = fedgs_select(inputs["h"], inputs["counts"], avail, sp["alpha"],
                         m=m, max_sweeps=max_sweeps)
        return s, state

    def _uniform(sp, state, inputs, avail, t, gumbel):
        return uniform_select(None, avail, m, gumbel=gumbel), state

    def _md(sp, state, inputs, avail, t, gumbel):
        return gumbel_topk_select(None, sp["log_sizes"], avail, m,
                                  gumbel=gumbel), state

    def _poc(sp, state, inputs, avail, t, gumbel):
        """Cho et al. 2020: d·m candidates by data size (Gumbel top-k), then
        keep the top-m highest-loss candidates."""
        cand = gumbel_topk_select(None, sp["log_sizes"], avail, d,
                                  gumbel=gumbel)
        cidx, cvalid = select_k(cand, d)
        losses = probe_losses(inputs, cidx, cvalid)
        kk = torch.topk(torch.where(cvalid, losses,
                                    torch.full_like(losses, float("-inf"))),
                        m).indices
        # cidx entries are distinct: an invalid slot never overwrites a
        # kept candidate
        s = torch.zeros(n, dtype=torch.bool, device=avail.device)
        return s.scatter(0, cidx[kk], cvalid[kk]), state

    branch = {"fedgs": _fedgs, "uniform": _uniform, "md": _md,
              "poc": _poc}[family]

    def step(sparams, state, inputs, avail, t, *, gumbel=None):
        if family != "fedgs" and gumbel is None:
            raise ValueError(f"the {family} sampler needs its (N,) Gumbel "
                             f"noise")
        return branch(sparams, state, inputs, avail, t, gumbel)

    return step


# ------------------------------------------------------------ the processes
@dataclass
class SamplerProcess:
    """Base class: ``params()`` packs the family index, alpha and the
    MD/PoC log-size weights; ``init()`` the carried state (empty: today's
    samplers are stateless per round)."""

    family = "uniform"
    name = "process"

    def _alpha(self) -> float:
        return 0.0

    def params(self, *, data_sizes=None, n_clients: int | None = None) -> dict:
        """``{"family": int, "alpha": float32, "log_sizes" (N,) f32 CPU
        tensor}``; ``data_sizes`` defaults to all ones (uniform MD/PoC
        weights) when only ``n_clients`` is known."""
        if data_sizes is None:
            assert n_clients is not None, "need data_sizes or n_clients"
            data_sizes = np.ones(n_clients)
        return {"family": FAMILIES.index(self.family),
                "alpha": float(np.float32(self._alpha())),
                "log_sizes": log_size_weights(data_sizes)}

    def init(self) -> dict:
        return {}

    def select(self, state, inputs, avail, t, *, m: int, gumbel=None,
               data_sizes=None, max_sweeps: int = 32,
               d_cand: int | None = None, probe_losses=None):
        """One round of this process alone."""
        n = avail.shape[-1]
        sp = self.params(data_sizes=data_sizes, n_clients=n)
        sp = {**sp, "log_sizes": sp["log_sizes"].to(avail.device)}
        step = make_sampler_step(n, m, family=self.family,
                                 max_sweeps=max_sweeps, d_cand=d_cand,
                                 probe_losses=probe_losses)
        return step(sp, state, inputs, avail, t, gumbel=gumbel)


@dataclass
class UniformProcess(SamplerProcess):
    """McMahan et al. 2017: uniform without replacement among available."""
    name: str = "uniform"
    family = "uniform"


@dataclass
class MDProcess(SamplerProcess):
    """Li et al. 2020: without replacement, P(k) ∝ n_k, among available."""
    name: str = "md"
    family = "md"


@dataclass
class PoCProcess(SamplerProcess):
    """Cho et al. 2020 Power-of-Choice; the candidate count itself is an
    engine knob (``ScanConfig.poc_d_factor``)."""
    d_factor: int = 2
    name: str = "poc"
    family = "poc"


@dataclass
class FedGSProcess(SamplerProcess):
    """The paper's method; ``alpha`` weighs graph dispersion vs count
    balance, per cell."""
    alpha: float = 1.0
    name: str = "fedgs"
    family = "fedgs"

    def __post_init__(self):
        self.name = f"fedgs(alpha={self.alpha})"

    def _alpha(self) -> float:
        return self.alpha


def make_sampler_process(name: str, *, alpha: float = 1.0,
                         d_factor: int = 2) -> SamplerProcess:
    """Family names (= ``scan_engine.SAMPLERS``) -> processes."""
    name = name.lower()
    if name in ("uniform", "uniformsample"):
        return UniformProcess()
    if name in ("md", "mdsample"):
        return MDProcess()
    if name in ("poc", "power-of-choice", "powerofchoice"):
        return PoCProcess(d_factor=d_factor)
    if name == "fedgs":
        return FedGSProcess(alpha=alpha)
    raise ValueError(f"unknown sampler family {name!r}")
