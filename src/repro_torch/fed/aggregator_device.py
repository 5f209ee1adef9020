"""Server-update rules: the eight aggregator families of
``repro.fed.aggregator_device``, in PyTorch.

An aggregator family is a plain function of the round (no switch: the host
path knows its family; the batched switch comes with the batched engine):

    ``step(aparams, state, key, stacked_updates, weights, s, avail, t,
           sel=None, valid=None) -> (params, state)``

where ``stacked_updates`` is the dict of locally trained client params
with a leading (M,) axis, ``weights`` the (M,) Eq. 18 weights, ``s`` /
``avail`` (N,) bool masks and ``sel`` / ``valid`` the round's gathered
client slots.  ``key`` is unused by every family (kept for the
reference's signature).

  ========= ==============================================================
  family    server update
  ========= ==============================================================
  fedavg    Eq. 18, with the zero-weight guard
  fedavgm   server momentum ``mom = beta mom + (prev − avg)``,
            ``theta = prev − lr_s mom``
  fedadam   ``m = b1 m + (1 − b1) d``, ``v = b2 v + (1 − b2) d²``,
            ``theta = prev + lr_s m / (sqrt(v) + eps)``, no bias correction
  fedprox_w Eq. 18 with ``w_k / (1 + mu ||theta_k − prev||²)``
  memory    the (N, P) last-update panel: the sampled rows are overwritten,
            then ``theta = sum_k n_k gamma^(t − tau_k) mem_k / Z`` over all
            N clients — through ``kernels/ops.memory_aggregate``
  median    coordinate-wise lower median of the valid updates
  trimmed_  per-coordinate beta-trimmed mean (sum, then divide)
  mean
  krum      Krum / multi-Krum: the k lowest-scoring updates averaged
            uniformly — the distance panel through
            ``kernels/ops.krum_distances``
  ========= ==============================================================

The robust families ignore the Eq. 18 size weights and map NaN entries and
pad rows to +inf before sorting, as the reference does.  Params are dicts
of tensors; the flat (P,) layout is JAX's ``ravel_pytree`` order, keys
sorted (``b`` before ``w`` for the logistic model), so a memory panel
compares row for row with the reference's.  The state is the reference's
dict (``prev``, ``m1``, ``m2``, ``mem``, ``tau``); the krum family adds
``chosen``, the (M,) rows it averaged.  The memory family updates its
panel in place.  The kernels dispatch on the tensors' device: CUDA
launches them, the CPU takes their plain versions.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.sampler_device import select_k
from repro_torch.kernels import ops
from repro_torch.kernels.aggregate import memory_scatter_reduce_ref  # noqa: F401
from repro_torch.kernels.krum import krum_pairwise_ref  # noqa: F401

FAMILIES = ("fedavg", "fedavgm", "fedadam", "fedprox_w", "memory",
            "median", "trimmed_mean", "krum")

THETA_DIM = 6          # packed per-family scalar knobs (see the branches)

INF = float("inf")


# ------------------------------------------------------------ flat layout
def _flat_template(params_like):
    """(ravel, unravel, P) for a params dict: the flat layout is JAX's
    ``ravel_pytree`` order (keys sorted), float32.  Both maps also take a
    leading stack axis: ``ravel`` sends (M, ...) params to the (M, P)
    panel and ``unravel`` sends it back.  ``unravel`` returns the keys in
    ``params_like``'s order, as views of the flat tensor."""
    keys = sorted(params_like)
    shapes = [tuple(params_like[k].shape) for k in keys]
    sizes = [math.prod(s) for s in shapes]
    order = list(params_like)

    def ravel(pt):
        lead = pt[keys[0]].shape[:pt[keys[0]].dim() - len(shapes[0])]
        return torch.cat([pt[k].reshape(*lead, -1) for k in keys],
                         dim=-1).to(torch.float32)

    def unravel(flat):
        out, off = {}, 0
        for k, shp, sz in zip(keys, shapes, sizes):
            out[k] = flat[..., off:off + sz].reshape(*flat.shape[:-1], *shp)
            off += sz
        return {k: out[k] for k in order}

    return ravel, unravel, sum(sizes)


# ----------------------------------------------------------- shared helpers
def guard_zero_weight(avg: dict, prev: dict, total: torch.Tensor) -> dict:
    """Keep ``avg`` when any weight fired; fall back to the previous params
    on an all-zero round (assumption log #15)."""
    return {k: torch.where(total > 0, a, prev[k].to(a.dtype))
            for k, a in avg.items()}


def fedavg_combine(stacked_params: dict, weights: torch.Tensor,
                   prev_params: dict | None = None) -> dict:
    """``theta = sum_k w_k theta_k, w_k = n_k / sum n`` (Eq. 18).  With
    ``prev_params`` an all-zero-weight round returns the previous params."""
    total = torch.sum(weights)
    w = weights / torch.clamp_min(total, 1e-12)
    avg = {k: torch.tensordot(w.to(p.dtype), p, dims=([0], [0]))
           for k, p in stacked_params.items()}
    if prev_params is None:
        return avg
    return guard_zero_weight(avg, prev_params, total)


def init_agg_state(params0: dict, n_clients: int,
                   memory_rows: int | None = None) -> dict:
    """The carried state every family shares: ``prev`` (the global params),
    ``m1`` / ``m2`` (moments, zeros), ``mem`` (rows, P) with every row
    flat(params0) and ``tau`` (rows,) zeros.  ``memory_rows`` overrides the
    panel's rows (the host path passes 0 for non-memory families)."""
    rows = n_clients if memory_rows is None else memory_rows
    ravel, _, _ = _flat_template(params0)
    flat0 = ravel(params0)
    zeros = {k: torch.zeros_like(v) for k, v in params0.items()}
    return {"prev": params0, "m1": zeros, "m2": dict(zeros),
            "mem": flat0[None, :].repeat(rows, 1),
            "tau": torch.zeros(rows, dtype=torch.float32,
                               device=flat0.device)}


# ----------------------------------------------------- robust combine rules
def _poisoned_to_inf(updf, valid):
    x = torch.where(torch.isnan(updf), INF, updf)
    return torch.where(valid[:, None], x, INF)


def coordinate_median(updf: torch.Tensor, valid: torch.Tensor):
    """Coordinate-wise LOWER median, sorted index ``(v − 1) // 2`` of the v
    valid entries per coordinate.  Returns ``(median (P,), v)``."""
    v = torch.sum(valid.to(torch.int32))
    if updf.shape[0] == 0:
        return torch.zeros(updf.shape[1], dtype=updf.dtype,
                           device=updf.device), v
    srt = torch.sort(_poisoned_to_inf(updf, valid), dim=0).values
    idx = torch.clamp_min(torch.div(v - 1, 2, rounding_mode="floor"), 0)
    return torch.index_select(srt, 0, idx.reshape(1).to(torch.int64))[0], v


def trimmed_mean_combine(updf: torch.Tensor, valid: torch.Tensor,
                         beta: float):
    """Per-coordinate beta-trimmed mean: sort the v valid entries, drop the
    ``k = min(floor(f32(beta)·v), (v − 1) // 2)`` smallest and largest,
    sum the rest, then divide.  Returns ``(mean (P,), v)``."""
    v = torch.sum(valid.to(torch.int32))
    srt = torch.sort(_poisoned_to_inf(updf, valid), dim=0).values
    k = torch.floor(beta * v.to(torch.float32)).to(torch.int32)
    k = torch.clamp_min(torch.minimum(
        k, torch.div(v - 1, 2, rounding_mode="floor")), 0)
    ii = torch.arange(updf.shape[0], device=updf.device)[:, None]
    keep = (ii >= k) & (ii < v - k)
    kept = torch.sum(torch.where(keep, srt, 0.0), dim=0)
    return kept / torch.clamp_min(v - 2 * k, 1).to(torch.float32), v


def krum_select(updf: torch.Tensor, valid: torch.Tensor, f_byz: int,
                multi: int):
    """Krum / multi-Krum selection (Blanchard et al., NeurIPS 2017) over the
    valid rows of the flat (M, P) panel: score_i = sum of the ``nn = clip(v
    − f − 2, 1, m − 1)`` smallest squared distances to the other valid
    rows; the ``k = clip(multi, 1, v)`` lowest scores win, ties by row
    index (double stable argsort).  Distances are clamped at 0, NaN -> inf,
    diagonal and invalid pairs inf; ``chosen`` is masked by ``valid``.
    Returns ``(chosen (M,) bool, scores (M,) f32)``."""
    m = updf.shape[0]
    d = ops.krum_distances(updf.to(torch.float32).contiguous())
    d = torch.maximum(d, torch.zeros((), dtype=d.dtype, device=d.device))
    d = torch.where(torch.isnan(d), INF, d)
    eye = torch.eye(m, dtype=torch.bool, device=d.device)
    pair_ok = valid[:, None] & valid[None, :] & ~eye
    d = torch.where(pair_ok, d, INF)
    v = torch.sum(valid.to(torch.int32))
    nn = torch.clamp(v - f_byz - 2, 1, max(m - 1, 1))
    ds = torch.sort(d, dim=1).values
    take = torch.arange(m, device=d.device)[None, :] < nn
    scores = torch.sum(torch.where(take, ds, 0.0), dim=1)
    scores = torch.where(valid, scores, INF)
    kk = torch.clamp_max(torch.clamp_min(v, 1), max(multi, 1))
    rank = torch.argsort(torch.argsort(scores, stable=True), stable=True)
    return (rank < kk) & valid, scores


def krum_combine(updf: torch.Tensor, valid: torch.Tensor, f_byz: int,
                 multi: int):
    """:func:`krum_select` + the unweighted mean of the chosen rows.
    Returns ``(combined (P,), chosen, scores)``."""
    chosen, scores = krum_select(updf, valid, f_byz, multi)
    cnt = torch.sum(chosen.to(torch.float32))
    out = torch.sum(torch.where(chosen[:, None], updf.to(torch.float32), 0.0),
                    dim=0) / torch.clamp_min(cnt, 1.0)
    return out, chosen, scores


# --------------------------------------------------------- the family step
def make_aggregator_step(n: int, m: int, params_like: dict, *,
                         family: str, data_sizes=None):
    """The per-round server update of one family,

        ``step(aparams, state, key, stacked_updates, weights, s, avail, t,
               sel=None, valid=None) -> (params, state)``.

    ``params_like`` fixes the flat layout; ``data_sizes`` the (N,) sizes of
    the memory family's weights (all ones when omitted).  ``aparams`` is a
    process's :meth:`AggregatorProcess.params`; its ``theta`` is read on the
    host.  ``sel`` / ``valid`` default to ``select_k(s, m)``."""
    if family not in FAMILIES:
        raise ValueError(f"family must be one of {FAMILIES}, not {family!r}")
    ravel, unravel, _ = _flat_template(params_like)
    dev = next(iter(params_like.values())).device
    sizes = (torch.ones(n, dtype=torch.float32, device=dev)
             if data_sizes is None else
             torch.as_tensor(np.asarray(data_sizes, np.float32), device=dev))

    def _fedavg(th, state, upd, w, s, t, sel, valid):
        new = fedavg_combine(upd, w, state["prev"])
        return new, {**state, "prev": new}

    def _fedavgm(th, state, upd, w, s, t, sel, valid):
        lr_s, beta = th[0], th[1]
        avg = fedavg_combine(upd, w, state["prev"])
        m1 = {k: beta * state["m1"][k] + (p0 - avg[k])
              for k, p0 in state["prev"].items()}
        new = {k: p0 - lr_s * m1[k] for k, p0 in state["prev"].items()}
        return new, {**state, "prev": new, "m1": m1}

    def _fedadam(th, state, upd, w, s, t, sel, valid):
        lr_s, b1, b2, eps = th[0], th[1], th[2], th[3]
        avg = fedavg_combine(upd, w, state["prev"])
        prev = state["prev"]
        delta = {k: avg[k] - prev[k] for k in prev}
        m1 = {k: b1 * state["m1"][k] + (1.0 - b1) * delta[k] for k in prev}
        m2 = {k: b2 * state["m2"][k] + (1.0 - b2) * delta[k] * delta[k]
              for k in prev}
        new = {k: prev[k] + lr_s * m1[k] / (torch.sqrt(m2[k]) + eps)
               for k in prev}
        return new, {**state, "prev": new, "m1": m1, "m2": m2}

    def _fedprox_w(th, state, upd, w, s, t, sel, valid):
        mu = th[0]
        prevf = ravel(state["prev"])
        drift = torch.sum((ravel(upd) - prevf[None, :]) ** 2, dim=1)
        new = fedavg_combine(upd, w / (1.0 + mu * drift), state["prev"])
        return new, {**state, "prev": new}

    def _memory(th, state, upd, w, s, t, sel, valid):
        gamma = th[0]
        tf = float(np.float32(t))
        tau = torch.where(s, tf, state["tau"])
        age = torch.clamp_min(tf - tau, 0.0)
        wmem = sizes * torch.pow(gamma, age)
        total = torch.sum(wmem)
        wn = wmem / torch.clamp_min(total, 1e-12)
        mem, red = ops.memory_aggregate(state["mem"], ravel(upd),
                                        sel, valid, wn)
        new = guard_zero_weight(unravel(red), state["prev"], total)
        return new, {**state, "prev": new, "mem": mem, "tau": tau}

    def _median(th, state, upd, w, s, t, sel, valid):
        med, v = coordinate_median(ravel(upd), valid)
        new = guard_zero_weight(unravel(med), state["prev"], v)
        return new, {**state, "prev": new}

    def _trimmed_mean(th, state, upd, w, s, t, sel, valid):
        tm, v = trimmed_mean_combine(ravel(upd), valid, th[0])
        new = guard_zero_weight(unravel(tm), state["prev"], v)
        return new, {**state, "prev": new}

    def _krum(th, state, upd, w, s, t, sel, valid):
        f_byz, multi = int(np.rint(th[0])), int(np.rint(th[1]))
        out, chosen, _ = krum_combine(ravel(upd), valid, f_byz,
                                      multi)
        new = guard_zero_weight(unravel(out), state["prev"],
                                torch.sum(chosen.to(torch.int32)))
        return new, {**state, "prev": new, "chosen": chosen}

    branch = {"fedavg": _fedavg, "fedavgm": _fedavgm, "fedadam": _fedadam,
              "fedprox_w": _fedprox_w, "memory": _memory, "median": _median,
              "trimmed_mean": _trimmed_mean, "krum": _krum}[family]

    def step(aparams, state, key, stacked_updates, weights, s, avail, t,
             sel=None, valid=None):
        if sel is None:
            sel, valid = select_k(s, m)
        th = [float(x) for x in np.asarray(aparams["theta"], np.float32)]
        return branch(th, state, stacked_updates, weights, s, int(t), sel,
                      valid)

    return step


# ------------------------------------------------------------ the processes
@dataclass
class AggregatorProcess:
    """Base class: ``params()`` packs the family index and its float32
    ``theta`` knobs (host numpy); ``ServerAggregator`` runs the family."""

    family = "fedavg"
    name = "process"

    def _theta(self) -> np.ndarray:
        return np.zeros(0)

    def params(self) -> dict:
        theta = np.zeros(THETA_DIM, np.float32)
        th = np.asarray(self._theta(), np.float32)
        theta[:th.shape[0]] = th
        return {"family": FAMILIES.index(self.family), "theta": theta}


@dataclass
class FedAvgProcess(AggregatorProcess):
    """Eq. 18 (plus the zero-weight guard)."""
    name: str = "fedavg"
    family = "fedavg"


@dataclass
class FedAvgMProcess(AggregatorProcess):
    """Hsu et al. 2019 server momentum."""
    server_lr: float = 1.0
    beta: float = 0.9
    name: str = "fedavgm"
    family = "fedavgm"

    def _theta(self):
        return np.array([self.server_lr, self.beta])


@dataclass
class FedAdamProcess(AggregatorProcess):
    """Reddi et al. 2021 adaptive federated optimization (FedAdam)."""
    server_lr: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.99
    eps: float = 1e-3
    name: str = "fedadam"
    family = "fedadam"

    def _theta(self):
        return np.array([self.server_lr, self.beta1, self.beta2, self.eps])


@dataclass
class FedProxWProcess(AggregatorProcess):
    """Proximal-weighted averaging: ``w_k <- w_k / (1 + mu ||d_k||^2)``."""
    mu: float = 0.1
    name: str = "fedprox_w"
    family = "fedprox_w"

    def _theta(self):
        return np.array([self.mu])


@dataclass
class MemoryProcess(AggregatorProcess):
    """FedAR/MIFA-style per-client update memory with staleness-discounted
    rectification; ``gamma`` is the per-round staleness discount."""
    gamma: float = 0.9
    name: str = "memory"
    family = "memory"

    def __post_init__(self):
        self.name = f"memory(gamma={self.gamma})"

    def _theta(self):
        return np.array([max(self.gamma, 1e-6)])


@dataclass
class MedianProcess(AggregatorProcess):
    """Coordinate-wise lower median (1/2 breakdown per coordinate)."""
    name: str = "median"
    family = "median"


@dataclass
class TrimmedMeanProcess(AggregatorProcess):
    """Per-coordinate beta-trimmed mean (Yin et al. 2018); ``beta`` is the
    per-side trim fraction."""
    beta: float = 0.2
    name: str = "trimmed_mean"
    family = "trimmed_mean"

    def __post_init__(self):
        self.name = f"trimmed_mean(beta={self.beta})"

    def _theta(self):
        return np.array([self.beta])


@dataclass
class KrumProcess(AggregatorProcess):
    """Krum / multi-Krum (Blanchard et al. 2017): ``f`` is the Byzantine
    budget the score defends against, ``multi`` the number of selected
    updates averaged (1 = classic Krum)."""
    f: int = 1
    multi: int = 1
    name: str = "krum"
    family = "krum"

    def __post_init__(self):
        self.name = (f"krum(f={self.f})" if self.multi <= 1
                     else f"multikrum(f={self.f},k={self.multi})")

    def _theta(self):
        return np.array([float(self.f), float(self.multi)])


def make_aggregator_process(name: str, *, server_lr: float | None = None,
                            beta: float = 0.9, mu: float = 0.1,
                            gamma: float = 0.9, beta_trim: float = 0.2,
                            krum_f: int = 1,
                            krum_multi: int = 1) -> AggregatorProcess:
    """Family names -> processes (the reference's names and defaults)."""
    name = name.lower()
    if name == "fedavg":
        return FedAvgProcess()
    if name == "fedavgm":
        return FedAvgMProcess(server_lr=1.0 if server_lr is None
                              else server_lr, beta=beta)
    if name == "fedadam":
        return FedAdamProcess(server_lr=0.1 if server_lr is None
                              else server_lr)
    if name in ("fedprox_w", "fedproxw"):
        return FedProxWProcess(mu=mu)
    if name == "memory":
        return MemoryProcess(gamma=gamma)
    if name == "median":
        return MedianProcess()
    if name in ("trimmed_mean", "trimmedmean"):
        return TrimmedMeanProcess(beta=beta_trim)
    if name in ("krum", "multikrum"):
        return KrumProcess(f=krum_f,
                           multi=krum_multi if name == "krum" else
                           max(krum_multi, 2))
    raise ValueError(f"unknown aggregator family {name!r}")
