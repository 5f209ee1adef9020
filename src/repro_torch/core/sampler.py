"""Client samplers — the host face over ``core/sampler_device.py`` (the port
of ``repro.core.sampler``).

All samplers see only the available set A_t (immediate availability, as in
the paper) and return SORTED selected indices as numpy; an empty A_t gives
an empty array.  The baselines' draws (Uniform, MD and PoC's candidates)
run on the CPU from one ``torch.Generator`` per draw, seeded from the
caller's numpy stream: they match the reference in distribution only
(torch's generator cannot replay JAX's).  FedGS is deterministic given
(H, counts, A_t) and solves on its ``device``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.graph_device import cap_and_normalize
from repro_torch.core.sampler_device import (fedgs_select,
                                             gumbel_topk_select,
                                             log_size_weights, md_select,
                                             uniform_select)

_EMPTY = np.zeros(0, np.int64)


def _draw_generator(rng: np.random.Generator) -> torch.Generator:
    """One CPU torch generator per draw, seeded from the caller's numpy
    stream, so a run is deterministic given its per-round rngs."""
    return torch.Generator().manual_seed(int(rng.integers(2 ** 31 - 1)))


class Sampler:
    """Stateless-per-round sampler interface.  ``needs_losses``: the engine
    probes each client's loss under the global model before ``sample``."""
    name = "base"
    needs_losses = False

    def sample(self, *, avail: np.ndarray, m: int, rng: np.random.Generator,
               counts: np.ndarray | None = None, data_sizes=None,
               losses=None, t: int = 0) -> np.ndarray:
        raise NotImplementedError


class UniformSampler(Sampler):
    """McMahan et al. 2017: uniform without replacement among available."""
    name = "UniformSample"

    def sample(self, *, avail, m, rng, **_):
        avail = np.asarray(avail, bool)
        if not avail.any():
            return _EMPTY
        m = int(min(m, avail.sum()))
        s = uniform_select(_draw_generator(rng), torch.as_tensor(avail), m)
        return np.flatnonzero(s.numpy())


class MDSampler(Sampler):
    """Li et al. 2020: without replacement by weight ∝ local data size,
    among available clients (all-zero sizes draw uniformly)."""
    name = "MDSample"

    def sample(self, *, avail, m, rng, data_sizes=None, **_):
        avail = np.asarray(avail, bool)
        if not avail.any():
            return _EMPTY
        m = int(min(m, avail.sum()))
        s = md_select(_draw_generator(rng), data_sizes, torch.as_tensor(avail),
                      m)
        return np.flatnonzero(s.numpy())


class PowerOfChoiceSampler(Sampler):
    """Cho et al. 2020: draw d = d_factor·m candidates by data size (the
    shared Gumbel top-k draw), then keep the m with the highest probed
    loss (stable on ties, returned sorted)."""
    name = "Power-of-Choice"
    needs_losses = True

    def __init__(self, d_factor: int = 2):
        self.d_factor = d_factor

    def sample(self, *, avail, m, rng, data_sizes=None, losses=None, **_):
        avail = np.asarray(avail, bool)
        if not avail.any():
            return _EMPTY
        m = int(min(m, avail.sum()))
        d = int(min(avail.sum(), max(m, self.d_factor * m)))
        cand_mask = gumbel_topk_select(_draw_generator(rng),
                                       log_size_weights(data_sizes),
                                       torch.as_tensor(avail), d)
        cand = np.flatnonzero(np.asarray(cand_mask))
        order = np.argsort(-np.asarray(losses, float)[cand], kind="stable")
        return np.sort(cand[order[:m]])


@dataclass
class FedGSSampler(Sampler):
    """The paper's method.  ``alpha`` weighs graph dispersion vs count
    balance.  The Eq. 16 solve runs Q-free on ``device``: through the CUDA
    kernels on the card.  ``device`` None means CUDA (and raises without
    one); ``FLEngine`` hands the sampler its own device."""
    alpha: float = 1.0
    max_sweeps: int = 64
    device: object = None

    name = "FedGS"

    def __post_init__(self):
        self.name = f"FedGS(alpha={self.alpha})"
        self.device = resolve_device(self.device, who="FedGSSampler")
        self._h = None

    def to(self, device) -> "FedGSSampler":
        """Solve on ``device`` from now on (an installed H moves along)."""
        self.device = torch.device(device)
        if self._h is not None:
            self._h = self._h.to(self.device)
        return self

    def set_graph(self, h):
        """Install the shortest-path matrix H (numpy or a tensor on any
        device) on the sampler's device, finite-capped and normalized to
        [0, 1] (DESIGN.md assumption log)."""
        self._h = cap_and_normalize(torch.as_tensor(
            h, dtype=torch.float32).to(self.device))

    def sample(self, *, avail, m, rng, counts=None, **_):
        assert self._h is not None, "call set_graph(H) first"
        avail = np.asarray(avail, bool)
        dev = self._h.device
        m_eff = int(min(m, int(avail.sum())))
        s = fedgs_select(self._h,
                         torch.as_tensor(counts, dtype=torch.float32,
                                         device=dev),
                         torch.as_tensor(avail, device=dev), self.alpha,
                         m=m_eff, max_sweeps=self.max_sweeps, m_target=m)
        return np.flatnonzero(s.cpu().numpy())


def make_sampler(name: str, **kw) -> Sampler:
    """Sampler names (as the reference's ``make_sampler``) -> samplers;
    ``kw`` goes to FedGSSampler (``alpha``, ``max_sweeps``, ``device``)."""
    name = name.lower()
    if name in ("uniform", "uniformsample"):
        return UniformSampler()
    if name in ("md", "mdsample"):
        return MDSampler()
    if name in ("poc", "power-of-choice", "powerofchoice"):
        return PowerOfChoiceSampler()
    if name == "fedgs":
        return FedGSSampler(**kw)
    raise ValueError(f"unknown sampler {name!r}")
