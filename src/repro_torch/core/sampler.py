"""Client samplers — the host face over ``core/sampler_device.py`` (the part
of ``repro.core.sampler`` this slice needs).

All samplers see only the available set A_t (immediate availability, as in
the paper) and return SORTED selected indices as numpy; an empty A_t gives
an empty array.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.graph_device import cap_and_normalize
from repro_torch.core.sampler_device import fedgs_select, uniform_select

_EMPTY = np.zeros(0, np.int64)


def _draw_generator(rng: np.random.Generator) -> torch.Generator:
    """One CPU torch generator per draw, seeded from the caller's numpy
    stream, so a run is deterministic given its per-round rngs."""
    return torch.Generator().manual_seed(int(rng.integers(2 ** 31 - 1)))


class Sampler:
    """Stateless-per-round sampler interface."""
    name = "base"

    def sample(self, *, avail: np.ndarray, m: int, rng: np.random.Generator,
               counts: np.ndarray | None = None, data_sizes=None,
               losses=None, t: int = 0) -> np.ndarray:
        raise NotImplementedError


class UniformSampler(Sampler):
    """McMahan et al. 2017: uniform without replacement among available.
    The draw runs on the CPU (N booleans); it matches the reference in
    distribution only (torch's generator is not JAX's)."""
    name = "UniformSample"

    def sample(self, *, avail, m, rng, **_):
        avail = np.asarray(avail, bool)
        if not avail.any():
            return _EMPTY
        m = int(min(m, avail.sum()))
        s = uniform_select(_draw_generator(rng), torch.as_tensor(avail), m)
        return np.flatnonzero(s.numpy())


@dataclass
class FedGSSampler(Sampler):
    """The paper's method.  ``alpha`` weighs graph dispersion vs count
    balance.  The Eq. 16 solve runs on H's device, Q-free: through the CUDA
    kernels when H lies on the card."""
    alpha: float = 1.0
    max_sweeps: int = 64

    name = "FedGS"

    def __post_init__(self):
        self.name = f"FedGS(alpha={self.alpha})"
        self._h = None

    def set_graph(self, h):
        """Install the shortest-path matrix H (a tensor, on the device the
        solve should run on, or numpy for the CPU), finite-capped and
        normalized to [0, 1] (DESIGN.md assumption log)."""
        self._h = cap_and_normalize(torch.as_tensor(h, dtype=torch.float32))

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

