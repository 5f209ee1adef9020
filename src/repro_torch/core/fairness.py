"""Fairness / long-term-bias metrics (paper Eq. 6, Fig. 4).

Each metric has a host (numpy, float64) face and a torch twin (``*_device``,
float32 on the counts' device).  The numpy faces are copies of
``repro.core.fairness``; the twins follow its ``*_device`` op order.
"""
from __future__ import annotations

import numpy as np
import torch


def count_variance(counts: np.ndarray) -> float:
    """Var(v^t) with the paper's 1/(N-1) normalization (Eq. 6)."""
    v = np.asarray(counts, np.float64)
    n = len(v)
    return float(np.sum((v - v.mean()) ** 2) / max(n - 1, 1))


def count_range(counts: np.ndarray) -> int:
    v = np.asarray(counts)
    return int(v.max() - v.min())


def gini(counts: np.ndarray) -> float:
    """Gini coefficient of the sampling counts (0 = perfectly fair)."""
    v = np.sort(np.asarray(counts, np.float64))
    n = len(v)
    if v.sum() == 0:
        return 0.0
    cum = np.cumsum(v)
    return float((n + 1 - 2 * np.sum(cum) / cum[-1]) / n)


# -------------------------------------------------------------- torch twins
# Each reduces over the last axis: counts (N,) or (C, N) for C cells.
def count_variance_device(counts: torch.Tensor) -> torch.Tensor:
    v = counts.to(torch.float32)
    n = v.shape[-1]
    return torch.sum((v - v.mean(-1, keepdim=True)) ** 2, -1) / max(n - 1, 1)


def count_range_device(counts: torch.Tensor) -> torch.Tensor:
    return counts.amax(-1) - counts.amin(-1)


def gini_device(counts: torch.Tensor) -> torch.Tensor:
    """The zero-sum guard is a ``where`` over a 1e-12-floored denominator,
    so the twin needs no host sync."""
    v = torch.sort(counts.to(torch.float32), dim=-1).values
    n = v.shape[-1]
    cum = torch.cumsum(v, -1)
    tot = cum[..., -1]
    g = (n + 1 - 2.0 * torch.sum(cum, -1) / torch.clamp_min(tot, 1e-12)) / n
    return torch.where(tot > 0, g, torch.zeros_like(g))
