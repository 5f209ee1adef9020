"""Learning-rate schedules (the port of ``repro.optim.schedules``; numpy
only, a copy)."""
from __future__ import annotations

import numpy as np


def constant(lr: float):
    return lambda t: lr


def round_decay(lr: float, factor: float = 0.998):
    """The paper's per-round decay (x0.998 each communication round)."""
    return lambda t: lr * (factor ** t)


def cosine_warmup(peak: float, warmup: int, total: int, floor: float = 0.0):
    def f(t):
        if t < warmup:
            return peak * (t + 1) / warmup
        frac = (t - warmup) / max(total - warmup, 1)
        return floor + 0.5 * (peak - floor) * (1 + np.cos(np.pi * min(frac, 1.0)))
    return f
