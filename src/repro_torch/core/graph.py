"""3DG — the numpy face of the torch pipeline (the part of
``repro.core.graph`` the engine builds its oracle graph through).  The
graph math lives in ``repro_torch.core.graph_device``.  Both functions run
on ``device``: CUDA unless the caller asks for the CPU."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import graph_device as gd


def _numpy(t):
    return None if t is None else t.cpu().numpy()


def finite_cap(h: np.ndarray, scale: float = 2.0, *,
               device=None) -> np.ndarray:
    """Replace inf distances (disconnected pairs) with scale x max finite
    distance so the QUBO objective stays finite."""
    dev = resolve_device(device, who="finite_cap")
    return _numpy(gd.cap_and_normalize(
        torch.as_tensor(np.asarray(h), dtype=torch.float32, device=dev),
        scale=scale, normalize=False))


def build_3dg(features: np.ndarray, *, eps: float = 0.1, sigma2: float = 0.01,
              sim_kind: str = "dot", device=None):
    """features -> (V, R, H) as numpy, built on ``device``.  On CUDA the
    fused kernel never materializes V, so V is None there."""
    cfg = gd.GraphConfig(eps=eps, sigma2=sigma2, similarity=sim_kind)
    dev = resolve_device(device, who="build_3dg")
    u = torch.as_tensor(np.asarray(features), dtype=torch.float32, device=dev)
    v, r, h = gd.build_3dg(u, cfg)
    return _numpy(v), _numpy(r), _numpy(h)
