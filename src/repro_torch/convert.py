"""Carry parameters between the JAX package and the port.

JAX params are pytrees of arrays: convert them to numpy first
(``jax.tree_util.tree_map(np.asarray, params)``) and hand the result here.
Nested dicts flatten to dotted keys.  Layouts are kept as they are (the port's
models use the JAX layouts).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, *, device="cpu", prefix: str = "") -> dict[str, torch.Tensor]:
    """A (nested) dict of numpy arrays -> flat dict of float tensors."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(params_from_jax(v, device=device, prefix=key + "."))
        else:
            out[key] = torch.as_tensor(np.array(v, copy=True), device=device)
    return out


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A dict of tensors -> the same keys, numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
