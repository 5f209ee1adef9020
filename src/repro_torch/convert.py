"""Carry parameters between the JAX package and the port.

JAX params are pytrees of arrays: convert them to numpy first
(``jax.tree_util.tree_map(np.asarray, params)``) and hand the result here.
Nested dicts flatten to dotted keys.  Layouts are kept as they are (the port's
models use the JAX layouts), and so are the values, bit for bit: a bf16
leaf (numpy dtype ``ml_dtypes.bfloat16``, which torch cannot take) crosses
as its 16-bit pattern.
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
            out[key] = _leaf(np.asarray(v)).to(device)
    return out


def _leaf(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        # uint16 bits -> int16 (torch takes no uint16 from numpy) -> bf16
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.as_tensor(np.array(a, copy=True))


def lm_params_from_jax(params, *, device="cpu") -> dict[str, torch.Tensor]:
    """``repro.models.lm.init_params``' pytree (as numpy) -> the port's LM
    parameter dict (``repro_torch.models.lm``: dotted keys, per-layer leaves
    stacked on the leading L axis), bit for bit.  Raises on a pytree that is
    not a dense or an MoE LM's."""
    out = params_from_jax(params, device=device)
    part = "moe" if any(k.startswith("blocks.moe.") for k in out) else "ffn"
    need = {"embed", "final_norm", "blocks.attn.norm", "blocks.attn.wq",
            "blocks.attn.wk", "blocks.attn.wv", "blocks.attn.wo",
            f"blocks.{part}.norm", f"blocks.{part}.w_in",
            f"blocks.{part}.w_out"} | (
                {"blocks.moe.router"} if part == "moe" else set())
    known = need | {"lm_head", f"blocks.{part}.w_gate"}
    if not need <= out.keys() <= known:
        raise KeyError(f"not a dense LM's or an MoE LM's parameters: "
                       f"missing {sorted(need - out.keys())}, unknown "
                       f"{sorted(out.keys() - known)}")
    return out


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A dict of tensors -> the same keys, numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
