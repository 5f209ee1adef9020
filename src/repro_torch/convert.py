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


# each block part's leaves: (required, optional)
_ATTN = ({"norm", "wq", "wk", "wv", "wo"}, set())
_LM_PARTS = {
    "attn": _ATTN, "cross": _ATTN,
    "ssm": ({"norm", "w_z", "w_x", "w_B", "w_C", "w_dt", "dt_bias", "A_log",
             "D", "conv_w", "w_out"}, set()),
    "ffn": ({"norm", "w_in", "w_out"}, {"w_gate"}),
    "moe": ({"norm", "router", "w_in", "w_out"}, {"w_gate"}),
}


def _lm_schema(keys) -> tuple[set, set]:
    """The (required, allowed) keys of an LM's params given the parts its
    keys show: a mixer (attention and/or SSD) per block, an FFN or MoE
    where present, cross-attention and the encoder for an enc-dec."""
    need, known = {"embed", "final_norm"}, {"lm_head"}
    enc = any(k.startswith("enc_blocks.") for k in keys)
    groups = [("blocks.", ("attn", "ssm", "cross", "ffn", "moe"))]
    if enc:
        groups.append(("enc_blocks.", ("attn", "ssm", "ffn", "moe")))
        need.add("enc_norm")
    for pre, allowed in groups:
        seen = {k[len(pre):].split(".", 1)[0] for k in keys
                if k.startswith(pre)}
        parts = [p for p in allowed if p in seen]
        if "attn" not in parts and "ssm" not in parts:
            parts.append("attn")                 # a block needs a mixer
        if "moe" in parts and "ffn" in parts:
            parts.remove("ffn")                  # one FFN a block
        for part in parts:
            req, opt = _LM_PARTS[part]
            need |= {f"{pre}{part}.{k}" for k in req}
            known |= {f"{pre}{part}.{k}" for k in opt}
    return need, need | known


def lm_params_from_jax(params, *, device="cpu") -> dict[str, torch.Tensor]:
    """``repro.models.lm.init_params``' pytree (as numpy) -> the port's LM
    parameter dict (``repro_torch.models.lm``: dotted keys, per-layer leaves
    stacked on the leading L axis), bit for bit, for every family: the
    blocks' attention, SSD, cross-attention, FFN or MoE parts, the encoder's
    ``enc_blocks`` and ``enc_norm``.  Raises on a missing or an unknown
    key."""
    out = params_from_jax(params, device=device)
    need, known = _lm_schema(out)
    if not need <= out.keys() <= known:
        raise KeyError(f"not an LM's parameters: missing "
                       f"{sorted(need - out.keys())}, unknown "
                       f"{sorted(out.keys() - known)}")
    return out


def params_to_numpy(params: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
    """A dict of tensors -> the same keys, numpy arrays on the host."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}
