"""The dense feed-forward block (the port of ``repro.models.ffn``'s
``init_ffn`` / ``apply_ffn``): SwiGLU or squared-ReLU.  The token-choice
MoE of the reference waits for the MoE family."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init


def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype: torch.dtype) -> dict[str, torch.Tensor]:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype),
         "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def apply_ffn(p: dict[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    h = x @ p["w_in"]
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif kind == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return h @ p["w_out"]
