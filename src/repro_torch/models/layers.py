"""Shared neural-net primitives (the port of ``repro.models.layers``).

The f32 upcast and the cast back to the input dtype sit where the reference
puts them, so in f32 the port agrees with it to round-off and in bf16 both
round at the same points.  Initializers draw from a ``torch.Generator``:
the same distributions as the reference's ``jax.random`` draws, not the
same numbers (tests carry the reference's weights across instead).
"""
from __future__ import annotations

import math

import torch

_SQRT2 = math.sqrt(2.0)


class MetaDraws:
    """Stands in for a ``torch.Generator`` where only shapes and dtypes are
    wanted: every draw is a tensor on the meta device (no data, no
    allocation).  ``lm.init_params(cfg, device="meta")`` takes it."""
    device = torch.device("meta")


def draw_kw(gen) -> dict:
    """The keywords of a ``torch.rand``/``randn`` draw from ``gen`` (a
    ``torch.Generator`` or :class:`MetaDraws`) on its device."""
    if isinstance(gen, MetaDraws):
        return {"device": gen.device}
    return {"generator": gen, "device": gen.device}


def _truncated_normal(gen: torch.Generator, shape, lo: float = -3.0,
                      hi: float = 3.0) -> torch.Tensor:
    """Standard normal truncated to [lo, hi], f32, by inverting the CDF of a
    uniform draw on [Φ(lo), Φ(hi)] (one pass, no rejection loop)."""
    cdf_lo = 0.5 * (1.0 + math.erf(lo / _SQRT2))
    cdf_hi = 0.5 * (1.0 + math.erf(hi / _SQRT2))
    u = torch.rand(shape, generator=gen, dtype=torch.float32,
                   device=gen.device)
    u = (cdf_lo + u * (cdf_hi - cdf_lo)) * 2.0 - 1.0
    return (torch.erfinv(u) * _SQRT2).clamp_(lo, hi)


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """Truncated-normal (±3) fan-in init, scale 1/sqrt(in) (LLaMA-style)."""
    if isinstance(gen, MetaDraws):      # shapes only: no arithmetic
        return torch.empty((in_dim, out_dim), dtype=dtype, device=gen.device)
    scale = 1.0 / math.sqrt(in_dim)
    return (_truncated_normal(gen, (in_dim, out_dim)) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    """N(0, 0.02²) embedding table."""
    if isinstance(gen, MetaDraws):
        return torch.empty((vocab, dim), dtype=dtype, device=gen.device)
    return (torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                        device=gen.device) * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.to(torch.float32)).to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables for integer positions -> (..., head_dim // 2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32,
                        device=positions.device) / half
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); cos/sin (S, D/2) or broadcastable (..., D/2)."""
    dt = x.dtype
    x = x.to(torch.float32)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    # broadcast cos/sin over batch and heads, as the reference does
    while cos.dim() < x1.dim():
        if cos.dim() < x1.dim() - 1:
            cos, sin = cos[None], sin[None]
        else:
            cos, sin = cos[..., None, :], sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Mean masked token cross entropy.  logits (B, S, V), accumulated in
    f32; labels (B, S) int64; mask (B, S)."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - gold
    mask = mask.to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp_min(torch.sum(mask), 1.0)
