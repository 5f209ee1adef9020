"""The language model, dense family (the port of ``repro.models.lm``).

Parameters keep the reference's layout, held as a flat dict with dotted
keys (``convert.params_from_jax``'s layout): per-layer leaves are stacked
on a leading L axis (``blocks.attn.wq`` is (L, d, Hq·dh)); norm scales are
f32 and everything else is ``cfg.dtype``.  The reference's ``lax.scan``
over layers is a Python loop.  Its activation-sharding hints are no-ops on
one device and are dropped.

Entry points:
  init_params(cfg, seed=, device=)            -> params
  prefill(params, cfg, batch, max_len=None)   -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache)     -> (logits (B, V), cache)

Prefill's causal self-attention runs through the sliding-window kernel,
one launch per layer.  Prefill computes each layer's K/V once, for the
attention and the cache (the reference computes them twice, with the same
result).  ``decode_step`` updates the cache in place (the reference's is
functional: the port saves a copy of the whole cache per token).  Only the
dense family runs; the others raise ``NotImplementedError``.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, rope_angles)


def check_family(cfg: ArchConfig) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.family != "dense":
        raise NotImplementedError(
            f"repro_torch.models.lm runs the dense family only: {cfg.name} "
            f"is of the {cfg.family!r} family, which the port does not run "
            f"yet")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _window(cfg: ArchConfig) -> int | None:
    return cfg.window if cfg.attention == "sliding_window" else None


# ====================================================================== init
def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "attn.norm": torch.ones(d, dtype=torch.float32),
        "attn.wq": dense_init(gen, d, hq * dh, dtype),
        "attn.wk": dense_init(gen, d, hkv * dh, dtype),
        "attn.wv": dense_init(gen, d, hkv * dh, dtype),
        "attn.wo": dense_init(gen, hq * dh, d, dtype),
        "ffn.norm": torch.ones(d, dtype=torch.float32),
        **{f"ffn.{k}": w for k, w in ffn_mod.init_ffn(
            gen, d, cfg.d_ff, cfg.ffn_kind, dtype).items()},
    }


def init_params(cfg: ArchConfig, *, seed: int = 0,
                device=None) -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, the reference's distributions.  They
    are drawn on the CPU, so one seed gives the same weights on every
    device, then moved to ``device`` (None: CUDA, raising without it)."""
    check_family(cfg)
    dev = resolve_device(device, who="repro_torch.models.lm")
    gen = torch.Generator().manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": embed_init(gen, v, d, dtype).to(dev)}
    layers = [_init_block(gen, cfg, dtype) for _ in range(cfg.n_layers)]
    for name in list(layers[0]):
        params[f"blocks.{name}"] = torch.stack(
            [layer.pop(name) for layer in layers]).to(dev)
    params["final_norm"] = torch.ones(d, dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, v, dtype).to(dev)
    return params


def _layer_params(params: dict[str, torch.Tensor], i: int) -> dict[str, dict]:
    """Layer ``i``'s slice of the stacked blocks, nested as the reference's
    per-layer pytree: {"attn": {...}, "ffn": {...}}."""
    out: dict[str, dict] = {}
    for key, t in params.items():
        if key.startswith("blocks."):
            part, name = key[len("blocks."):].split(".", 1)
            out.setdefault(part, {})[name] = t[i]
    return out


# ================================================================ block fwd
def _attn_fwd(p, x, cfg: ArchConfig, *, window, positions):
    """x (B, S, d) -> (attention output (B, S, d), K (B, S, Hkv, dh) after
    RoPE, V (B, S, Hkv, dh)).  The KV heads go to the kernel unrepeated."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, hq, dh)
    k = (h @ p["wk"]).reshape(b, s, hkv, dh)
    v = (h @ p["wv"]).reshape(b, s, hkv, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    o = attn_mod.multihead_attention(q, k, v, causal=True, window=window)
    return o.reshape(b, s, hq * dh) @ p["wo"], k, v


def _ffn_fwd(p, x, cfg: ArchConfig):
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    return ffn_mod.apply_ffn({k: w for k, w in p.items() if k != "norm"}, h,
                             cfg.ffn_kind)


def _block_fwd(p, x, cfg: ArchConfig, *, positions):
    """One dense block (pre-norm, residual).  Returns (x, K, V)."""
    a, k, v = _attn_fwd(p["attn"], x, cfg, window=_window(cfg),
                        positions=positions)
    x = x + a
    return x + _ffn_fwd(p["ffn"], x, cfg), k, v


# =============================================================== embeddings
def _embed_inputs(params, cfg: ArchConfig, batch):
    """Token embedding.  Returns (x (B, S, d), positions (S,))."""
    x = params["embed"][batch["tokens"]]
    return x, torch.arange(x.shape[1], device=x.device)


def _lm_logits(params, cfg: ArchConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


# ============================================================ prefill/decode
def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                      dtype=None, device=None) -> dict:
    """An empty cache: K and V (L, B, max_len, Hkv, dh), zeros; len 0."""
    check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device, who="repro_torch.models.lm")
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"len": 0, "k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def prefill(params, cfg: ArchConfig, batch, max_len: int | None = None):
    """Forward over a prompt, ``batch["tokens"]`` (B, S) int64.  Returns
    (last-position logits (B, V), a cache of ``max_len`` slots (default S)
    holding the prompt's K/V, len S)."""
    check_family(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    cache = init_decode_cache(cfg, b, s if max_len is None else max_len,
                              device=x.device)
    if s > cache["k"].shape[2]:
        raise ValueError(f"prefill: {s} prompt tokens do not fit a cache of "
                         f"{max_len}")
    for i in range(cfg.n_layers):
        x, k, v = _block_fwd(_layer_params(params, i), x, cfg,
                             positions=positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    cache["len"] = s
    return _lm_logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict):
    """One-token decode.  tokens (B,) int64; the cache from ``prefill`` or
    ``init_decode_cache``, updated IN PLACE.  Returns (logits (B, V),
    cache)."""
    check_family(cfg)
    n = cache["len"]
    if n >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache is full ({n} slots)")
    b = tokens.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = params["embed"][tokens][:, None]                      # (B, 1, d)
    pos = torch.full((b, 1), n, dtype=torch.int64, device=x.device)
    cos, sin = rope_angles(pos, dh, cfg.rope_theta)
    for i in range(cfg.n_layers):
        p = _layer_params(params, i)
        pa = p["attn"]
        hn = rms_norm(x, pa["norm"], cfg.norm_eps)
        q = apply_rope((hn @ pa["wq"]).reshape(b, 1, hq, dh), cos, sin)
        k = apply_rope((hn @ pa["wk"]).reshape(b, 1, hkv, dh), cos, sin)
        v = (hn @ pa["wv"]).reshape(b, 1, hkv, dh)
        cache["k"][i, :, n] = k[:, 0]
        cache["v"][i, :, n] = v[:, 0]
        o = attn_mod.decode_attend(q, cache["k"][i], cache["v"][i], n + 1,
                                   window=_window(cfg))
        x = x + o.reshape(b, 1, hq * dh) @ pa["wo"]
        x = x + _ffn_fwd(p["ffn"], x, cfg)
    cache["len"] = n + 1
    return _lm_logits(params, cfg, x)[:, 0], cache
