"""The language model, dense and MoE families (the port of
``repro.models.lm``).

Parameters keep the reference's layout, held as a flat dict with dotted
keys (``convert.params_from_jax``'s layout): per-layer leaves are stacked
on a leading L axis (``blocks.attn.wq`` is (L, d, Hq·dh)); norm scales are
f32 and everything else is ``cfg.dtype``.  The reference's ``lax.scan``
over layers is a Python loop.  Its activation-sharding hints are no-ops on
one device and are dropped.

Entry points:
  init_params(cfg, seed=, device=)            -> params
  train_loss(params, cfg, batch, remat=True)  -> scalar loss
  prefill(params, cfg, batch, max_len=None)   -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache)     -> (logits (B, V), cache)

``train_loss`` runs the attention's training route (the reference's pure
paths, with autograd) and the sequence-chunked loss; with ``remat`` each
layer (or group of ``REMAT_GROUP`` layers) runs under
``torch.utils.checkpoint`` and recomputes in backward what
``REMAT_POLICY`` does not save, which changes no bit.  Prefill's causal
self-attention runs through the sliding-window kernel, one launch per
layer.  Prefill computes each layer's K/V once, for the attention and the
cache (the reference computes them twice, with the same result).
``decode_step`` updates the cache in place (the reference's is
functional: the port saves a copy of the whole cache per token).  The
dense and MoE families run; the others raise ``NotImplementedError``.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models.layers import (apply_rope, dense_init, embed_init,
                                       rms_norm, rope_angles)

FAMILIES = ("dense", "moe")


def check_family(cfg: ArchConfig) -> None:
    """Raise for the families the port does not run yet."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch.models.lm runs the dense and moe families only: "
            f"{cfg.name} is of the {cfg.family!r} family, which the port "
            f"does not run yet")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _window(cfg: ArchConfig) -> int | None:
    return cfg.window if cfg.attention == "sliding_window" else None


# ====================================================================== init
def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "attn.norm": torch.ones(d, dtype=torch.float32),
        "attn.wq": dense_init(gen, d, hq * dh, dtype),
        "attn.wk": dense_init(gen, d, hkv * dh, dtype),
        "attn.wv": dense_init(gen, d, hkv * dh, dtype),
        "attn.wo": dense_init(gen, hq * dh, d, dtype),
    }
    if cfg.moe is not None:
        p["moe.norm"] = torch.ones(d, dtype=torch.float32)
        p.update({f"moe.{k}": w for k, w in ffn_mod.init_moe(
            gen, d, cfg.d_ff, cfg.moe.num_experts, cfg.ffn_kind,
            dtype).items()})
    else:
        p["ffn.norm"] = torch.ones(d, dtype=torch.float32)
        p.update({f"ffn.{k}": w for k, w in ffn_mod.init_ffn(
            gen, d, cfg.d_ff, cfg.ffn_kind, dtype).items()})
    return p


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
def _attn_fwd(p, x, cfg: ArchConfig, *, window, positions, train: bool):
    """x (B, S, d) -> (attention output (B, S, d), K (B, S, Hkv, dh) after
    RoPE, V (B, S, Hkv, dh)).  ``train`` takes the training route (the KV
    heads repeated, the reference's dispatch, autograd); else the kernel,
    which takes the KV heads unrepeated."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, hq, dh)
    k = (h @ p["wk"]).reshape(b, s, hkv, dh)
    v = (h @ p["wv"]).reshape(b, s, hkv, dh)
    cos, sin = rope_angles(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if train:
        o = attn_mod.multihead_attention(q, k, v, causal=True, window=window)
    else:
        o = attn_mod.prefill_attention(q, k, v, window=window)
    return o.reshape(b, s, hq * dh) @ p["wo"], k, v


def _ffn_fwd(p, x, cfg: ArchConfig):
    """The block's FFN or MoE on the normed x: (output, aux)."""
    if "moe" in p:
        pm = p["moe"]
        h = rms_norm(x, pm["norm"], cfg.norm_eps)
        return ffn_mod.apply_moe({k: w for k, w in pm.items() if k != "norm"},
                                 h, top_k=cfg.moe.top_k,
                                 capacity_factor=cfg.moe.capacity_factor,
                                 kind=cfg.ffn_kind)
    h = rms_norm(x, p["ffn"]["norm"], cfg.norm_eps)
    return ffn_mod.apply_ffn({k: w for k, w in p["ffn"].items()
                              if k != "norm"}, h, cfg.ffn_kind), None


def _block_fwd(p, x, cfg: ArchConfig, *, positions, train: bool = False):
    """One block (pre-norm, residual).  Returns (x, K, V, aux): aux is the
    MoE's load-balance term, a zero for the dense family."""
    a, k, v = _attn_fwd(p["attn"], x, cfg, window=_window(cfg),
                        positions=positions, train=train)
    x = x + a
    o, aux = _ffn_fwd(p, x, cfg)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + o, k, v, aux


# --- the remat knobs (the reference's perf-variant knobs) ---
# REMAT_POLICY: what a checkpointed layer saves for backward.
#   "dots"    — the matmul outputs without batch dims (aten.mm; the
#               reference's dots_with_no_batch_dims_saveable, default)
#   "nothing" — full recompute
REMAT_POLICY = "dots"
# REMAT_GROUP: 2-level remat — checkpoint groups of G layers, the layers of
# a group unchecked inside it (when G divides the layer count).
REMAT_GROUP = 1


def _save_dots():
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op == torch.ops.aten.mm.default
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _remat(fn, *args, policy: str | None):
    """fn(*args) under a non-reentrant checkpoint: ``policy`` "dots" saves
    the 2-D matmuls' outputs, None/"nothing" saves nothing."""
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=_save_dots)
    return checkpoint(fn, *args, use_reentrant=False)


def _run_blocks(params, x, cfg: ArchConfig, *, positions, remat=False):
    """The training forward over the layers (the reference's ``lax.scan``
    as a loop).  Returns (x, aux summed over the layers)."""
    n_layers = cfg.n_layers
    layers = [_layer_params(params, i) for i in range(n_layers)]

    def body(lo, hi, h, aux):
        for i in range(lo, hi):
            h, _, _, a = _block_fwd(layers[i], h, cfg, positions=positions,
                                    train=True)
            aux = aux + a
        return h, aux

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    g = REMAT_GROUP
    on = remat and torch.is_grad_enabled()
    if on and g > 1 and n_layers % g == 0:
        for lo in range(0, n_layers, g):
            x, aux = _remat(functools.partial(body, lo, lo + g), x, aux,
                            policy=None)
        return x, aux
    for i in range(n_layers):
        if on:
            x, aux = _remat(functools.partial(body, i, i + 1), x, aux,
                            policy=REMAT_POLICY)
        else:
            x, aux = body(i, i + 1, x, aux)
    return x, aux


# =============================================================== embeddings
def _embed(params, tokens: torch.Tensor) -> torch.Tensor:
    """The token rows of the embedding table.  ``F.embedding``: its
    backward sums a token's rows in the same order on every run, on the CPU
    and on CUDA (an indexing backward accumulates in parallel on the CPU,
    a different sum each run)."""
    return F.embedding(tokens, params["embed"])


def _embed_inputs(params, cfg: ArchConfig, batch):
    """Token embedding.  Returns (x (B, S, d), positions (S,))."""
    x = _embed(params, batch["tokens"])
    return x, torch.arange(x.shape[1], device=x.device)


def _lm_logits(params, cfg: ArchConfig, x):
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return x @ head


LOSS_CHUNK = 512


def _loss_chunk(xs, head, ls, ms):
    logits = (xs @ head).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, ls[..., None])[..., 0]
    nll = (lse - gold) * ms.to(torch.float32)
    return torch.sum(nll), torch.sum(ms).to(torch.float32)


def _chunked_cross_entropy(params, cfg: ArchConfig, x, labels, mask):
    """Sequence-chunked LM loss: each (B, chunk, V) logits tile is
    recomputed in backward (a checkpoint), so the full (B, S, V) logits
    never live at once."""
    b, s, _ = x.shape
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    chunk = LOSS_CHUNK if s % LOSS_CHUNK == 0 else s
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c in range(s // chunk):
        part = (x[:, c * chunk:(c + 1) * chunk], head,
                labels[:, c * chunk:(c + 1) * chunk],
                mask[:, c * chunk:(c + 1) * chunk])
        if torch.is_grad_enabled():
            nll, n = checkpoint(_loss_chunk, *part, use_reentrant=False)
        else:
            nll, n = _loss_chunk(*part)
        tot = tot + nll
        cnt = cnt + n
    return tot / torch.clamp_min(cnt, 1.0)


# ==================================================================== train
def train_loss(params, cfg: ArchConfig, batch, *, remat: bool = True,
               aux_weight: float = 0.01) -> torch.Tensor:
    """Next-token LM loss.  batch: tokens (B, S), labels (B, S) int64; a
    label outside [0, vocab) is masked.  The MoE adds ``aux_weight`` times
    its load-balance term averaged over the layers."""
    check_family(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    x, aux = _run_blocks(params, x, cfg, positions=positions, remat=remat)
    labels = batch["labels"]
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    loss = _chunked_cross_entropy(params, cfg, x,
                                  torch.clamp_min(labels, 0), mask)
    if cfg.moe is not None:
        loss = loss + aux_weight * aux / cfg.n_layers
    return loss


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


def prefill(params, cfg: ArchConfig, batch, max_len: int | None = None, *,
            tap=None):
    """Forward over a prompt, ``batch["tokens"]`` (B, S) int64.  Returns
    (last-position logits (B, V), a cache of ``max_len`` slots (default S)
    holding the prompt's K/V, len S).  ``tap(i, x)``, where given, sees
    each layer's output and returns the next layer's input (a test's seam:
    it may hand back another device's x)."""
    check_family(cfg)
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    cache = init_decode_cache(cfg, b, s if max_len is None else max_len,
                              device=x.device)
    if s > cache["k"].shape[2]:
        raise ValueError(f"prefill: {s} prompt tokens do not fit a cache of "
                         f"{max_len}")
    for i in range(cfg.n_layers):
        x, k, v, _ = _block_fwd(_layer_params(params, i), x, cfg,
                                positions=positions)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
        if tap is not None:
            x = tap(i, x)
    cache["len"] = s
    return _lm_logits(params, cfg, x[:, -1:])[:, 0], cache


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                *, tap=None):
    """One-token decode.  tokens (B,) int64; the cache from ``prefill`` or
    ``init_decode_cache``, updated IN PLACE.  Returns (logits (B, V),
    cache).  ``tap`` as in :func:`prefill`."""
    check_family(cfg)
    n = cache["len"]
    if n >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache is full ({n} slots)")
    b = tokens.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = _embed(params, tokens)[:, None]                       # (B, 1, d)
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
        x = x + _ffn_fwd(p, x, cfg)[0]
        if tap is not None:
            x = tap(i, x)
    cache["len"] = n + 1
    return _lm_logits(params, cfg, x)[:, 0], cache
