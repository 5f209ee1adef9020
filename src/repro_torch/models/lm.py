"""The language model, all six families (the port of ``repro.models.lm``):

  dense   — GQA attention + (SwiGLU | squared-ReLU) FFN
  moe     — GQA attention + token-choice top-k MoE FFN
  ssm     — Mamba-2/SSD mixer, no FFN
  hybrid  — parallel attention + SSD heads, then FFN (Hymba)
  vlm     — dense/GQA decoder over [image embeddings ; token embeddings]
  audio   — enc-dec: bidirectional encoder over frame embeddings, causal
            decoder with cross-attention

Parameters keep the reference's layout, held as a flat dict with dotted
keys (``convert.params_from_jax``'s layout): per-layer leaves are stacked
on a leading L axis (``blocks.attn.wq`` is (L, d, Hq·dh); the encoder's
under ``enc_blocks.``); norm scales and the SSD's dt_bias / A_log / D are
f32 and everything else is ``cfg.dtype``.  The reference's ``lax.scan``
over layers is a Python loop.  Its activation-sharding hints are no-ops on
one device and are dropped.

Entry points:
  init_params(cfg, seed=, device=, draw=)      -> params
  train_loss(params, cfg, batch, remat=True)   -> scalar loss
  prefill(params, cfg, batch, max_len=None)    -> (last logits (B, V), cache)
  decode_step(params, cfg, tokens, cache)      -> (logits (B, V), cache)

``batch`` holds ``tokens`` (and ``labels`` to train), plus ``image_emb``
(B, Ni, d) for the VLM (a prefix before the tokens) and ``audio_frames``
(B, Nf, d) for the audio family (the encoder's input).

``train_loss`` runs the attention's training route (the reference's pure
paths, with autograd) and the sequence-chunked loss; with ``remat`` each
layer (or group of ``REMAT_GROUP`` layers) runs under
``torch.utils.checkpoint`` and recomputes in backward what
``REMAT_POLICY`` does not save, which changes no bit.  Prefill's causal
self-attention runs through the sliding-window kernel, one launch per
layer with attention; the encoder and cross-attention take the plain
bidirectional route, as the reference's do.  Prefill computes each layer's
K/V and SSD states once, for the block and the cache (the reference
computes them twice, with the same result).  ``decode_step`` updates the
cache in place (the reference's is functional: the port saves a copy of
the whole cache per token); with ``RING_CACHE`` a sliding-window model
whose cache holds exactly ``window`` slots writes slot len % W and reads
the ring.
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
from repro_torch.models import ssd as ssd_mod
from repro_torch.models.layers import (MetaDraws, apply_rope, dense_init,
                                       embed_init, rms_norm, rope_angles)

FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")

# RING_CACHE: sliding-window decode keeps a ring buffer of ``window`` slots
# instead of the whole sequence's K/V (the reference's long-context knob);
# it applies to a cache that holds exactly ``window`` slots.
RING_CACHE = False


def check_family(cfg: ArchConfig) -> None:
    """Raise for a family the model does not know."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"repro_torch.models.lm runs the families {FAMILIES}: {cfg.name} "
            f"is of the {cfg.family!r} family")


def torch_dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def _window(cfg: ArchConfig) -> int | None:
    return cfg.window if cfg.attention == "sliding_window" else None


# ====================================================================== init
def _init_attn(gen: torch.Generator, cfg: ArchConfig, dtype) -> dict:
    d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {"norm": torch.ones(d, dtype=torch.float32, device=gen.device),
            "wq": dense_init(gen, d, hq * dh, dtype),
            "wk": dense_init(gen, d, hkv * dh, dtype),
            "wv": dense_init(gen, d, hkv * dh, dtype),
            "wo": dense_init(gen, hq * dh, d, dtype)}


def _init_block(gen: torch.Generator, cfg: ArchConfig, dtype, *,
                cross: bool = False) -> dict:
    """One layer's leaves, dotted: attention where the config has it, the
    SSD mixer where it has one, cross-attention in an enc-dec decoder, and
    the FFN or MoE where d_ff > 0."""
    d = cfg.d_model
    parts: dict[str, dict] = {}
    if cfg.attention != "none":
        parts["attn"] = _init_attn(gen, cfg, dtype)
    if cfg.ssm is not None:
        parts["ssm"] = {"norm": torch.ones(d, dtype=torch.float32,
                                           device=gen.device),
                        **ssd_mod.init_ssd(gen, d, cfg.ssm, dtype)}
    if cross:
        parts["cross"] = _init_attn(gen, cfg, dtype)
    if cfg.d_ff > 0:
        norm = torch.ones(d, dtype=torch.float32, device=gen.device)
        if cfg.moe is not None:
            parts["moe"] = {"norm": norm, **ffn_mod.init_moe(
                gen, d, cfg.d_ff, cfg.moe.num_experts, cfg.ffn_kind, dtype)}
        else:
            parts["ffn"] = {"norm": norm, **ffn_mod.init_ffn(
                gen, d, cfg.d_ff, cfg.ffn_kind, dtype)}
    return {f"{part}.{k}": w for part, leaves in parts.items()
            for k, w in leaves.items()}


def _stacked(layers: list[dict], prefix: str, dev) -> dict:
    return {f"{prefix}{name}": torch.stack(
        [layer.pop(name) for layer in layers]).to(dev)
        for name in list(layers[0])}


def init_params(cfg: ArchConfig, *, seed: int = 0, device=None,
                draw: str = "host") -> dict[str, torch.Tensor]:
    """Random weights from ``seed``, the reference's distributions, moved to
    ``device`` (None: CUDA, raising without it).  ``draw="host"`` draws them
    on the CPU, so one seed gives the same weights on every device;
    ``draw="device"`` draws them on ``device``'s own generator (other
    numbers, the same distributions; seconds instead of minutes for a
    model of billions of parameters on the card).  ``device="meta"``
    builds the same keys, shapes and dtypes on the meta device: nothing
    is drawn or allocated (``launch/specs.abstract_params``)."""
    check_family(cfg)
    dev = resolve_device(device, who="repro_torch.models.lm")
    if draw not in ("host", "device"):
        raise ValueError(f"init_params: draw is 'host' or 'device', got "
                         f"{draw!r}")
    if dev.type == "meta":
        gen = MetaDraws()
    else:
        gen = torch.Generator(device=dev if draw == "device" else "cpu")
        gen.manual_seed(seed)
    dtype = torch_dtype(cfg.dtype)
    v, d = cfg.padded_vocab, cfg.d_model
    params = {"embed": embed_init(gen, v, d, dtype).to(dev)}
    params.update(_stacked([_init_block(gen, cfg, dtype, cross=cfg.enc_dec)
                            for _ in range(cfg.n_layers)], "blocks.", dev))
    params["final_norm"] = torch.ones(d, dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(gen, d, v, dtype).to(dev)
    if cfg.enc_dec:
        params.update(_stacked([_init_block(gen, cfg, dtype)
                                for _ in range(cfg.n_enc_layers)],
                               "enc_blocks.", dev))
        params["enc_norm"] = torch.ones(d, dtype=torch.float32, device=dev)
    return params


_PADDED_ATTN = ("blocks.attn.", "blocks.cross.", "enc_blocks.attn.")


def embed_params_padded(params: dict, cfg: ArchConfig,
                        cfg_p: ArchConfig) -> dict:
    """The exact embedding of a model's weights into the head-padded layout
    (``configs.base.pad_heads``): real q head j goes to slot (j // n0)·n1 +
    j % n0, so the uniform KV-head mapping keeps it on its original KV
    head; pad q slots get zero wq columns and zero wo rows (their attention
    output is dropped exactly); pad KV slots get zero wk / wv (read only by
    pad q slots).  Returns params for ``cfg_p`` with the same function; a
    layout copy, bit for bit the reference's."""
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    hq_p, hkv_p = cfg_p.n_heads, cfg_p.n_kv_heads
    n0, n1 = hq // hkv, hq_p // hkv_p
    new = dict(params)
    for pre in _PADDED_ATTN:
        if pre + "wq" not in params:
            continue
        wq = params[pre + "wq"]
        n_l, d, _ = wq.shape
        slot = torch.tensor([(j // n0) * n1 + j % n0 for j in range(hq)],
                            device=wq.device)
        out = wq.new_zeros((n_l, d, hq_p, dh))
        out[:, :, slot] = wq.reshape(n_l, d, hq, dh)
        new[pre + "wq"] = out.reshape(n_l, d, hq_p * dh)
        wo = params[pre + "wo"]
        out = wo.new_zeros((n_l, hq_p, dh, d))
        out[:, slot] = wo.reshape(n_l, hq, dh, d)
        new[pre + "wo"] = out.reshape(n_l, hq_p * dh, d)
        for name in ("wk", "wv"):
            w = params[pre + name]
            out = w.new_zeros((n_l, d, hkv_p, dh))
            out[:, :, :hkv] = w.reshape(n_l, d, hkv, dh)
            new[pre + name] = out.reshape(n_l, d, hkv_p * dh)
    return new


def _layer_params(params: dict[str, torch.Tensor], i: int,
                  prefix: str = "blocks.") -> dict[str, dict]:
    """Layer ``i``'s slice of the stacked blocks under ``prefix``, nested
    as the reference's per-layer pytree: {"attn": {...}, "ffn": {...}}."""
    out: dict[str, dict] = {}
    for key, t in params.items():
        if key.startswith(prefix):
            part, name = key[len(prefix):].split(".", 1)
            out.setdefault(part, {})[name] = t[i]
    return out


# ================================================================ block fwd
def _cross_kv(p, mem, cfg: ArchConfig):
    """The encoder memory (B, Se, d) projected to one layer's cross K/V."""
    b, se, _ = mem.shape
    hkv, dh = cfg.n_kv_heads, cfg.head_dim
    return ((mem @ p["wk"]).reshape(b, se, hkv, dh),
            (mem @ p["wv"]).reshape(b, se, hkv, dh))


def _attn_fwd(p, x, cfg: ArchConfig, *, window, positions, train: bool,
              causal: bool = True, kv=None):
    """x (B, S, d) -> (attention output (B, S, d), K (B, Sk, Hkv, dh) after
    RoPE, V).  ``kv``: cross-attention's (K, V) from the encoder memory (no
    RoPE, bidirectional).  Causal self-attention in prefill takes the
    kernel (KV heads unrepeated); training (``train``) and the
    bidirectional attention take the training route (the reference's
    dispatch)."""
    b, s, _ = x.shape
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = rms_norm(x, p["norm"], cfg.norm_eps)
    q = (h @ p["wq"]).reshape(b, s, hq, dh)
    if kv is None:
        k = (h @ p["wk"]).reshape(b, s, hkv, dh)
        v = (h @ p["wv"]).reshape(b, s, hkv, dh)
        cos, sin = rope_angles(positions, dh, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    else:
        k, v = kv
    if train or not causal:
        o = attn_mod.multihead_attention(q, k, v, causal=causal,
                                         window=window)
    else:
        o = attn_mod.prefill_attention(q, k, v, window=window)
    return o.reshape(b, s, hq * dh) @ p["wo"], k, v


def _ffn_fwd(p, x, cfg: ArchConfig):
    """The block's FFN or MoE on the normed x: (output, aux); (None, None)
    for a block without one."""
    if "moe" in p:
        pm = p["moe"]
        h = rms_norm(x, pm["norm"], cfg.norm_eps)
        return ffn_mod.apply_moe({k: w for k, w in pm.items() if k != "norm"},
                                 h, top_k=cfg.moe.top_k,
                                 capacity_factor=cfg.moe.capacity_factor,
                                 kind=cfg.ffn_kind)
    if "ffn" in p:
        h = rms_norm(x, p["ffn"]["norm"], cfg.norm_eps)
        return ffn_mod.apply_ffn({k: w for k, w in p["ffn"].items()
                                  if k != "norm"}, h, cfg.ffn_kind), None
    return None, None


def _ssd_params(p) -> dict:
    return {k: w for k, w in p["ssm"].items() if k != "norm"}


def _mix(x, a, m):
    """The residual after the mixers: the hybrid's parallel branches
    mean-fused, x + 0.5·(a + m); else the one branch there is."""
    if a is not None and m is not None:
        return x + 0.5 * (a + m)
    if a is not None:
        return x + a
    return x if m is None else x + m


def _block_fwd(p, x, cfg: ArchConfig, *, positions, train: bool = False,
               causal: bool = True, enc_kv=None):
    """One block (pre-norm, residual).  Returns (x, aux, states): aux is
    the MoE's load-balance term (a zero otherwise); ``states`` holds the
    self-attention's ``k``, ``v`` and the SSD's ``ssm``, ``conv`` where the
    block has them.  ``enc_kv``: this layer's cross (K, V)."""
    states, a, m = {}, None, None
    if "attn" in p:
        a, states["k"], states["v"] = _attn_fwd(
            p["attn"], x, cfg, window=_window(cfg), positions=positions,
            train=train, causal=causal)
    if "ssm" in p:
        m, (states["ssm"], states["conv"]) = ssd_mod.apply_ssd(
            _ssd_params(p), rms_norm(x, p["ssm"]["norm"], cfg.norm_eps),
            cfg.ssm)
    x = _mix(x, a, m)
    if enc_kv is not None and "cross" in p:
        x = x + _attn_fwd(p["cross"], x, cfg, window=None, positions=None,
                          train=train, causal=False, kv=enc_kv)[0]
    o, aux = _ffn_fwd(p, x, cfg)
    if o is not None:
        x = x + o
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, aux, states


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


def _run_blocks(params, x, cfg: ArchConfig, *, positions, remat=False,
                enc_mem=None):
    """The training forward over the decoder layers (the reference's
    ``lax.scan`` as a loop), cross-attending to ``enc_mem`` where given.
    Returns (x, aux summed over the layers)."""
    n_layers = cfg.n_layers
    layers = [_layer_params(params, i) for i in range(n_layers)]

    def body(lo, hi, h, aux):
        for i in range(lo, hi):
            enc_kv = None if enc_mem is None else \
                _cross_kv(layers[i]["cross"], enc_mem, cfg)
            h, a, _ = _block_fwd(layers[i], h, cfg, positions=positions,
                                 train=True, enc_kv=enc_kv)
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
    """Token embedding, after the VLM's image-embedding prefix where the
    batch has one.  Returns (x (B, S, d), positions (S,))."""
    x = _embed(params, batch["tokens"])
    if cfg.family == "vlm" and "image_emb" in batch:
        x = torch.cat([batch["image_emb"].to(x.dtype), x], dim=1)
    return x, torch.arange(x.shape[1], device=x.device)


def _encode(params, cfg: ArchConfig, frames, *, tap=None):
    """The bidirectional encoder over precomputed frame embeddings (the
    audio stub), then ``enc_norm``; without remat in training too, as the
    reference's.  ``tap`` as in :func:`prefill`."""
    x = frames.to(torch_dtype(cfg.dtype))
    pos = torch.arange(x.shape[1], device=x.device)
    for i in range(cfg.n_enc_layers):
        x, _, _ = _block_fwd(_layer_params(params, i, "enc_blocks."), x, cfg,
                             positions=pos, causal=False)
        if tap is not None:
            x = tap(i, x)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


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
    """Next-token LM loss.  batch: tokens (B, S), labels (B, S) int64, and
    the family's inputs (``image_emb``, whose positions get label −1;
    ``audio_frames``, which the audio family needs); a label outside
    [0, vocab) is masked.  The MoE adds ``aux_weight`` times its
    load-balance term averaged over the layers."""
    check_family(cfg)
    enc = _encode(params, cfg, batch["audio_frames"]) if cfg.enc_dec \
        else None
    x, positions = _embed_inputs(params, cfg, batch)
    x, aux = _run_blocks(params, x, cfg, positions=positions, remat=remat,
                         enc_mem=enc)
    labels = batch["labels"].long()            # int32 ids index as int64
    if x.shape[1] != labels.shape[1]:          # the VLM's image prefix
        labels = torch.cat([labels.new_full(
            (labels.shape[0], x.shape[1] - labels.shape[1]), -1), labels],
            dim=1)
    mask = (labels >= 0) & (labels < cfg.vocab_size)
    loss = _chunked_cross_entropy(params, cfg, x,
                                  torch.clamp_min(labels, 0), mask)
    if cfg.moe is not None:
        loss = loss + aux_weight * aux / cfg.n_layers
    return loss


# ============================================================ prefill/decode
def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int, *,
                      enc_len: int = 0, dtype=None, device=None) -> dict:
    """An empty cache, zeros, len 0: K and V (L, B, max_len, Hkv, dh) with
    attention; the SSD's ``ssm`` (L, B, H, P, N) f32 and ``conv`` (L, B,
    K − 1, C) with an SSD mixer; the cross K/V ``enc_k``, ``enc_v`` (L, B,
    enc_len, Hkv, dh) for the audio family."""
    check_family(cfg)
    dtype = dtype or torch_dtype(cfg.dtype)
    dev = resolve_device(device, who="repro_torch.models.lm")
    n_l = cfg.n_layers
    cache: dict = {"len": 0}

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)
    if cfg.attention != "none":
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        cache["k"] = zeros(n_l, batch, max_len, hkv, dh)
        cache["v"] = zeros(n_l, batch, max_len, hkv, dh)
    if cfg.ssm is not None:
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        cache["ssm"] = zeros(n_l, batch, d_in // s.head_dim, s.head_dim,
                             s.d_state, dt=torch.float32)
        cache["conv"] = zeros(n_l, batch, s.d_conv - 1, d_in + 2 * s.d_state)
    if cfg.enc_dec:
        hkv, dh = cfg.n_kv_heads, cfg.head_dim
        cache["enc_k"] = zeros(n_l, batch, enc_len, hkv, dh)
        cache["enc_v"] = zeros(n_l, batch, enc_len, hkv, dh)
    return cache


def prefill(params, cfg: ArchConfig, batch, max_len: int | None = None, *,
            tap=None):
    """Forward over a prompt, ``batch["tokens"]`` (B, S) int64 (after the
    VLM's ``image_emb``, over the audio family's ``audio_frames``).
    Returns (last-position logits (B, V), a cache of ``max_len`` slots
    (default: the prompt's positions) holding the prompt's K/V, the SSD
    states and the cross K/V, len = the prompt's positions).  ``tap(i,
    x)``, where given, sees each layer's output (the encoder's layers
    first) and returns the next layer's input (a test's seam: it may hand
    back another device's x)."""
    check_family(cfg)
    enc = _encode(params, cfg, batch["audio_frames"], tap=tap) \
        if cfg.enc_dec else None
    x, positions = _embed_inputs(params, cfg, batch)
    b, s, _ = x.shape
    cache = init_decode_cache(
        cfg, b, s if max_len is None else max_len,
        enc_len=0 if enc is None else enc.shape[1], device=x.device)
    if "k" in cache and s > cache["k"].shape[2]:
        raise ValueError(f"prefill: {s} prompt positions do not fit a cache "
                         f"of {max_len}")
    for i in range(cfg.n_layers):
        p = _layer_params(params, i)
        enc_kv = None
        if enc is not None:
            enc_kv = _cross_kv(p["cross"], enc, cfg)
            cache["enc_k"][i], cache["enc_v"][i] = enc_kv
        x, _, st = _block_fwd(p, x, cfg, positions=positions, enc_kv=enc_kv)
        if "k" in st:
            cache["k"][i, :, :s] = st["k"]
            cache["v"][i, :, :s] = st["v"]
        if "ssm" in st:
            cache["ssm"][i] = st["ssm"]
            cache["conv"][i] = st["conv"]
        if tap is not None:
            x = tap(i, x)
    cache["len"] = s
    return _lm_logits(params, cfg, x[:, -1:])[:, 0], cache


def _decode_layer(p, x, cfg: ArchConfig, cache: dict, i: int, n: int,
                  rope, ring: bool):
    """Layer ``i`` of a decode step: x (B, 1, d) at position ``n``; the
    layer's cache entries are updated in place."""
    b = x.shape[0]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a = m = None
    if "attn" in p:
        pa = p["attn"]
        hn = rms_norm(x, pa["norm"], cfg.norm_eps)
        q = apply_rope((hn @ pa["wq"]).reshape(b, 1, hq, dh), *rope)
        k = apply_rope((hn @ pa["wk"]).reshape(b, 1, hkv, dh), *rope)
        v = (hn @ pa["wv"]).reshape(b, 1, hkv, dh)
        window = _window(cfg)
        slot = n % window if ring else n
        cache["k"][i, :, slot] = k[:, 0]
        cache["v"][i, :, slot] = v[:, 0]
        if ring:
            o = attn_mod.decode_attend_ring(q, cache["k"][i], cache["v"][i],
                                            n, window=window)
        else:
            o = attn_mod.decode_attend(q, cache["k"][i], cache["v"][i], n + 1,
                                       window=window)
        a = o.reshape(b, 1, hq * dh) @ pa["wo"]
    if "ssm" in p:
        m, (st, cv) = ssd_mod.ssd_decode_step(
            _ssd_params(p), rms_norm(x, p["ssm"]["norm"], cfg.norm_eps),
            cfg.ssm, cache["ssm"][i], cache["conv"][i])
        cache["ssm"][i] = st
        cache["conv"][i] = cv
    x = _mix(x, a, m)
    if "cross" in p:
        pc = p["cross"]
        hn = rms_norm(x, pc["norm"], cfg.norm_eps)
        q = (hn @ pc["wq"]).reshape(b, 1, hq, dh)
        o = attn_mod.decode_attend(q, cache["enc_k"][i], cache["enc_v"][i],
                                   cache["enc_k"].shape[2], window=None)
        x = x + o.reshape(b, 1, hq * dh) @ pc["wo"]
    o, _ = _ffn_fwd(p, x, cfg)
    return x if o is None else x + o


def decode_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache: dict,
                *, tap=None):
    """One-token decode.  tokens (B,) int64; the cache from ``prefill`` or
    ``init_decode_cache``, updated IN PLACE (the cross K/V stay as they
    are).  Returns (logits (B, V), cache).  ``tap`` as in
    :func:`prefill` (decoder layers only)."""
    check_family(cfg)
    n = cache["len"]
    window = _window(cfg)
    ring = (RING_CACHE and window is not None and "k" in cache
            and cache["k"].shape[2] == window)
    if "k" in cache and not ring and n >= cache["k"].shape[2]:
        raise ValueError(f"decode_step: the cache is full ({n} slots)")
    x = _embed(params, tokens)[:, None]                       # (B, 1, d)
    pos = torch.full((tokens.shape[0], 1), n, dtype=torch.int64,
                     device=x.device)
    rope = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.n_layers):
        x = _decode_layer(_layer_params(params, i), x, cfg, cache, i, n,
                          rope, ring)
        if tap is not None:
            x = tap(i, x)
    cache["len"] = n + 1
    return _lm_logits(params, cfg, x)[:, 0], cache
