"""Abstract input and parameter specs for every (architecture x input
shape) (the port of ``repro.launch.specs``).

``abstract_params`` and ``input_specs`` return tensors on the meta device
(shapes and dtypes, no data, no allocation) for the step of the shape's
kind:

  train    -> {batch: {tokens, labels (+ image_emb | audio_frames)}}
  prefill  -> {batch: {tokens (+ image_emb | audio_frames)}}
  decode   -> {tokens (B,), cache: the decode cache of seq_len entries}

Token ids are int32, as the reference's.  The decode cache's ``len`` is
the port's host int (0), where the reference's is an int32 device scalar.
The modality frontends are stubs: VLM patch embeddings and audio frame
embeddings arrive precomputed at the model's d_model width.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, InputShape, pad_heads
from repro_torch.models import lm

META = torch.device("meta")

# perf-variant knob: pad attention heads to this multiple for TP alignment
# (an exact weight embedding, configs.base.pad_heads); None = off.
PAD_HEADS_MULTIPLE = None


def variant_for_shape(cfg: ArchConfig, shape: InputShape) -> ArchConfig:
    """long_500k needs sub-quadratic attention: full-attention archs switch
    to the sliding-window variant (window = cfg.window, default 4096).
    SSM, hybrid and already-windowed archs are unchanged."""
    if shape.name == "long_500k" and cfg.attention == "full":
        cfg = dataclasses.replace(cfg, attention="sliding_window")
    if PAD_HEADS_MULTIPLE and cfg.attention != "none":
        cfg = pad_heads(cfg, PAD_HEADS_MULTIPLE)
    return cfg


def abstract_params(cfg: ArchConfig) -> dict[str, torch.Tensor]:
    """The params of ``lm.init_params`` (same keys, shapes and dtypes) on
    the meta device: nothing drawn or allocated."""
    return lm.init_params(cfg, device=META)


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def input_specs(cfg: ArchConfig, shape: InputShape) -> dict[str, Any]:
    """The arguments of the shape's step, on the meta device."""
    b, s = shape.global_batch, shape.seq_len
    act_dtype = lm.torch_dtype(cfg.dtype)

    if shape.kind in ("train", "prefill"):
        batch: dict[str, Any] = {}
        s_text = s
        if cfg.family == "vlm" and cfg.n_image_tokens:
            s_text = s - cfg.n_image_tokens
            batch["image_emb"] = _meta((b, cfg.n_image_tokens, cfg.d_model),
                                       act_dtype)
        if cfg.enc_dec:
            batch["audio_frames"] = _meta((b, cfg.n_audio_frames,
                                           cfg.d_model), act_dtype)
        batch["tokens"] = _meta((b, s_text), torch.int32)
        if shape.kind == "train":
            batch["labels"] = _meta((b, s_text), torch.int32)
        return {"batch": batch}

    # ---- decode: one token against a seq_len cache -----------------------
    enc_len = cfg.n_audio_frames if cfg.enc_dec else 0
    max_len = s
    if lm.RING_CACHE and cfg.attention == "sliding_window":
        max_len = min(s, cfg.window)     # ring buffer: the window IS the cache
    cache = lm.init_decode_cache(cfg, b, max_len, enc_len=enc_len,
                                 device=META)
    return {"tokens": _meta((b,), torch.int32), "cache": cache}


def _sorted_leaves(tree, path=()):
    """(path, leaf) in ``jax.tree_util``'s order over the reference's
    dicts: keys sorted at every level."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def concrete_inputs(cfg: ArchConfig, shape: InputShape, *, device="cpu"):
    """Real (random) inputs matching ``input_specs``: the reference's
    ``np.random.default_rng(0)`` draws, leaf by leaf in its order, so the
    values are bitwise the reference's (smoke tests at reduced configs).
    The cache's ``len`` takes its draw as a host int, as the reference's
    int32 scalar does."""
    rng = np.random.default_rng(0)
    specs = input_specs(cfg, shape)
    out: dict[str, Any] = {}
    for path, x in _sorted_leaves(specs):
        if isinstance(x, int):                     # the cache's len
            val = int(rng.integers(0, max(cfg.vocab_size - 1, 2), ()))
        elif not x.dtype.is_floating_point:
            val = torch.as_tensor(rng.integers(
                0, max(cfg.vocab_size - 1, 2), tuple(x.shape)),
                dtype=x.dtype, device=device)
        else:
            # the reference draws in f64 and casts once (jnp.asarray)
            a = rng.normal(0, 0.02, tuple(x.shape))
            val = torch.as_tensor(a, device=device).to(x.dtype)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = val
    return out
