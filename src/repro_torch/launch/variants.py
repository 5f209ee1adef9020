"""Perf-iteration variants (the port of ``repro.launch.variants``).

A variant is a named, reversible patch of the port's knobs (attention path
thresholds, loss chunking, remat policy, microbatches, cache layout,
sharding rules), applied around a dry-run or a step.  ``baseline`` is the
default configuration; each other variant is one hypothesis of
EXPERIMENTS.md §Perf, under the reference's name.  ``apply_variant(name)``
sets the knobs on entry and restores every one of them on exit.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field

from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import specs as specs_mod
from repro_torch.launch import steps as steps_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import ffn as ffn_mod
from repro_torch.models import lm as lm_mod
from repro_torch.sharding import rules as rules_mod


@dataclass(frozen=True)
class Variant:
    """``knobs``: (module, attribute) -> value while the variant is on;
    ``no_remat``: ``lm.train_loss`` runs with ``remat=False``."""
    doc: str
    knobs: dict = field(default_factory=dict)
    no_remat: bool = False


_DENSE_2K = {(attn_mod, "DENSE_MAX"): 2048}
_MINREMAT = {(lm_mod, "REMAT_POLICY"): "nothing"}
_RING = {(lm_mod, "RING_CACHE"): True}
_TP_ONLY = {(rules_mod, "FSDP_ENABLED"): False}
_PAD16 = {(specs_mod, "PAD_HEADS_MULTIPLE"): 16}


def _micro(n: int) -> dict:
    return {(steps_mod, "MICROBATCHES"): n}


def _remat2(micro: int, grad_dt: str | None = None) -> dict:
    knobs = {**_micro(micro), (lm_mod, "REMAT_GROUP"): 8}
    if grad_dt is not None:
        knobs[(steps_mod, "GRAD_ACC_DTYPE")] = grad_dt
    return knobs


VARIANTS: dict[str, Variant] = {
    "baseline": Variant("the default configuration"),
    "dense_max_2k": Variant(
        "force the chunked (flash-pattern) attention path at train_4k: no "
        "(B, H, S, S) f32 score buffer", _DENSE_2K),
    "loss_chunk_128": Variant(
        "smaller LM-head loss chunks: a smaller transient (B, chunk, V) "
        "logits tile, more head matmuls", {(lm_mod, "LOSS_CHUNK"): 128}),
    "loss_chunk_1k": Variant("LM-head loss chunks of 1,024",
                             {(lm_mod, "LOSS_CHUNK"): 1024}),
    "kv_chunk_2k": Variant(
        "larger KV chunks in the online-softmax path: fewer steps, larger "
        "matmuls", {(attn_mod, "KV_CHUNK"): 2048}),
    "no_remat": Variant(
        "no layer remat: no recompute, every activation saved",
        no_remat=True),
    "minremat": Variant(
        "save-nothing remat: no saved matmul outputs, ~+33% compute",
        _MINREMAT),
    "micro8": Variant("8 microbatches", _micro(8)),
    "micro8_minremat": Variant("8 microbatches, save-nothing remat",
                               {**_MINREMAT, **_micro(8)}),
    "micro16_minremat": Variant("16 microbatches, save-nothing remat",
                                {**_MINREMAT, **_micro(16)}),
    "ring_cache": Variant(
        "a window-sized ring-buffer KV cache for sliding-window decode: no "
        "sequence-sharded cache at long_500k", _RING),
    "chunked_attn": Variant("dense_max_2k under its canonical name",
                            _DENSE_2K),
    "chunked_attn_minremat": Variant("chunked attention, save-nothing remat",
                                     {**_DENSE_2K, **_MINREMAT}),
    "micro8_chunked_minremat": Variant(
        "8 microbatches, chunked attention, save-nothing remat",
        {**_DENSE_2K, **_MINREMAT, **_micro(8)}),
    "tp_only_weights": Variant(
        "weights replicated over the data axis (TP-only): decode gathers "
        "no FSDP-sharded weights, at more weight memory per chip",
        _TP_ONLY),
    "tp_only_ring": Variant("TP-only weights with the ring cache",
                            {**_TP_ONLY, **_RING}),
    "bf16_scores": Variant(
        "bf16 (B, H, S, S) score/prob buffers in the dense attention path",
        {(attn_mod, "SCORE_DTYPE"): "bfloat16"}),
    "remat2_micro16": Variant(
        "2-level remat (groups of 8 layers) + 16 microbatches",
        _remat2(16)),
    "remat2_micro16_gradbf16": Variant(
        "remat2_micro16 with a bf16 gradient accumulator",
        _remat2(16, "bfloat16")),
    "remat2_micro8": Variant(
        "2-level remat (groups of 8 layers) + 8 microbatches", _remat2(8)),
    "headaware": Variant(
        "no-op alias: head-aware TP is the default; tags records made "
        "after it"),
    "legacy_tp": Variant(
        "head-unaware TP rules: attention projections shard whenever the "
        "flat dim divides", {(rules_mod, "HEAD_AWARE_TP"): False}),
    "padded_heads": Variant(
        "attention heads padded to the 16-way TP width (an exact weight "
        "embedding, configs.base.pad_heads)", _PAD16),
    "moe_grouped": Variant(
        "group-local MoE dispatch, one group per dp shard",
        {(ffn_mod, "MOE_GROUPS"): -1}),
    "fsdp_over_pod": Variant(
        "weights and optimizer state over (pod, data) = 32-way instead of "
        "data only (meaningful on the multi-pod mesh)",
        {(mesh_mod, "FSDP_OVER_POD"): True}),
    "ring_padded": Variant("ring_cache + padded_heads stacked",
                           {**_RING, **_PAD16}),
}


def knobs_touched(name: str) -> list[tuple[object, str]]:
    """The (module, attribute) pairs ``name`` sets."""
    v = VARIANTS[name]
    return list(v.knobs) + ([(lm_mod, "train_loss")] if v.no_remat else [])


@contextlib.contextmanager
def apply_variant(name: str):
    """Set variant ``name``'s knobs; restore every one on exit."""
    v = VARIANTS[name]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr in
             knobs_touched(name)]
    try:
        for (mod, attr), value in v.knobs.items():
            setattr(mod, attr, value)
        if v.no_remat:
            inner = lm_mod.train_loss

            def train_loss(params, cfg, batch, **kw):
                kw["remat"] = False
                return inner(params, cfg, batch, **kw)
            lm_mod.train_loss = train_loss
        yield v
    finally:
        for mod, attr, old in reversed(saved):
            setattr(mod, attr, old)
