"""The three step functions of the LM (the port of
``repro.launch.steps``' programs):

  train_step   : forward + backward + AdamW update
  prefill_step : prompt forward + cache build
  serve_step   : ONE token against the cache

``make_shardings`` derives the spec trees of every argument from the path
rules of ``sharding/rules.py``: 2D weight sharding (FSDP x TP), the batch
over dp, the cache over dp (or over its *sequence* when the global batch
is 1, the long_500k layout).  A spec is a tuple per leaf (the reference's
``PartitionSpec``, ``sharding/ctx.py``); the reference wraps them in
``NamedSharding``s for its compiler, the port's dry-run reads each
device's shard from them (``rules.local_shape``).  ``lm.train_loss`` is
looked up at call time, so a variant that patches it (``no_remat``)
reaches the step.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.models import lm
from repro_torch.optim.optimizers import Optimizer, adamw
from repro_torch.sharding import rules
from repro_torch.sharding.ctx import ShardCtx

# Microbatch count for gradient accumulation: the batch is split into
# MICROBATCHES chunks run one after another, dividing the live activations
# by the same factor.
MICROBATCHES = 1
# dtype of the gradient accumulator over the microbatches
GRAD_ACC_DTYPE = "float32"


def value_and_grad(loss_fn, params: dict, *args):
    """(loss, grads) of ``loss_fn(params, *args)`` w.r.t. every leaf of
    ``params``, which are left as they are (the gradient runs through
    detached copies)."""
    p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    with torch.enable_grad():
        loss = loss_fn(p, *args)
        grads = torch.autograd.grad(loss, list(p.values()))
    return loss.detach(), dict(zip(p, grads))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer | None = None):
    """Returns (train_step, optimizer); ``train_step(params, opt_state,
    batch, lr) -> (params, opt_state, loss)``.  The default optimizer keeps
    its moments in bf16, as the reference's."""
    optimizer = optimizer or adamw(state_dtype=torch.bfloat16)
    n_micro = MICROBATCHES

    def loss_fn(p, batch):
        return lm.train_loss(p, cfg, batch)

    def train_step(params, opt_state, batch, lr):
        if n_micro == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            acc_dt = getattr(torch, GRAD_ACC_DTYPE)
            dev = next(iter(params.values())).device
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = {k: torch.zeros(p.shape, dtype=acc_dt, device=dev)
                     for k, p in params.items()}
            for i in range(n_micro):
                mb = {k: x.reshape(n_micro, x.shape[0] // n_micro,
                                   *x.shape[1:])[i] for k, x in batch.items()}
                li, gi = value_and_grad(loss_fn, params, mb)
                loss = loss + li
                grads = {k: a + gi[k].to(a.dtype) for k, a in grads.items()}
            loss = loss / n_micro
            grads = {k: g / n_micro for k, g in grads.items()}
        with torch.no_grad():
            new_params, new_state = optimizer.update(grads, opt_state, params,
                                                     lr)
        return new_params, new_state, loss

    return train_step, optimizer


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch)``: the batch's tokens and the family's
    inputs (``image_emb``, ``audio_frames``) go to ``lm.prefill`` as they
    are."""
    def prefill_step(params, batch):
        with torch.no_grad():
            return lm.prefill(params, cfg, batch)
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``serve_step(params, tokens, cache)``: one token; the cache carries
    what the family's inputs gave prefill (the cross K/V of the audio
    frames, the image prefix's K/V)."""
    def serve_step(params, tokens, cache):
        with torch.no_grad():
            return lm.decode_step(params, cfg, tokens, cache)
    return serve_step


# --------------------------------------------------------------- shardings
def opt_state_specs(param_spec_tree):
    """AdamW's state (``optim/optimizers.adamw``: ``m``, ``v`` per param,
    the step ``t`` a scalar) follows the params' specs."""
    return {"m": param_spec_tree, "v": param_spec_tree, "t": ()}


def make_shardings(cfg: ArchConfig, shape: InputShape, ctx: ShardCtx,
                   params_abs, cache_abs=None, batch_abs=None) -> dict:
    """The spec trees of the step's arguments: ``params``, ``opt`` and, where
    given, ``batch`` and ``cache``."""
    if cfg.attention != "none" and rules.HEAD_AWARE_TP:
        ctx = dataclasses.replace(ctx, head_divisors={
            "wq": cfg.n_heads, "wo": cfg.n_heads,
            "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads})
    pspecs = rules.param_specs(params_abs, ctx)
    out: dict[str, Any] = {"params": pspecs, "opt": opt_state_specs(pspecs)}
    if batch_abs is not None:
        out["batch"] = rules.batch_specs(batch_abs, ctx)
    if cache_abs is not None:
        # batch=1 long-context: shard the cache over *sequence*, unless the
        # ring-cache variant already shrank it to one window (replicated)
        seq_shard = shape.global_batch == 1 and not lm.RING_CACHE
        out["cache"] = rules.cache_specs(cache_abs, ctx, seq_shard=seq_shard)
    return out
