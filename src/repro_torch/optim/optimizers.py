"""Minimal optax-style optimizers over params dicts (the port of
``repro.optim.optimizers``): pure functions, no in-place update.

``adamw(state_dtype=torch.bfloat16)`` keeps the first and second moments in
bf16 (the memory plan for the large dense archs); by default they take
each param's dtype.  The update runs in the reference's op order: the
moments and the step in f32, then cast back; ``c1 = 1 − b1**t`` and
``c2`` in f32 from the step count.  ``lr`` is a Python float or a 0-dim
f32 tensor.  Call ``update`` under ``torch.no_grad()`` (or with detached
tensors): it builds no graph of its own.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable          # (grads, state, params, lr) -> (new_params, new_state)


def sgd(momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        if momentum == 0.0:
            return ()
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(grads, state, params, lr):
        if weight_decay:
            grads = {k: g + weight_decay * params[k] for k, g in grads.items()}
        if momentum == 0.0:
            return {k: p - lr * grads[k].to(p.dtype)
                    for k, p in params.items()}, ()
        state = {k: momentum * m + grads[k] for k, m in state.items()}
        return {k: p - lr * state[k].to(p.dtype)
                for k, p in params.items()}, state

    return Optimizer(init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.0, state_dtype=None) -> Optimizer:
    def init(params):
        def z(p):
            return torch.zeros(p.shape, dtype=state_dtype or p.dtype,
                               device=p.device)
        dev = next(iter(params.values())).device
        return {"m": {k: z(p) for k, p in params.items()},
                "v": {k: z(p) for k, p in params.items()},
                "t": torch.zeros((), dtype=torch.int32, device=dev)}

    def update(grads, state, params, lr):
        t = state["t"] + 1
        tf = t.to(torch.float32)
        c1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                          device=tf.device), tf)
        c2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                          device=tf.device), tf)
        new_p, new_m, new_v = {}, {}, {}
        for k, p in params.items():
            m, v = state["m"][k], state["v"][k]
            g32 = grads[k].to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
            step = lr * (m32 / c1) / (torch.sqrt(v32 / c2) + eps)
            if weight_decay:
                step = step + lr * weight_decay * p.to(torch.float32)
            new_p[k] = (p.to(torch.float32) - step).to(p.dtype)
            new_m[k] = m32.to(m.dtype)
            new_v[k] = v32.to(v.dtype)
        return new_p, {"m": new_m, "v": new_v, "t": t}

    return Optimizer(init, update)
