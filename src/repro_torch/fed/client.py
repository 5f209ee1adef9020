"""Client-side local training: E SGD steps on M sampled clients at once
(the port of ``repro.fed.client.make_local_trainer``).

The M clients are a batch axis written out: every parameter carries a
leading (M,) axis, and autograd on the SUM of the M per-client losses gives
each client exactly its own gradient (client k's loss depends only on its
own slice).  Batch indices come in as an (M, E, B) int64 tensor, so a test
can feed the reference's draws.
"""
from __future__ import annotations

import numpy as np
import torch

_BATCH_STREAM = 1          # SeedSequence([seed, t, 1]): the batch-index draws


def default_batch_indices(seed: int, t: int, sizes, local_steps: int,
                          batch_size: int) -> torch.Tensor:
    """(M, E, B) int64 indices, uniform in [0, max(n_k, 1)) per client,
    drawn from a CPU generator seeded from (seed, t): a CPU run and a card
    run draw the same indices."""
    state = np.random.SeedSequence([seed, t, _BATCH_STREAM]).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    n = torch.clamp_min(torch.as_tensor(np.asarray(sizes), dtype=torch.float64),
                        1.0)
    u = torch.rand((len(n), local_steps, batch_size), generator=gen,
                   dtype=torch.float64)
    idx = torch.floor(u * n[:, None, None]).to(torch.int64)
    return torch.minimum(idx, n.to(torch.int64)[:, None, None] - 1)


def make_local_trainer(model, *, local_steps: int, batch_size: int,
                       prox_mu: float = 0.0):
    """Returns fn(global_params, x (M, n_max, ...), y (M, n_max), lr, idx
    (M, E, B)) -> dict of stacked local params (M, ...).  ``model`` has
    ``loss(params, x, y) -> (M,)`` over stacked params."""

    def train(global_params: dict, x: torch.Tensor, y: torch.Tensor,
              lr: float, idx: torch.Tensor) -> dict:
        m = x.shape[0]
        if idx.shape != (m, local_steps, batch_size):
            raise ValueError(f"batch indices {tuple(idx.shape)} are not "
                             f"{(m, local_steps, batch_size)}")
        rows = torch.arange(m, device=x.device)[:, None]
        params = {k: v.unsqueeze(0).expand(m, *v.shape).clone()
                  for k, v in global_params.items()}
        for e in range(local_steps):
            xb, yb = x[rows, idx[:, e]], y[rows, idx[:, e]]
            p = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = model.loss(p, xb, yb)
            if prox_mu > 0.0:
                sq = sum(torch.sum(torch.square(p[k] - g).reshape(m, -1), 1)
                         for k, g in global_params.items())
                loss = loss + 0.5 * prox_mu * sq
            grads = torch.autograd.grad(loss.sum(), list(p.values()))
            with torch.no_grad():
                params = {k: p[k] - lr * g for k, g in zip(p, grads)}
        return params

    return train
