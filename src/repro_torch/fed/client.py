"""Client-side local training: E SGD steps on M sampled clients at once,
and the Power-of-Choice loss probe (the port of ``repro.fed.client``).

The M clients are a batch axis written out: every parameter carries a
leading (M,) axis, and autograd on the SUM of the M per-client losses gives
each client exactly its own gradient (client k's loss depends only on its
own slice).  Batch indices come in as an (M, E, B) int64 tensor, and
probe indices as (N, probe_size), so a test can feed the reference's draws.
The trainer's ``cells`` entry trains C cells' M clients in one call (C·M
rows, each cell from its own global params), as the scan engine does.
"""
from __future__ import annotations

import numpy as np
import torch

_BATCH_STREAM = 1          # SeedSequence([seed, t, 1]): the batch-index draws
_PROBE_STREAM = 2          # SeedSequence([seed, t, 2]): the loss-probe draws
PROBE_SIZE = 64            # the reference prober's batch per client


def indices_from_uniform(u: torch.Tensor, sizes: torch.Tensor) -> torch.Tensor:
    """Float64 uniforms u (R, ...) -> int64 indices in [0, max(n_r, 1)) for
    row sizes (R,), on u's device (no host sync): the scan engine's
    default draws, where :func:`default_batch_indices` draws on the CPU."""
    n = torch.clamp_min(sizes.to(torch.float64), 1.0).reshape(
        -1, *([1] * (u.dim() - 1)))
    idx = torch.floor(u * n).to(torch.int64)
    return torch.minimum(idx, n.to(torch.int64) - 1)


def _uniform_indices(seed: int, t: int, stream: int, sizes,
                     shape: tuple) -> torch.Tensor:
    """(len(sizes), *shape) int64 indices, uniform in [0, max(n_k, 1)) per
    client, from a CPU generator seeded by SeedSequence([seed, t, stream]):
    a CPU run and a card run draw the same indices."""
    state = np.random.SeedSequence([seed, t, stream]).generate_state(1)
    gen = torch.Generator().manual_seed(int(state[0]))
    u = torch.rand((len(sizes), *shape), generator=gen, dtype=torch.float64)
    return indices_from_uniform(u, torch.as_tensor(np.asarray(sizes)))


def default_batch_indices(seed: int, t: int, sizes, local_steps: int,
                          batch_size: int) -> torch.Tensor:
    """(M, E, B) int64 batch indices of round t (stream 1)."""
    return _uniform_indices(seed, t, _BATCH_STREAM, sizes,
                            (local_steps, batch_size))


def default_probe_indices(seed: int, t: int, sizes,
                          probe_size: int = PROBE_SIZE) -> torch.Tensor:
    """(N, probe_size) int64 loss-probe indices of round t (stream 2)."""
    return _uniform_indices(seed, t, _PROBE_STREAM, sizes, (probe_size,))


def make_local_trainer(model, *, local_steps: int, batch_size: int,
                       prox_mu: float = 0.0):
    """Returns fn(global_params, x (M, n_max, ...), y (M, n_max), lr, idx
    (M, E, B)) -> dict of stacked local params (M, ...).  ``model`` has
    ``loss(params, x, y) -> (M,)`` over stacked params.

    ``fn.cells(global_params (C, ...), x (C·M, n_max, ...), y, lr, idx
    (C·M, E, B))`` trains C cells at once: rows c·M … c·M + M − 1 start
    from (and, with ``prox_mu``, are pulled toward) cell c's params."""

    def check(idx, m):
        if idx.shape != (m, local_steps, batch_size):
            raise ValueError(f"batch indices {tuple(idx.shape)} are not "
                             f"{(m, local_steps, batch_size)}")

    def train(global_params: dict, x: torch.Tensor, y: torch.Tensor,
              lr: float, idx: torch.Tensor) -> dict:
        m = x.shape[0]
        check(idx, m)
        params = {k: v.unsqueeze(0).expand(m, *v.shape).clone()
                  for k, v in global_params.items()}
        return steps(params, global_params, x, y, lr, idx)

    def train_cells(global_params: dict, x: torch.Tensor, y: torch.Tensor,
                    lr: float, idx: torch.Tensor) -> dict:
        rows = x.shape[0]
        c = next(iter(global_params.values())).shape[0]
        if rows % c:
            raise ValueError(f"{rows} client rows do not split into {c} "
                             f"cells")
        check(idx, rows)
        params = {k: v.repeat_interleave(rows // c, 0)
                  for k, v in global_params.items()}
        anchor = {k: v.clone() for k, v in params.items()} if prox_mu > 0.0 \
            else None
        return steps(params, anchor, x, y, lr, idx)

    def steps(params, anchor, x, y, lr, idx):
        m = x.shape[0]
        rows = torch.arange(m, device=x.device)[:, None]
        for e in range(local_steps):
            xb, yb = x[rows, idx[:, e]], y[rows, idx[:, e]]
            p = {k: v.requires_grad_(True) for k, v in params.items()}
            loss = model.loss(p, xb, yb)
            if prox_mu > 0.0:
                sq = sum(torch.sum(torch.square(p[k] - g).reshape(m, -1), 1)
                         for k, g in anchor.items())
                loss = loss + 0.5 * prox_mu * sq
            grads = torch.autograd.grad(loss.sum(), list(p.values()))
            with torch.no_grad():
                params = {k: p[k] - lr * g for k, g in zip(p, grads)}
        return params

    train.cells = train_cells
    return train


def make_loss_prober(model):
    """Returns fn(params, x (N, n_max, ...), y (N, n_max), idx (N, probe))
    -> (N,) loss of the *global* model on each client's probe batch
    (Power-of-Choice).  The indices come in, as the trainer's do."""

    def probe(params: dict, x: torch.Tensor, y: torch.Tensor,
              idx: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if idx.dim() != 2 or idx.shape[0] != n:
            raise ValueError(f"probe indices {tuple(idx.shape)} are not "
                             f"(N, probe_size) with N = {n}")
        rows = torch.arange(n, device=x.device)[:, None]
        stacked = {k: v.unsqueeze(0).expand(n, *v.shape)
                   for k, v in params.items()}
        with torch.no_grad():
            return model.loss(stacked, x[rows, idx], y[rows, idx])

    return probe
