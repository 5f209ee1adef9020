"""Paper-scale federated models (the part of ``repro.fed.models`` this slice
needs): logistic regression for the Synthetic dataset.

The parameters keep the JAX package's layout — ``w`` (dim, classes), ``b``
(classes,) — so weights carry over with ``repro_torch.convert``.  The
functional methods take a params dict whose leaves may carry a leading
client axis: ``w`` (M, dim, classes) with ``x`` (M, B, dim) evaluates M
models at once.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LogisticRegression(nn.Module):
    """logits = x @ w + b."""

    def __init__(self, dim: int = 60, classes: int = 10):
        super().__init__()
        self.dim, self.classes = dim, classes
        self.w = nn.Parameter(torch.zeros(dim, classes))
        self.b = nn.Parameter(torch.zeros(classes))

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """Fresh params, w ~ N(0, 0.01²) and b = 0 as in the reference (from
        a torch generator, so not the reference's numbers)."""
        w = torch.randn(self.dim, self.classes, generator=generator) * 0.01
        return {"w": w.to(device),
                "b": torch.zeros(self.classes, device=device)}

    @staticmethod
    def logits(params: dict, x: torch.Tensor) -> torch.Tensor:
        return torch.matmul(x, params["w"]) + params["b"].unsqueeze(-2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.logits({"w": self.w, "b": self.b}, x)

    def loss(self, params: dict, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the last batch axis: a scalar, or (M,)
        for M stacked models."""
        logp = F.log_softmax(self.logits(params, x), dim=-1)
        return -torch.gather(logp, -1, y.unsqueeze(-1)).squeeze(-1).mean(-1)

    def accuracy(self, params: dict, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return (pred == y).to(torch.float32).mean(-1)


def logistic_regression(dim: int = 60, classes: int = 10) -> LogisticRegression:
    return LogisticRegression(dim, classes)
