"""Paper-scale federated models (the port of ``repro.fed.models``):
logistic regression for the Synthetic dataset and the McMahan-style small
CNN for the vision surrogates.

The parameters keep the JAX package's layouts — ``w`` (dim, classes), ``b``
(classes,); the CNN's convolutions HWIO and its activations NHWC — so
weights carry over with ``repro_torch.convert``.  The functional methods
take a params dict whose leaves may carry a leading client axis: params
(M, ...) with ``x`` (M, B, ...) evaluates M models at once.  ``embed`` is
the output-layer activation the functional-similarity 3DG reads (Eq. 12,
l = output layer).
"""
from __future__ import annotations

import numpy as np
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

    def embed(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The output-layer embedding: the logits."""
        return self.logits(params, x)


def logistic_regression(dim: int = 60, classes: int = 10) -> LogisticRegression:
    return LogisticRegression(dim, classes)


def _conv_relu_pool(x: torch.Tensor, w: torch.Tensor, m: int) -> torch.Tensor:
    """One stage on the clients-in-channels layout: x (B, M·C, H, W), w
    (M, 3, 3, C, O) HWIO per client -> pool(relu(conv)) (B, M·O, H/2, W/2).
    The 3x3 stride-1 convolution with padding 1 is JAX's SAME; the 2x2 max
    pool with stride 2 is its VALID window."""
    c, o = w.shape[-2], w.shape[-1]
    wi = w.permute(0, 4, 3, 1, 2).reshape(m * o, c, 3, 3)      # OIHW
    y = F.conv2d(x, wi, padding=1, groups=m)
    return F.max_pool2d(F.relu(y), kernel_size=2, stride=2)


class SmallCNN(nn.Module):
    """Two conv + pool stages and one hidden dense layer — the McMahan CNN
    scaled to the surrogate resolution, as ``repro.fed.models.small_cnn``.

    Params (JAX layout): ``c1`` (3, 3, C, W), ``c2`` (3, 3, W, 2W) HWIO,
    ``d1`` (flat, 64) over the NHWC flatten of the last stage, ``b1`` (64,),
    ``d2`` (64, classes), ``b2`` (classes,).  M clients' models run as one
    grouped convolution (the clients folded into the channel axis, one
    group each): one cuDNN call per layer for all M, and plain autograd
    (no functorch) gives each client its own gradient.  Activations stay in
    that NCHW-grouped layout between the convolutions and are permuted back
    to NHWC before the flatten, so ``d1``'s rows meet JAX's features.

    Constructing the model sets two cuDNN flags for the process:
    ``allow_tf32 = False`` (Hopper's default would round the convolutions'
    inputs to TF32; the reference contract is IEEE float32) and
    ``deterministic = True`` (the default algorithms may sum the weight
    gradient with atomics, so two runs on one card would differ; the
    reference's runs repeat bit for bit, and the CNN's max-pool and ReLU
    turn a one-ulp difference into a visibly different trajectory within
    a few rounds).  Dense layers use ``torch.matmul``, full float32 unless
    a caller turns ``torch.backends.cuda.matmul.allow_tf32`` on."""

    def __init__(self, shape=(8, 8, 3), classes: int = 10, width: int = 16):
        super().__init__()
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        self.shape, self.classes, self.width = tuple(shape), classes, width
        h, w, _ = self.shape
        self.flat = (h // 4) * (w // 4) * (2 * width)

    def init(self, generator: torch.Generator, device="cpu") -> dict:
        """Fresh params with the reference's scales (normal / sqrt(fan-in),
        zero biases), from a torch generator, so not the reference's
        numbers."""
        c, wd = self.shape[2], self.width

        def normal(*shape, fan):
            return (torch.randn(*shape, generator=generator) /
                    float(np.sqrt(fan)))
        p = {"c1": normal(3, 3, c, wd, fan=9 * c),
             "c2": normal(3, 3, wd, 2 * wd, fan=9 * wd),
             "d1": normal(self.flat, 64, fan=self.flat),
             "b1": torch.zeros(64),
             "d2": normal(64, self.classes, fan=64),
             "b2": torch.zeros(self.classes)}
        return {k: v.to(device) for k, v in p.items()}

    def logits(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) with unstacked params, or (M, B, H, W, C) with
        params stacked along a leading client axis."""
        if params["c1"].dim() == 4:
            return self.logits({k: v.unsqueeze(0) for k, v in params.items()},
                               x.unsqueeze(0)).squeeze(0)
        m, b, h, w, c = x.shape
        xi = x.permute(1, 0, 4, 2, 3).reshape(b, m * c, h, w)
        xi = _conv_relu_pool(xi, params["c1"], m)
        xi = _conv_relu_pool(xi, params["c2"], m)
        o, hh, ww = xi.shape[1] // m, xi.shape[2], xi.shape[3]
        flat = xi.reshape(b, m, o, hh, ww).permute(1, 0, 3, 4, 2).reshape(
            m, b, hh * ww * o)                                   # NHWC order
        z = F.relu(torch.matmul(flat, params["d1"]) +
                   params["b1"].unsqueeze(-2))
        return torch.matmul(z, params["d2"]) + params["b2"].unsqueeze(-2)

    def loss(self, params: dict, x: torch.Tensor,
             y: torch.Tensor) -> torch.Tensor:
        """Mean cross-entropy over the batch axis: a scalar, or (M,)."""
        logp = F.log_softmax(self.logits(params, x), dim=-1)
        return -torch.gather(logp, -1, y.unsqueeze(-1)).squeeze(-1).mean(-1)

    def accuracy(self, params: dict, x: torch.Tensor,
                 y: torch.Tensor) -> torch.Tensor:
        pred = torch.argmax(self.logits(params, x), dim=-1)
        return (pred == y).to(torch.float32).mean(-1)

    def embed(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """The output-layer embedding: the logits."""
        return self.logits(params, x)


def small_cnn(shape=(8, 8, 3), classes: int = 10, width: int = 16) -> SmallCNN:
    return SmallCNN(shape, classes, width)
