"""Class-structured Gaussian surrogates for CIFAR10 / FashionMNIST.

The real datasets are not available offline (DESIGN.md §8); these surrogates
keep exactly what FedGS interacts with — label-skewed federated partitions
with controllable heterogeneity — while remaining learnable by the same small
CNNs.  Each class c has a random template mu_c; samples are mu_c + noise.

A verbatim numpy copy of ``repro.data.vision``: the port keeps its own copy
so it imports nothing of the JAX package, and the same seed gives the same
arrays in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.fed_dataset import FedDataset
from repro_torch.data.partition import (
    dirichlet_label_partition, lognormal_sizes, two_label_partition,
)

NUM_CLASSES = 10


def _class_gaussian(n: int, shape: tuple[int, ...], rng, noise: float = 2.0):
    # noise 2.0 keeps the surrogate task non-trivial (val loss plateaus well
    # above zero) so sampler differences stay visible, matching the paper's
    # loss scale more closely than an easily-separable mixture would.
    templates = rng.normal(0, 1.0, (NUM_CLASSES, *shape)).astype(np.float32)
    y = rng.integers(0, NUM_CLASSES, n).astype(np.int32)
    x = templates[y] + rng.normal(0, noise, (n, *shape)).astype(np.float32)
    return x, y


def make_cifar_like(n_clients: int = 100, n_total: int = 20000,
                    dir_alpha: float = 1.75, seed: int = 0,
                    shape=(8, 8, 3), val_frac: float = 0.1,
                    noise: float = 2.0) -> FedDataset:
    """CIFAR10-style: lognormal sizes + Dir(alpha p*) label skew.

    (surrogate resolution 8x8x3 keeps CPU experiments fast; the partition
    statistics — the thing FedGS sees — match the paper's recipe.)"""
    rng = np.random.default_rng(seed)
    x, y = _class_gaussian(n_total, shape, rng, noise)
    n_val = int(n_total * val_frac)
    xv, yv = x[:n_val], y[:n_val]
    x, y = x[n_val:], y[n_val:]
    sizes = lognormal_sizes(len(y), n_clients, rng)
    parts = dirichlet_label_partition(y, n_clients, dir_alpha, rng, sizes)
    xs = [x[ix] for ix in parts]
    ys = [y[ix] for ix in parts]
    return FedDataset.from_lists(xs, ys, xv, yv, NUM_CLASSES)


def make_fashion_like(n_clients: int = 100, n_total: int = 20000,
                      seed: int = 0, shape=(8, 8, 1),
                      val_frac: float = 0.1) -> FedDataset:
    """FashionMNIST-style: equal sizes, two labels per client."""
    rng = np.random.default_rng(seed)
    x, y = _class_gaussian(n_total, shape, rng)
    n_val = int(n_total * val_frac)
    xv, yv = x[:n_val], y[:n_val]
    x, y = x[n_val:], y[n_val:]
    parts = two_label_partition(y, n_clients, rng)
    xs = [x[ix] for ix in parts]
    ys = [y[ix] for ix in parts]
    return FedDataset.from_lists(xs, ys, xv, yv, NUM_CLASSES)
