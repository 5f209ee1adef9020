"""Federated dataset container: per-client data padded into stacked arrays so
client-local training runs as one client-batched tensor program.

A verbatim numpy copy of ``repro.data.fed_dataset``: the port keeps its own
copy so it imports nothing of the JAX package, and the same seed gives the
same arrays in both packages."""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class FedDataset:
    """x: (N, n_max, ...) padded features; y: (N, n_max) labels;
    sizes: (N,) true local sizes; plus a shared validation split."""
    x: np.ndarray
    y: np.ndarray
    sizes: np.ndarray
    x_val: np.ndarray
    y_val: np.ndarray
    num_classes: int
    label_dist: np.ndarray = field(default=None)   # (N, C) true label histograms

    @property
    def n_clients(self) -> int:
        return len(self.sizes)

    def label_sets(self) -> list[set[int]]:
        return [set(np.unique(self.y[k][: self.sizes[k]]).tolist())
                for k in range(self.n_clients)]

    @staticmethod
    def from_lists(xs: list[np.ndarray], ys: list[np.ndarray], x_val, y_val,
                   num_classes: int) -> "FedDataset":
        n = len(xs)
        n_max = max(len(x) for x in xs)
        feat_shape = xs[0].shape[1:]
        x = np.zeros((n, n_max, *feat_shape), xs[0].dtype)
        y = np.zeros((n, n_max), np.int32)
        sizes = np.zeros(n, np.int64)
        dist = np.zeros((n, num_classes))
        for k, (xk, yk) in enumerate(zip(xs, ys)):
            m = len(xk)
            x[k, :m] = xk
            y[k, :m] = yk
            sizes[k] = m
            for c in range(num_classes):
                dist[k, c] = float(np.sum(yk == c))
        return FedDataset(x, y, sizes, np.asarray(x_val), np.asarray(y_val),
                          num_classes, dist)
