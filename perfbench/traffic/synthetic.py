"""The paper's Synthetic(alpha, beta) federated dataset (FedProx's recipe,
arXiv:1812.06127, as FedGS uses it):

  W_k[i,j] ~ N(mu_k, 1), b_k[i] ~ N(mu_k, 1),  mu_k ~ N(0, alpha)
  v_k[i] ~ N(B_k, 1), B_k ~ N(0, beta),  x_{k,i} ~ N(v_k, Sigma),
  Sigma = diag(i^{-1.2}),  y = argmax softmax(W_k x + b_k)
  n_k ~ lognormal(4, 2) clipped to [min_size, max_size]

A frozen copy of the program's generator, so a later change to the program
cannot move the benchmark's inputs (a test holds the two equal).  Returns
plain numpy arrays; the driver wraps them in the program's container.
"""
from __future__ import annotations

import numpy as np


def make_synthetic(alpha: float = 0.5, beta: float = 0.5, n_clients: int = 30,
                   seed: int = 0, val_frac: float = 0.2, min_size: int = 20,
                   max_size: int = 2000, dim: int = 60,
                   classes: int = 10) -> dict:
    rng = np.random.default_rng(seed)
    sigma = np.diag(np.arange(1, dim + 1, dtype=np.float64) ** (-1.2))
    xs, ys, opt = [], [], []
    sizes = np.clip(rng.lognormal(4.0, 2.0, n_clients).astype(int),
                    min_size, max_size)
    for k in range(n_clients):
        mu_k = rng.normal(0.0, np.sqrt(alpha))
        w_k = rng.normal(mu_k, 1.0, (classes, dim))
        b_k = rng.normal(mu_k, 1.0, classes)
        bb_k = rng.normal(0.0, np.sqrt(beta))
        v_k = rng.normal(bb_k, 1.0, dim)
        x = rng.multivariate_normal(v_k, sigma, int(sizes[k])).astype(
            np.float32)
        y = np.argmax(x @ w_k.T + b_k, axis=1).astype(np.int32)
        xs.append(x)
        ys.append(y)
        opt.append(np.concatenate([w_k.ravel(), b_k]))
    xv, yv = [], []
    for k in range(n_clients):
        m = max(1, int(len(xs[k]) * val_frac))
        xv.append(xs[k][-m:])
        yv.append(ys[k][-m:])
        xs[k], ys[k] = xs[k][:-m], ys[k][:-m]
    n_max = max(len(x) for x in xs)
    x = np.zeros((n_clients, n_max, dim), np.float32)
    y = np.zeros((n_clients, n_max), np.int32)
    local = np.zeros(n_clients, np.int64)
    dist = np.zeros((n_clients, classes))
    for k, (xk, yk) in enumerate(zip(xs, ys)):
        x[k, :len(xk)], y[k, :len(yk)], local[k] = xk, yk, len(xk)
        dist[k] = np.bincount(yk, minlength=classes)
    return {"x": x, "y": y, "sizes": local, "x_val": np.concatenate(xv),
            "y_val": np.concatenate(yv), "classes": classes,
            "label_dist": dist, "opt_params": np.stack(opt),
            "label_sets": [set(np.unique(yk).tolist()) for yk in ys]}
