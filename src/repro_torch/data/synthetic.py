"""The paper's Synthetic(alpha, beta) dataset — exact recipe (Appendix C /
Li et al. 2020):

  W_k[i,j] ~ N(mu_k, 1), b_k[i] ~ N(mu_k, 1),  mu_k ~ N(0, alpha)
  v_k[i] ~ N(B_k, 1), B_k ~ N(0, beta),  x_{k,i} ~ N(v_k, Sigma),
  Sigma = diag(i^{-1.2}),  y = argmax softmax(W_k x + b_k)
  n_k ~ lognormal(4, 2)   (30 clients, alpha = beta = 0.5)

A verbatim numpy copy of ``repro.data.synthetic``: the same seed gives the
same arrays in both packages.
"""
from __future__ import annotations

import numpy as np

from repro_torch.data.fed_dataset import FedDataset

DIM = 60
NUM_CLASSES = 10


def make_synthetic(alpha: float = 0.5, beta: float = 0.5, n_clients: int = 30,
                   seed: int = 0, val_frac: float = 0.2,
                   min_size: int = 20, max_size: int = 2000) -> FedDataset:
    rng = np.random.default_rng(seed)
    sigma = np.diag(np.arange(1, DIM + 1, dtype=np.float64) ** (-1.2))

    xs, ys = [], []
    opt_params = []     # the per-client local-optimal (W_k, b_k) — 3DG oracle features
    sizes = np.clip(rng.lognormal(4.0, 2.0, n_clients).astype(int), min_size, max_size)
    for k in range(n_clients):
        mu_k = rng.normal(0.0, np.sqrt(alpha))
        w_k = rng.normal(mu_k, 1.0, (NUM_CLASSES, DIM))
        b_k = rng.normal(mu_k, 1.0, NUM_CLASSES)
        bb_k = rng.normal(0.0, np.sqrt(beta))
        v_k = rng.normal(bb_k, 1.0, DIM)
        n_k = int(sizes[k])
        x = rng.multivariate_normal(v_k, sigma, n_k).astype(np.float32)
        logits = x @ w_k.T + b_k
        y = np.argmax(logits, axis=1).astype(np.int32)
        xs.append(x)
        ys.append(y)
        opt_params.append(np.concatenate([w_k.ravel(), b_k]))

    # shared validation set: held-out slice from every client
    xv, yv = [], []
    for k in range(n_clients):
        m = max(1, int(len(xs[k]) * val_frac))
        xv.append(xs[k][-m:]); yv.append(ys[k][-m:])
        xs[k] = xs[k][:-m]; ys[k] = ys[k][:-m]
    ds = FedDataset.from_lists(xs, ys, np.concatenate(xv), np.concatenate(yv),
                               NUM_CLASSES)
    ds.opt_params = np.stack(opt_params)    # oracle features for the 3DG
    return ds
