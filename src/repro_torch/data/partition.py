"""Federated partitioners (paper Appendix C).

A verbatim numpy copy of ``repro.data.partition``: the port keeps its own
copy so it imports nothing of the JAX package, and the same seed gives the
same partitions in both packages."""
from __future__ import annotations

import numpy as np


def lognormal_sizes(n_total: int, n_clients: int, rng) -> np.ndarray:
    """n_k ~ lognormal(log(n/N) - 0.5, 1), rescaled to sum to n_total."""
    mean = np.log(n_total / n_clients) - 0.5
    sizes = rng.lognormal(mean, 1.0, n_clients)
    sizes = np.maximum((sizes / sizes.sum() * n_total).astype(int), 8)
    return sizes


def dirichlet_label_partition(labels: np.ndarray, n_clients: int,
                              alpha: float, rng,
                              sizes: np.ndarray | None = None):
    """Per-client label distribution p_k ~ Dir(alpha * p*), matched to the
    allocated local sizes (paper loops re-drawing until feasible; we greedily
    cap draws by remaining per-class budget, same effect)."""
    classes = np.unique(labels)
    c = len(classes)
    p_star = np.array([(labels == cl).mean() for cl in classes])
    by_class = {cl: list(rng.permutation(np.flatnonzero(labels == cl))) for cl in classes}
    if sizes is None:
        sizes = np.full(n_clients, len(labels) // n_clients)

    client_idx = [[] for _ in range(n_clients)]
    for k in range(n_clients):
        pk = rng.dirichlet(alpha * p_star * c + 1e-9)
        want = rng.multinomial(sizes[k], pk)
        for ci, cl in enumerate(classes):
            take = min(want[ci], len(by_class[cl]))
            for _ in range(take):
                client_idx[k].append(by_class[cl].pop())
        # top up from whatever classes still have items
        while len(client_idx[k]) < sizes[k]:
            nonempty = [cl for cl in classes if by_class[cl]]
            if not nonempty:
                break
            cl = nonempty[int(rng.integers(len(nonempty)))]
            client_idx[k].append(by_class[cl].pop())
    return [np.array(ix, dtype=int) for ix in client_idx]


def two_label_partition(labels: np.ndarray, n_clients: int, rng):
    """McMahan-style pathological split: equal sizes, two labels per client."""
    classes = np.unique(labels)
    n_shards = 2 * n_clients
    # sort by label, split into shards, deal 2 shards per client
    order = np.argsort(labels, kind="stable")
    shards = np.array_split(order, n_shards)
    perm = rng.permutation(n_shards)
    return [np.concatenate([shards[perm[2 * k]], shards[perm[2 * k + 1]]])
            for k in range(n_clients)]
