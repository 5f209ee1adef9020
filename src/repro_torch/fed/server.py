"""Server-side aggregation — the host face over ``fed/aggregator_device.py``
(the ``fedavg`` family of ``repro.fed.server``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed.aggregator_device import fedavg_combine


def aggregate(stacked_params: dict, weights: torch.Tensor,
              prev_params: dict | None = None) -> dict:
    """theta^{t+1} = sum_k w_k theta_k,  w_k = n_k / sum n  (Eq. 18), with
    the zero-weight guard when ``prev_params`` is given."""
    return fedavg_combine(stacked_params, weights, prev_params)


class ServerAggregator:
    """Per-round applier of the server update.  Only Eq. 18 FedAvg (the
    ``fedavg`` family) is ported; its state is the previous global params."""

    def __init__(self, *, n_clients: int):
        self.n = int(n_clients)
        self.state = None

    def init(self, params0: dict) -> dict:
        self.state = {"prev": params0}
        return self.state

    def apply(self, stacked_updates: dict, weights, sel, avail, t: int) -> dict:
        """New global params from the stacked local params and their Eq. 18
        weights (``sel``, ``avail`` and ``t`` are what the other families
        read)."""
        assert self.state is not None, "call init(params0) first"
        prev = self.state["prev"]
        dev = next(iter(prev.values())).device
        w = torch.as_tensor(np.asarray(weights, np.float32), device=dev)
        params = fedavg_combine(stacked_updates, w, prev)
        self.state = {"prev": params}
        return params
