"""Server-side aggregation — the host face over ``fed/aggregator_device.py``
(the port of ``repro.fed.server``)."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.fed.aggregator_device import (
    AggregatorProcess, FedAvgProcess, fedavg_combine, init_agg_state,
    make_aggregator_step,
)


def aggregate(stacked_params: dict, weights: torch.Tensor,
              prev_params: dict | None = None) -> dict:
    """theta^{t+1} = sum_k w_k theta_k,  w_k = n_k / sum n  (Eq. 18), with
    the zero-weight guard when ``prev_params`` is given."""
    return fedavg_combine(stacked_params, weights, prev_params)


class ServerAggregator:
    """Per-round applier of an :class:`AggregatorProcess` (default Eq. 18
    FedAvg).  ``init(params0)`` builds the carried state on params0's
    device, with the (N, P) update-memory panel only for the memory family;
    ``apply`` takes the stacked local params, their Eq. 18 weights, the
    selected indices and the round's availability, and returns the new
    global params.  ``seed`` is kept for the reference's signature: no
    family draws random numbers."""

    def __init__(self, process: AggregatorProcess | None = None, *,
                 n_clients: int, data_sizes=None, seed: int = 0):
        self.process = process if process is not None else FedAvgProcess()
        self.n = int(n_clients)
        self.data_sizes = None if data_sizes is None else np.asarray(data_sizes)
        self.seed = seed
        self._steps: dict[int, object] = {}
        self.state = None

    def init(self, params0: dict) -> dict:
        rows = self.n if self.process.family == "memory" else 0
        self.state = init_agg_state(params0, self.n, memory_rows=rows)
        self._steps = {}
        return self.state

    def _step(self, m: int):
        if m not in self._steps:
            self._steps[m] = make_aggregator_step(
                self.n, m, self.state["prev"], family=self.process.family,
                data_sizes=self.data_sizes)
        return self._steps[m]

    @property
    def last_chosen(self):
        """The krum family's (M,) rows averaged last round (in ascending
        ``sel`` order), else None."""
        return None if self.state is None else self.state.get("chosen")

    def apply(self, stacked_updates: dict, weights, sel, avail,
              t: int) -> dict:
        assert self.state is not None, "call init(params0) first"
        dev = next(iter(self.state["prev"].values())).device
        sel = np.asarray(sel, int)
        weights = np.asarray(weights, np.float32)
        if np.any(np.diff(sel) < 0):
            # the gather convention is ascending sel: permute the stacked
            # rows and weights alongside, so update k still lands in client
            # sel[k]'s memory row
            order = np.argsort(sel, kind="stable")
            sel, weights = sel[order], weights[order]
            o = torch.as_tensor(order, device=dev)
            stacked_updates = {k: v[o] for k, v in stacked_updates.items()}
        s = np.zeros(self.n, bool)
        s[sel] = True
        params, self.state = self._step(len(sel))(
            self.process.params(), self.state, None, stacked_updates,
            torch.as_tensor(weights, device=dev),
            torch.as_tensor(s, device=dev),
            torch.as_tensor(np.asarray(avail, bool), device=dev), t,
            torch.as_tensor(sel, dtype=torch.int64, device=dev),
            torch.ones(len(sel), dtype=torch.bool, device=dev))
        return params
