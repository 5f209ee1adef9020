"""The federated round engine (Algorithm 1) — the port of
``repro.fed.engine.FLEngine`` for the main path.

Per round t:
  1. the availability mode draws A_t            (independent numpy stream)
  2. the sampler picks S_t ⊆ A_t, |S_t| ≤ M     (FedGS solves Eq. 16)
  3. E local SGD steps on the M sampled clients, batched
  4. optional fault injection into the local updates (``fed/faults_device``)
  5. the server update: any aggregator family (``fed/aggregator_device``;
     default Eq. 18 FedAvg)
  6. the count update
Evaluation on the shared validation split; the history records loss,
accuracy and count fairness.

Everything runs on ``device``: CUDA unless the caller asks for the CPU.
On CUDA the 3DG build, the FedGS solve and the memory and krum server
updates go through the hand-written kernels.  A round syncs with the host
where it must: reading the sampled set (the availability draw and the
counts are host numpy, as in the reference) and the eval numbers.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import graph as graph_mod
from repro_torch.core.availability import host_draw
from repro_torch.core.fairness import count_variance
from repro_torch.core.sampler import FedGSSampler, Sampler
from repro_torch.data.fed_dataset import FedDataset
from repro_torch.fed.client import default_batch_indices, make_local_trainer
from repro_torch.fed.faults_device import HostFaultInjector, make_fault_process
from repro_torch.fed.server import ServerAggregator


@dataclass
class FLConfig:
    rounds: int = 200
    sample_frac: float = 0.1          # M = frac * N (paper: 0.1 / 0.2)
    local_steps: int = 10             # E
    batch_size: int = 10
    lr: float = 0.1
    lr_decay: float = 0.998
    prox_mu: float = 0.0
    eval_every: int = 5
    seed: int = 0
    avail_seed: int = 1234            # independent availability stream


@dataclass
class History:
    rounds: list = field(default_factory=list)
    val_loss: list = field(default_factory=list)
    val_acc: list = field(default_factory=list)
    count_var: list = field(default_factory=list)
    sampled: list = field(default_factory=list)       # at eval rounds
    all_sampled: list = field(default_factory=list)   # every round
    chosen: list = field(default_factory=list)        # krum's rows, every round

    @property
    def best_loss(self) -> float:
        return float(np.min(self.val_loss)) if self.val_loss else float("inf")

    @property
    def final_counts_var(self) -> float:
        return self.count_var[-1] if self.count_var else 0.0


class FLEngine:
    def __init__(self, ds: FedDataset, model, sampler: Sampler, mode,
                 cfg: FLConfig, *, aggregator=None, fault=None,
                 fault_frac: float = 0.0, fault_seed: Optional[int] = None,
                 device=None, init_params: Optional[dict] = None,
                 batch_indices: Optional[Callable] = None,
                 fault_draws: Optional[Callable] = None):
        """``aggregator`` is any ``fed.aggregator_device.AggregatorProcess``
        (default FedAvg).  ``fault`` is a ``fed.faults_device.FaultProcess``
        or a family name (built with ``fault_frac`` adversarial clients),
        injected between local training and the server update;
        ``fault_seed`` (default ``cfg.seed + 0xFA17``) seeds its draws.
        ``device`` None means CUDA (and raises without one).
        ``init_params`` (a dict of tensors) replaces the model's own init,
        ``batch_indices(t, sel, sizes) -> (M, E, B)`` the default index
        draws and ``fault_draws(kind, t, shape)`` the fault families'
        standard-normal draws (``HostFaultInjector``): the seams that let a
        run replay the JAX package's random draws."""
        self.ds, self.model, self.sampler, self.mode, self.cfg = \
            ds, model, sampler, mode, cfg
        self.device = resolve_device(device, who="FLEngine")
        self.n = ds.n_clients
        self.m = max(1, int(round(cfg.sample_frac * self.n)))
        self.init_params = init_params
        self.batch_indices = batch_indices
        self._server = ServerAggregator(aggregator, n_clients=self.n,
                                        data_sizes=ds.sizes, seed=cfg.seed)
        if isinstance(fault, str):
            fault = make_fault_process(fault, self.n, frac=fault_frac)
        if fault is not None and fault.family != "none":
            self._faults = HostFaultInjector(
                fault, fault_seed=cfg.seed + 0xFA17 if fault_seed is None
                else fault_seed, draws=fault_draws)
        else:
            self._faults = None
        self._trainer = make_local_trainer(
            model, local_steps=cfg.local_steps, batch_size=cfg.batch_size,
            prox_mu=cfg.prox_mu)
        self.counts = np.zeros(self.n)
        # the padded client data and the validation split live on the
        # device from construction on: uploading them is set-up, not a round
        dev = self.device
        self._x = torch.as_tensor(ds.x, dtype=torch.float32, device=dev)
        self._y = torch.as_tensor(ds.y, dtype=torch.int64, device=dev)
        self._xv = torch.as_tensor(ds.x_val, dtype=torch.float32, device=dev)
        self._yv = torch.as_tensor(ds.y_val, dtype=torch.int64, device=dev)

    # ------------------------------------------------------------- 3DG setup
    def install_oracle_graph(self, features: Optional[np.ndarray] = None,
                             eps: float = 0.1, sigma2: float = 0.01):
        """Build the oracle 3DG on the engine's device (label-distribution
        features by default, Appendix C) and hand H to a FedGS sampler.
        Returns the adjacency R as numpy."""
        if not isinstance(self.sampler, FedGSSampler):
            return None
        if features is None:
            features = self.ds.label_dist
        _, r, h = graph_mod.build_3dg(np.asarray(features), eps=eps,
                                      sigma2=sigma2, device=self.device)
        self.install_graph_from_H(h)
        return r

    def install_graph_from_H(self, h):
        """Hand a given shortest-path matrix (numpy or tensor) to a FedGS
        sampler, on the engine's device."""
        if isinstance(self.sampler, FedGSSampler):
            if not isinstance(h, torch.Tensor):
                h = torch.from_numpy(np.array(h, dtype=np.float32))
            self.sampler.set_graph(h.to(self.device, torch.float32))

    # ---------------------------------------------------------------- round
    def _indices(self, t: int, sel: np.ndarray) -> torch.Tensor:
        sizes = self.ds.sizes[sel]
        if self.batch_indices is not None:
            idx = self.batch_indices(t, sel, sizes)
        else:
            idx = default_batch_indices(self.cfg.seed, t, sizes,
                                        self.cfg.local_steps,
                                        self.cfg.batch_size)
        return torch.as_tensor(idx, dtype=torch.int64, device=self.device)

    def run(self, progress: Callable | None = None) -> History:
        cfg, dev = self.cfg, self.device
        if self.init_params is not None:
            params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                      for k, v in self.init_params.items()}
        else:
            params = self.model.init(torch.Generator().manual_seed(cfg.seed),
                                     device=dev)
        self._server.init(params)
        if self._faults is not None:
            self._faults.init(params)
        hist = History()
        chosen = []
        xs, ys, xv, yv = self._x, self._y, self._xv, self._yv

        for t in range(cfg.rounds):
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, t]))
            avail = host_draw(self.mode, t, cfg.avail_seed)
            sel = np.asarray(self.sampler.sample(
                avail=avail, m=self.m, rng=rng, counts=self.counts,
                data_sizes=self.ds.sizes, t=t), dtype=int)
            lr = cfg.lr * (cfg.lr_decay ** t)
            sel_t = torch.as_tensor(sel, dtype=torch.int64, device=dev)
            local = self._trainer(params, xs[sel_t], ys[sel_t], lr,
                                  self._indices(t, sel))
            if self._faults is not None:
                local = self._faults.inject(local, params, sel, avail, t)
            params = self._server.apply(
                local, self.ds.sizes[sel].astype(np.float32), sel, avail, t)
            if self._server.last_chosen is not None:
                chosen.append(self._server.last_chosen)
            self.counts[sel] += 1
            hist.all_sampled.append(sel.tolist())

            if t % cfg.eval_every == 0 or t == cfg.rounds - 1:
                with torch.no_grad():
                    vl = float(self.model.loss(params, xv, yv))
                    va = float(self.model.accuracy(params, xv, yv))
                hist.rounds.append(t)
                hist.val_loss.append(vl)
                hist.val_acc.append(va)
                hist.count_var.append(count_variance(self.counts))
                hist.sampled.append(sel.tolist())
                if progress:
                    progress(t, vl, va)
        # read krum's choices once, after the rounds: no sync per round
        hist.chosen = [c.tolist() for c in chosen]
        self.params = params
        return hist
