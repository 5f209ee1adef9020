"""The federated round engine (Algorithm 1) — the port of
``repro.fed.engine.FLEngine`` for the main path.

Per round t:
  1. the availability mode draws A_t            (independent numpy stream)
  2. the sampler picks S_t ⊆ A_t, |S_t| ≤ M     (FedGS solves Eq. 16;
     Power-of-Choice reads every client's probed loss first)
  3. E local SGD steps on the M sampled clients, batched
  4. optional fault injection into the local updates (``fed/faults_device``)
  5. the server update: any aggregator family (``fed/aggregator_device``;
     default Eq. 18 FedAvg)
  6. the count update, and with a dynamic 3DG the participants'
     re-embedding and, every ``graph_refresh_every`` rounds, the rebuild
Evaluation on the shared validation split; the history records loss,
accuracy and count fairness.

``run(ckpt_path=, ckpt_every=, resume=)`` saves the params, the counts,
the round, the server state and the fault state every ``ckpt_every``
rounds on a background writer, from a host copy taken before the next
round (the memory panel and the straggler's stale panel are updated in
place); every round's randomness is keyed by (seed, t), so a resume is
exact.  The dynamic 3DG's embeddings are not saved (as in the reference).

Everything runs on ``device``: CUDA unless the caller asks for the CPU.
On CUDA the 3DG builds (static and dynamic, through the staged kernels),
the FedGS solve and the memory and krum server updates go through the
hand-written kernels.  A round syncs with the host where it must: reading
the sampled set (the availability draw and the counts are host numpy, as
in the reference), Power-of-Choice's losses and the eval numbers.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core import graph as graph_mod
from repro_torch.core.availability import host_draw
from repro_torch.core.fairness import count_variance
from repro_torch.core.graph_device import GraphConfig, build_3dg
from repro_torch.core.sampler import FedGSSampler, Sampler
from repro_torch.data.fed_dataset import FedDataset
from repro_torch.fed.client import (default_batch_indices,
                                    default_probe_indices, make_local_trainer,
                                    make_loss_prober)
from repro_torch.fed.faults_device import HostFaultInjector, make_fault_process
from repro_torch.fed.runtime import (AsyncCheckpointWriter, ProgramCache,
                                     host_snapshot)
from repro_torch.fed.server import ServerAggregator
from repro_torch.fed.telemetry import NULL_TRACER, runtime_snapshot


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
    # dynamic 3DG: rebuild the graph from participants' uploaded models every
    # K rounds (0 = static graph; paper §3.2)
    graph_refresh_every: int = 0


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
                 fault_draws: Optional[Callable] = None,
                 probe_indices: Optional[Callable] = None,
                 tracer=None, sink=None):
        """``aggregator`` is any ``fed.aggregator_device.AggregatorProcess``
        (default FedAvg).  ``fault`` is a ``fed.faults_device.FaultProcess``
        or a family name (built with ``fault_frac`` adversarial clients),
        injected between local training and the server update;
        ``fault_seed`` (default ``cfg.seed + 0xFA17``) seeds its draws.
        ``device`` None means CUDA (and raises without one).
        ``init_params`` (a dict of tensors) replaces the model's own init,
        ``batch_indices(t, sel, sizes) -> (M, E, B)`` the default index
        draws, ``probe_indices(t, sizes) -> (N, probe_size)`` the
        Power-of-Choice loss probe's and ``fault_draws(kind, t, shape)``
        the fault families' standard-normal draws (``HostFaultInjector``):
        the seams that let a run replay the JAX package's random draws.
        A FedGS sampler is handed the engine's device.  ``tracer``
        (``fed/telemetry.Tracer``) records host spans and ``sink``
        (``obs.JSONLMetricsSink``) receives run and eval-round events; both
        default to off."""
        self.ds, self.model, self.sampler, self.mode, self.cfg = \
            ds, model, sampler, mode, cfg
        self.device = resolve_device(device, who="FLEngine")
        self.n = ds.n_clients
        self.m = max(1, int(round(cfg.sample_frac * self.n)))
        self.init_params = init_params
        self.batch_indices = batch_indices
        self.probe_indices = probe_indices
        if isinstance(sampler, FedGSSampler):
            sampler.to(self.device)
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
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.sink = sink
        self._programs = ProgramCache(maxsize=8)
        self._writer_stats: Optional[dict] = None
        self._trainer = self._programs.get(
            "trainer", lambda: make_local_trainer(
                model, local_steps=cfg.local_steps,
                batch_size=cfg.batch_size, prox_mu=cfg.prox_mu))
        self._prober = self._programs.get(
            "prober", lambda: make_loss_prober(model)) \
            if sampler.needs_losses else None
        self._emb = None                  # dynamic 3DG embeddings (N, dim)
        self.counts = np.zeros(self.n)
        # the padded client data and the validation split live on the
        # device from construction on: uploading them is set-up, not a round
        dev = self.device
        self._x = torch.as_tensor(ds.x, dtype=torch.float32, device=dev)
        self._y = torch.as_tensor(ds.y, dtype=torch.int64, device=dev)
        self._xv = torch.as_tensor(ds.x_val, dtype=torch.float32, device=dev)
        self._yv = torch.as_tensor(ds.y_val, dtype=torch.int64, device=dev)

    def runtime_stats(self) -> dict:
        """The shared telemetry snapshot (``ScanEngine.runtime_stats``'s
        shape): the cache counters flat, the last run's checkpoint-writer
        counters and the tracer's per-span aggregates."""
        return runtime_snapshot(programs=self._programs,
                                writer=self._writer_stats,
                                tracer=self.tracer)

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

    # ------------------------------------------------------- dynamic 3DG
    def install_dynamic_graph(self, refresh_every: int = 10,
                              eps: float = 0.1, sigma2: float = 0.01,
                              probe_size: int = 64, *,
                              init_params: Optional[dict] = None,
                              batch_indices=None):
        """Functional-similarity 3DG maintained online (paper §3.2): the
        initial graph comes from one local-training probe round over ALL
        clients from a fresh global model; afterwards the participants
        are re-embedded each round and V -> R -> H is rebuilt every
        ``refresh_every`` rounds, through the staged kernels on CUDA.

        The probe batch is the reference's (numpy, seed + 777).  The probe
        round's init and its (N, E, B) batch indices (by default both
        drawn from seed + 778) are injectable, like the run's."""
        if not isinstance(self.sampler, FedGSSampler):
            return
        cfg, dev = self.cfg, self.device
        cfg.graph_refresh_every = refresh_every
        self._graph_eps, self._graph_sigma2 = eps, sigma2
        rng = np.random.default_rng(cfg.seed + 777)
        xv = np.asarray(self.ds.x_val, np.float64).reshape(
            len(self.ds.x_val), -1)
        mu, cov = xv.mean(0), np.cov(xv.T) + 1e-4 * np.eye(xv.shape[1])
        probe = rng.multivariate_normal(mu, cov, probe_size).astype(np.float32)
        self._probe = torch.as_tensor(
            probe.reshape(probe_size, *self.ds.x_val.shape[1:]), device=dev)

        if init_params is None:
            params = self.model.init(
                torch.Generator().manual_seed(cfg.seed + 778), device=dev)
        else:
            params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                      for k, v in init_params.items()}
        if batch_indices is None:
            batch_indices = default_batch_indices(
                cfg.seed + 778, 0, self.ds.sizes, cfg.local_steps,
                cfg.batch_size)
        stacked = self._trainer(params, self._x, self._y, cfg.lr,
                                torch.as_tensor(batch_indices,
                                                dtype=torch.int64,
                                                device=dev))
        self._emb = graph_mod.probe_embeddings(self.model.embed, stacked,
                                               self._probe)
        self._rebuild_dynamic_graph()

    def _rebuild_dynamic_graph(self):
        cfg = GraphConfig(eps=self._graph_eps, sigma2=self._graph_sigma2,
                          similarity="functional")
        _, _, h = build_3dg(self._emb, cfg)
        self.sampler.set_graph(h)

    def _update_dynamic_embeddings(self, sel_t: torch.Tensor, local: dict):
        self._emb[sel_t] = graph_mod.probe_embeddings(self.model.embed, local,
                                                      self._probe)

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

    def _losses(self, t: int, params: dict):
        """Every client's loss under the global model (Power-of-Choice)."""
        if self.probe_indices is not None:
            idx = self.probe_indices(t, self.ds.sizes)
        else:
            idx = default_probe_indices(self.cfg.seed, t, self.ds.sizes)
        idx = torch.as_tensor(idx, dtype=torch.int64, device=self.device)
        return self._prober(params, self._x, self._y, idx).cpu().numpy()

    def run(self, progress: Callable | None = None, *,
            ckpt_path: str | None = None, ckpt_every: int = 0,
            resume: bool = False) -> History:
        """Run the rounds.  Every round's randomness comes from (seed, t),
        so the process is Markov in (params, counts, server and fault
        state, t): with ``ckpt_path`` and ``ckpt_every`` that state is
        saved every ``ckpt_every`` rounds, and ``resume=True`` continues
        from the file when it exists, bitwise the unbroken run (its
        history holds the rounds run after the resume)."""
        cfg, dev = self.cfg, self.device
        if self.init_params is not None:
            params = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
                      for k, v in self.init_params.items()}
        else:
            params = self.model.init(torch.Generator().manual_seed(cfg.seed),
                                     device=dev)
        # the server and fault state: built from the initial params, then
        # overwritten wholesale by a checkpoint on resume
        self._server.init(params)
        if self._faults is not None:
            self._faults.init(params)
        start_round = 0
        if resume and ckpt_path and os.path.exists(
                ckpt_path if ckpt_path.endswith(".npz")
                else ckpt_path + ".npz"):
            params, start_round = self._resume(ckpt_path, params)
        writer = AsyncCheckpointWriter() \
            if (ckpt_path and ckpt_every) else None
        self._writer_stats = None
        if self.sink is not None:
            self.sink.emit("run_start",
                           {"engine": "host", "rounds": cfg.rounds,
                            "start_round": start_round,
                            "sampler": self.sampler.name})
        try:
            return self._run_rounds(params, start_round, progress,
                                    ckpt_path, ckpt_every, writer)
        finally:
            if writer is not None:
                try:
                    writer.close()
                finally:
                    self._writer_stats = writer.stats()
            if self.sink is not None:
                self.sink.emit("run_end",
                               {"engine": "host",
                                "runtime": self.runtime_stats()})

    def _resume(self, ckpt_path: str, params: dict):
        """(params, first round) from a checkpoint; the server and fault
        state come back too, or restart from params when the file is of
        the older format without them."""
        like = {"params": params, "counts": self.counts,
                "round": np.zeros((), np.int64),
                "server": self._server.state}
        if self._faults is not None:
            like["faults"] = self._faults.state
        try:
            state = load_checkpoint(ckpt_path, like=like)
        except KeyError:          # older checkpoint: no server/fault state
            like.pop("server")
            like.pop("faults", None)
            state = load_checkpoint(ckpt_path, like=like)
        params = state["params"]
        self.counts = np.asarray(state["counts"], np.float64)
        if "server" in state:
            self._server.state = state["server"]
        else:
            self._server.init(params)
        if self._faults is not None:
            if "faults" in state:
                self._faults.state = state["faults"]
            else:
                self._faults.init(params)
        return params, int(state["round"]) + 1

    def _run_rounds(self, params, start_round, progress, ckpt_path,
                    ckpt_every, writer) -> History:
        cfg, dev = self.cfg, self.device
        hist = History()
        chosen = []
        xs, ys, xv, yv = self._x, self._y, self._xv, self._yv

        for t in range(start_round, cfg.rounds):
            rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, t]))
            avail = host_draw(self.mode, t, cfg.avail_seed)
            losses = self._losses(t, params) if self._prober is not None \
                else None
            sel = np.asarray(self.sampler.sample(
                avail=avail, m=self.m, rng=rng, counts=self.counts,
                data_sizes=self.ds.sizes, losses=losses, t=t), dtype=int)
            lr = cfg.lr * (cfg.lr_decay ** t)
            sel_t = torch.as_tensor(sel, dtype=torch.int64, device=dev)
            with self.tracer.span("local_train", t=t, m=len(sel)):
                local = self._trainer(params, xs[sel_t], ys[sel_t], lr,
                                      self._indices(t, sel))
            if self._faults is not None:
                local = self._faults.inject(local, params, sel, avail, t)
            with self.tracer.span("aggregate", t=t):
                params = self._server.apply(
                    local, self.ds.sizes[sel].astype(np.float32), sel,
                    avail, t)
            if self._server.last_chosen is not None:
                chosen.append(self._server.last_chosen)
            self.counts[sel] += 1
            hist.all_sampled.append(sel.tolist())
            if cfg.graph_refresh_every > 0 and self._emb is not None:
                self._update_dynamic_embeddings(sel_t, local)
                if (t + 1) % cfg.graph_refresh_every == 0:
                    self._rebuild_dynamic_graph()

            if t % cfg.eval_every == 0 or t == cfg.rounds - 1:
                with self.tracer.span("eval", t=t), torch.no_grad():
                    vl = float(self.model.loss(params, xv, yv))
                    va = float(self.model.accuracy(params, xv, yv))
                hist.rounds.append(t)
                hist.val_loss.append(vl)
                hist.val_acc.append(va)
                hist.count_var.append(count_variance(self.counts))
                hist.sampled.append(sel.tolist())
                if self.sink is not None:
                    self.sink.emit("round",
                                   {"engine": "host", "t": t,
                                    "val_loss": vl, "val_acc": va,
                                    "count_var": hist.count_var[-1],
                                    "n_selected": int(len(sel)),
                                    "avail_rate": float(np.mean(avail))})
                if progress:
                    progress(t, vl, va)
            if writer is not None and (t + 1) % ckpt_every == 0:
                self._save(writer, ckpt_path, params, t)
        # read krum's choices once, after the rounds: no sync per round
        hist.chosen = [c.tolist() for c in chosen]
        self.params = params
        return hist

    def _save(self, writer, ckpt_path: str, params: dict, t: int):
        """Hand round t's state to the writer thread.  The next round
        updates the memory and stale panels in place, so the tensors are
        copied here, in stream order (``host_snapshot``), and the counts
        (numpy, updated in place too) with them."""
        tree = {"params": params, "server": self._server.state}
        if self._faults is not None:
            tree["faults"] = self._faults.state
        snap = host_snapshot(tree)
        counts = self.counts.copy()

        def _write(snap=snap, counts=counts, tn=t):
            with self.tracer.span("checkpoint_write", round=tn):
                save_checkpoint(
                    ckpt_path, {**snap.wait(), "counts": counts,
                                "round": np.asarray(tn, np.int64)},
                    metadata={"round": tn, "sampler": self.sampler.name,
                              "aggregator": self._server.process.name})
        writer.submit(_write)
