"""The batched sweep engine (the port of ``repro.fed.scan_engine``): B cells
— (seed, availability, sampler, aggregator, fault) choices — run round by
round side by side, the state of every cell on the device.

One round, in the reference's order:

  availability A_t  (host masks, or each family's device process: one call
                     per family group of cells, ``core/availability_device``)
  -> sampler        (per cell: FedGS's Eq. 16 solve through the greedy and
                     Q-free swap kernels; Gumbel top-m for uniform / MD;
                     Power-of-Choice's d·m candidates, loss probe, top-m)
  -> local training (ONE call for all B·M clients)
  -> fault seam     (per fault cell, on the flat (M, P) update panel)
  -> server update  (FedAvg cells as one group; every other family per
                     cell: memory through memagg, krum through its
                     distance kernel)
  -> counts -> dynamic 3DG (re-embed participants; every K rounds rebuild
                     H through the fused adjacency and Floyd–Warshall)
  -> eval (grouped, on the ``eval_every`` cadence) -> count variance, Gini

The reference compiles this step into one vmapped ``lax.scan``; here the
round loop is a host loop, as ``FLEngine``'s is, and a cell's families are
fixed when the cell is built, so every family switch is a dispatch on the
host (``lax.switch`` has no torch twin).  Grouping runs a family's step
once over the cells that use it where the step takes a leading cell axis;
a family step that does not runs per cell.  The FedGS cells solve
together (``sampler_device.fedgs_select_cells``: one launch a greedy step
and one a sweep for all of them); the other samplers step per cell.
Everything a family does not
need stays unallocated: the (N, P) memory panel exists only for memory
cells, the fault state and the straggler's stale panel only for fault
cells (the reference's ``_flags`` widen the whole batch's carry instead).

The padded static shape is the reference's: the sampler returns a mask s
with |s| = min(M, |A_t|), ``select_k`` gathers the M ascending selected
indices (then pads) and the pads carry zero Eq. 18 weight.

RNG seam.  The reference draws in-scan from threefry keys; torch cannot
replay them, so every draw is a seam a cell may fill (``cell(...)``):
``init_params``, ``batch_indices(t, sel (M,), sizes (M,)) -> (M, E, B)``
(the padded ``sel``), ``avail_draws(kind, t, shape)`` (``availability_
device.round_draws``), ``sampler_draws(kind, t, arg)`` ("gumbel" with
shape (N,); "probe" with the (d,) candidate sizes -> (d, poc_probe)
indices), ``fault_draws(kind, t, shape)`` (as ``FLEngine``'s) and, for the
dynamic 3DG's probe round, ``graph_init_params`` / ``graph_batch_indices``
(N, E, B).  Injected draws are host arrays (reading the padded ``sel``
or the candidates to make them syncs with the device).  The port's own
default draws come from ``torch.Generator``s on the engine's device, one
per (cell, round, stream) seeded from ``SeedSequence`` — ``[seed, t, 1]``
training, ``[sampler_seed, t]`` sampler, ``[avail_seed, t]`` availability,
``[fault_seed, t]`` faults, ``[seed + 778, 0, 1]`` the probe round — so
no round syncs with the host, a segment split replays the same draws, and
a cell draws the same numbers alone or in a batch (but a card and a CPU
run draw different ones).  The trajectory stays on the device until the
end of a segment and is read once there.

Runtime (``fed/runtime.py``).  ``init_carry`` returns a ``CarryHandle``
and ``run_segment`` consumes it: a segment updates the carry in place (the
memory panel through memagg, the straggler's stale panel), so the handle
passed in raises on any later read (``donate_carry=False`` runs the
segment on a clone and leaves it alive).  ``run_batch_stream`` yields
``(t0, k, traj_host)`` per segment, in order: ``async_pipeline=False``
fetches and writes inline; with a checkpoint path the carry's host copy
is taken (pinned, non-blocking, one event) before the next segment and the
npz write runs on a background thread; without one, segment k's
trajectory is fetched while segment k + 1 is dispatched.  A checkpoint
holds the whole carry, the trajectory so far and the next round; every
default draw is keyed by (seed, round, stream), so no generator state is
saved and a resume replays the unbroken run bit for bit.  Telemetry
(``ScanConfig.telemetry``) adds per-round health metrics
(``fed/telemetry.round_telemetry``) that only read the round's values:
the history fields and the checkpoints are those of a run without it.
``ProgramCache`` bounds the per-batch plans (``program_cache_size``).

Mesh scale-out (DESIGN.md §13).  ``ScanConfig.mesh=(cells,)`` or
``(cells, silo)`` runs ``run_batch`` on the ranks of an initialized
``torch.distributed`` world (``launch/mesh.make_engine_mesh``; rank c·silo
+ s): the cells-rank c runs its contiguous block of the batch (padded by
repeating the last cell, the pads dropped on return; with
``cell_sharding=False`` every rank runs every cell), and each silo rank
of a cells-row trains its ceil(M/silo) chunk of every cell's M clients
from the cell's own draws, then all-gathers the updates in slot order, so
every client's update is the one an unmeshed run gives it.  The sampler
runs on every silo rank (each computes the same set).
``silo_reduce="psum"`` also splits each memory panel's rows over silo: a
rank runs memagg on its N/silo rows and the (P,) partials are summed over
the silo group (equal within f32 round-off, not bitwise).  Every rank
gets the whole batch's results; a checkpoint holds the whole gathered
carry, written by rank 0, so a run resumes on the same mesh, another or
none.  ``carry_shapes`` gives a rank's carry's shapes without allocating
it.

Not in this port: ``compile_cache_dir`` and ``lower_batch``, which have no
torch meaning (no traced programs; the kernel libraries persist under
``build/``, keyed by their sources' hash), so they raise away from their
defaults.  The reference's
``graph_backend``, ``solver_backend`` and ``agg_backend`` knobs are left
out: the tensors' device picks kernel or plain version, as everywhere in
the port.

Typical use::

    eng = ScanEngine(ds, model, ScanConfig(rounds=60, m=6), device="cuda")
    h = oracle_h(ds.label_dist, device="cuda")
    cells = [eng.cell(seed=s, mode=mode, alpha=1.0, h=h) for s in (0, 1, 2)]
    hists = eng.run_batch(cells)
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
from repro_torch.core import availability_device as avd
from repro_torch.core.availability import AvailabilityMode, host_trace
from repro_torch.core.fairness import count_variance_device, gini_device
from repro_torch.core.graph import probe_embeddings
from repro_torch.core.graph_device import GraphConfig, build_h, \
    cap_and_normalize
from repro_torch.core.sampler_device import FAMILIES as SAMPLERS
from repro_torch.core.sampler_device import (SamplerProcess, alpha_scales,
                                             fedgs_select_cells, gumbel_noise,
                                             make_sampler_process,
                                             make_sampler_step, select_k)
from repro_torch.data.fed_dataset import FedDataset
from repro_torch.fed.aggregator_device import FAMILIES as AGGREGATORS
from repro_torch.fed.aggregator_device import (AggregatorProcess,
                                               _flat_template, fedavg_cells,
                                               init_agg_state,
                                               make_aggregator_process,
                                               make_aggregator_step)
from repro_torch.fed.client import (indices_from_uniform, make_local_trainer,
                                    make_loss_prober)
from repro_torch.fed.faults_device import FAMILIES as FAULTS
from repro_torch.fed.faults_device import (FaultProcess, device_params,
                                           init_fault_state,
                                           make_fault_process,
                                           make_fault_step)
from repro_torch.fed.runtime import (AsyncCheckpointWriter, CarryHandle,
                                     ProgramCache, clone_tree, host_snapshot)
from repro_torch.fed.telemetry import (NULL_TRACER, fault_corruption_norm,
                                       round_telemetry, runtime_snapshot)
from repro_torch.launch.mesh import make_engine_mesh
from repro_torch.sharding.rules import engine_carry_specs

SILO_REDUCES = ("gather", "psum")
_NO_TORCH_MEANING = ("has no torch meaning: the port traces no programs, "
                     "and its kernel libraries persist under build/, keyed "
                     "by a hash of their sources")


@dataclass(frozen=True)
class ScanConfig:
    """The batched engine's configuration: the reference's field names,
    defaults and validation.  ``compile_cache_dir`` keeps its default in
    this port; a value away from it raises.  ``mesh`` is normalized to
    (cells, silo)."""
    rounds: int = 200
    m: int = 3                     # sampled clients per round (static M)
    local_steps: int = 10          # E
    batch_size: int = 10
    lr: float = 0.1
    lr_decay: float = 0.998
    prox_mu: float = 0.0
    eval_every: int = 1            # eval cadence (NaN on off rounds)
    sampler: str = "fedgs"         # fedgs | uniform | md | poc
    max_sweeps: int = 32           # FedGS local-search budget
    poc_d_factor: int = 2          # Power-of-Choice: d·m candidates
    poc_probe: int = 64            # loss-probe batch per candidate
    graph_refresh_every: int = 0   # dynamic 3DG rebuild period (0 = static)
    graph_eps: float = 0.1
    graph_sigma2: float = 0.01
    aggregator: str = "fedavg"     # per-cell overridable
    fault: str = "none"            # per-cell overridable
    fault_frac: float = 0.0
    probe_size: int = 64
    probe_seed: int = 777
    # mesh scale-out (DESIGN.md §13): (cells,) or (cells, silo) ranks of
    # torch.distributed for run_batch; None = one device (the default)
    mesh: Optional[tuple] = None
    cell_sharding: bool = True     # split the cell batch over "cells"
    silo_reduce: str = "gather"    # gather (bitwise) | psum (panel rows)
    # the runtime layer (fed/runtime.py): consume the carry handle (the
    # segment updates it in place; False: run on a clone), overlap the
    # trajectory's fetch and the checkpoint write with the next segment,
    # bound the plan cache.  compile_cache_dir has no torch meaning
    donate_carry: bool = True
    async_pipeline: bool = True
    compile_cache_dir: Optional[str] = None
    program_cache_size: int = 32
    # per-round health metrics (fed/telemetry.round_telemetry): read-only,
    # the history fields and checkpoints are those of a run without them
    telemetry: bool = False
    telemetry_clip_thresh: float = 10.0   # client-update-norm clip probe

    def __post_init__(self):
        if self.sampler not in SAMPLERS:
            raise ValueError(f"scan engine supports {SAMPLERS}, "
                             f"not {self.sampler!r}")
        if self.aggregator not in AGGREGATORS:
            raise ValueError(f"scan engine supports {AGGREGATORS}, "
                             f"not {self.aggregator!r}")
        if self.silo_reduce not in SILO_REDUCES:
            raise ValueError(f"silo_reduce must be one of {SILO_REDUCES}, "
                             f"not {self.silo_reduce!r}")
        if self.fault not in FAULTS:
            raise ValueError(f"scan engine supports faults {FAULTS}, "
                             f"not {self.fault!r}")
        if not 0.0 <= self.fault_frac <= 1.0:
            raise ValueError(f"fault_frac must be in [0, 1], "
                             f"not {self.fault_frac!r}")
        if self.program_cache_size < 1:
            raise ValueError(f"program_cache_size must be >= 1, "
                             f"not {self.program_cache_size!r}")
        if self.mesh is not None:
            shape = tuple(int(s) for s in self.mesh)
            if len(shape) not in (1, 2) or any(s < 1 for s in shape):
                raise ValueError(f"mesh must be (cells,) or (cells, silo) "
                                 f"with positive sizes, not {self.mesh!r}")
            object.__setattr__(self, "mesh",
                               shape if len(shape) == 2 else shape + (1,))
        if self.compile_cache_dir is not None:
            raise NotImplementedError(f"compile_cache_dir {_NO_TORCH_MEANING}")


# --------------------------------------------------------------- host helpers
def precompute_masks(mode, rounds: int, avail_seed: int = 1234) -> np.ndarray:
    """(rounds, N) bool availability trace, bitwise the stream ``FLEngine``
    draws (both go through ``availability.host_trace``).  ``mode`` is an
    ``AvailabilityMode`` or a ``ProcessMode``."""
    return host_trace(mode, rounds, avail_seed)


def normalized_h(h, *, device=None) -> np.ndarray:
    """Finite-cap + [0, 1]-normalize a shortest-path matrix on ``device``
    (None means CUDA): the stage ``FedGSSampler.set_graph`` runs."""
    dev = resolve_device(device, who="normalized_h")
    return cap_and_normalize(torch.as_tensor(
        np.asarray(h, np.float32), device=dev)).cpu().numpy()


def oracle_h(features, *, eps: float = 0.1, sigma2: float = 0.01,
             device=None) -> np.ndarray:
    """Oracle 3DG -> normalized H, built on ``device`` (None means CUDA)
    through ``graph_device.build_h``: on the card the fused adjacency and
    Floyd–Warshall kernels."""
    dev = resolve_device(device, who="oracle_h")
    u = torch.as_tensor(np.asarray(features, np.float32), device=dev)
    return build_h(u, GraphConfig(eps=eps, sigma2=sigma2,
                                  similarity="dot")).cpu().numpy()


def stack_cells(cells: list[dict]) -> dict:
    """The cells' stackable parts along a new leading cell axis: the
    availability params (tables zero-padded to the common period, so
    families with different periods stack) and states, and the masks."""
    out = {}
    if "proc" in cells[0]:
        out["proc"] = avd.stack_params([c["proc"] for c in cells])
        out["proc_state"] = avd.stack_state([c["proc_state"] for c in cells])
    if "masks" in cells[0]:
        out["masks"] = torch.stack([c["masks"] for c in cells])
    return out


# ------------------------------------------------------------------ histories
@dataclass
class ScanHistory:
    """One cell's trajectory at full-round resolution (eval entries are NaN
    on rounds ``eval_every`` skips)."""
    val_loss: np.ndarray       # (T,)
    val_acc: np.ndarray        # (T,)
    count_var: np.ndarray      # (T,)
    gini: np.ndarray           # (T,)
    sel: np.ndarray            # (T, M) sorted selected indices (padded)
    valid: np.ndarray          # (T, M) pad mask (False = zero-weight slot)
    counts: np.ndarray         # (N,) final participation counts
    chosen: Optional[np.ndarray] = None   # (T, M) krum's averaged slots
    # ScanConfig.telemetry: {name: (T,) or (T, bins)}, None when off; NaN
    # before a resume point (telemetry is not checkpointed)
    telemetry: Optional[dict] = None

    @property
    def best_loss(self) -> float:
        return float(np.nanmin(self.val_loss))

    @property
    def rounds(self) -> np.ndarray:
        """Rounds with recorded eval."""
        return np.flatnonzero(np.isfinite(self.val_loss))

    def sampled(self, t: int) -> np.ndarray:
        """The round-t sampled set (pads stripped)."""
        return self.sel[t][self.valid[t]]


@dataclass
class _Plan:
    """What a batch of cells needs each round, built once per cell list."""
    cells: list
    groups: list = field(default_factory=list)     # (family, cells, params)
    masks: Optional[torch.Tensor] = None           # (B, T, N)
    sampler_steps: list = field(default_factory=list)  # None: a FedGS cell
    fedgs: list = field(default_factory=list)      # FedGS cells, solved together
    fedgs_alphas: list = field(default_factory=list)
    fedgs_index: Optional[torch.Tensor] = None
    fedgs_scales: Optional[torch.Tensor] = None    # (|fedgs|,) alpha/N
    fedavg: list = field(default_factory=list)
    fedavg_index: Optional[torch.Tensor] = None
    agg_steps: dict = field(default_factory=dict)  # cell -> step
    fault_steps: dict = field(default_factory=dict)  # cell -> (step, fp,
    #                                                   flat layout)
    memory: list = field(default_factory=list)     # memory cells
    # the whole batch's families (a meshed rank's block may lack one; the
    # trajectory's krum rows and the telemetry follow the whole batch)
    krum: bool = False
    memory_any: bool = False
    fault_any: bool = False
    whole: list = field(default_factory=list)      # the whole padded batch
    mesh: object = None        # launch.mesh.EngineMesh of a meshed run
    psum: bool = False         # memory panels split into rows over silo


def _family_groups(cells: list[dict]) -> list[tuple[str, list[int]]]:
    """(availability family, the positions of its cells) in first-seen
    order: how a carry stacks the process states."""
    by_family: dict = {}
    for i, c in enumerate(cells):
        if "process" in c:
            by_family.setdefault(c["process"].family, []).append(i)
    return list(by_family.items())


def _host(x, dtype, device) -> torch.Tensor:
    """An array (copied) or a tensor as ``dtype`` on ``device``."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.array(x))
    return x.to(device=device, dtype=dtype)


# ------------------------------------------------------------------- engine
class ScanEngine:
    """Builds cells and runs one cell or a batch of them, every cell's
    state on ``device`` (None means CUDA, and raises without one; pass
    ``device="cpu"`` for the CPU).  ``use_masks`` runs every cell on
    host-precomputed availability masks instead of a device process.
    ``tracer`` (``fed/telemetry.Tracer``) records host spans (inside each
    ``dispatch_segment``, one ``sampler``, ``local_train``, ``aggregate``
    and ``eval`` a batch round, around the whole batch's step) and ``sink``
    (``obs.JSONLMetricsSink``) receives per-round rows as each segment's
    trajectory lands on the host; both default to off."""

    def __init__(self, ds: FedDataset, model, cfg: ScanConfig, *,
                 use_masks: bool = False, device=None, tracer=None,
                 sink=None):
        self.ds, self.model, self.cfg = ds, model, cfg
        self.n = int(ds.n_clients)
        self.use_masks = use_masks
        self.device = dev = resolve_device(device, who="ScanEngine")
        # the client data lives on the device from construction on
        self._x = torch.as_tensor(ds.x, dtype=torch.float32, device=dev)
        self._y = torch.as_tensor(ds.y, dtype=torch.int64, device=dev)
        self._sizes_i = torch.as_tensor(np.asarray(ds.sizes), dtype=torch.int64,
                                        device=dev)
        self._sizes_f = torch.as_tensor(np.asarray(ds.sizes, np.float32),
                                        device=dev)
        self._xv = torch.as_tensor(ds.x_val, dtype=torch.float32, device=dev)
        self._yv = torch.as_tensor(ds.y_val, dtype=torch.int64, device=dev)
        self._trainer = make_local_trainer(
            model, local_steps=cfg.local_steps, batch_size=cfg.batch_size,
            prox_mu=cfg.prox_mu)
        self._prober = make_loss_prober(model)
        self._d_cand = int(min(self.n, max(cfg.m, cfg.poc_d_factor * cfg.m)))
        self._gcfg = GraphConfig(eps=cfg.graph_eps, sigma2=cfg.graph_sigma2,
                                 similarity="functional")
        self._probe = None
        if cfg.graph_refresh_every > 0:
            # the shared Gaussian probe batch (Eq. 12), fixed by probe_seed
            # as in the reference (numpy, so the same numbers)
            rng = np.random.default_rng(cfg.probe_seed)
            flat = np.asarray(ds.x_val, np.float64).reshape(len(ds.x_val), -1)
            mu = flat.mean(0)
            cov = np.cov(flat.T) + 1e-4 * np.eye(flat.shape[1])
            probe = rng.multivariate_normal(mu, cov, cfg.probe_size)
            self._probe = torch.as_tensor(
                probe.reshape(cfg.probe_size, *ds.x_val.shape[1:]),
                dtype=torch.float32, device=dev)
        # per-batch round plans: a bounded LRU (fed/runtime.ProgramCache)
        self._programs = ProgramCache(maxsize=cfg.program_cache_size)
        self._mesh_obj = None         # launch.mesh.EngineMesh, made lazily
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.sink = sink
        self._tel_parts: list = []    # [(t0, k, telemetry_host)] per run
        self._writer_stats: Optional[dict] = None
        self.params = None
        self.final_counts = None

    def runtime_stats(self) -> dict:
        """The shared telemetry snapshot: the plan cache's counters flat at
        the top level (hits, misses, evictions, compiles, compile_ms,
        size), the last run's checkpoint-writer counters and the tracer's
        per-span aggregates."""
        return runtime_snapshot(programs=self._programs,
                                writer=self._writer_stats,
                                tracer=self.tracer)

    def attach_sink(self, sink):
        """Install (or clear, with None) the streaming metrics sink."""
        self.sink = sink

    # ------------------------------------------------------------- cells
    def cell(self, *, seed: int = 0, mode: Optional[AvailabilityMode] = None,
             process: Optional[avd.AvailabilityProcess] = None,
             masks: Optional[np.ndarray] = None, alpha: float = 1.0,
             h=None, avail_seed: int = 1234,
             sampler_seed: Optional[int] = None,
             sampler_process: Optional[SamplerProcess] = None,
             aggregator_process: Optional[AggregatorProcess] = None,
             fault_process: Optional[FaultProcess] = None,
             fault_seed: Optional[int] = None,
             init_params: Optional[dict] = None,
             batch_indices: Optional[Callable] = None,
             avail_draws: Optional[Callable] = None,
             sampler_draws: Optional[Callable] = None,
             fault_draws: Optional[Callable] = None,
             graph_init_params: Optional[dict] = None,
             graph_batch_indices=None) -> dict:
        """One sweep cell.  Availability: ``masks`` (rounds, N) with
        ``use_masks`` (e.g. ``precompute_masks``, bitwise ``FLEngine``'s),
        else ``process`` (any ``AvailabilityProcess``) or ``mode`` (a
        Table-1 mode, as its ``TableProcess``) drawn on the device from
        ``avail_seed``.  The sampler, aggregator and fault default to the
        engine's ``cfg.sampler`` (with this cell's ``alpha``),
        ``cfg.aggregator`` and ``cfg.fault`` / ``cfg.fault_frac``.  A static
        FedGS cell needs a normalized ``h``.  The seams are described in
        the module docstring."""
        cfg, dev, n = self.cfg, self.device, self.n
        if init_params is not None:
            params0 = {k: _host(v, torch.float32, dev)
                       for k, v in init_params.items()}
        else:
            params0 = self.model.init(torch.Generator().manual_seed(seed),
                                      device=dev)
        sseed = seed + 0x5E1EC7 if sampler_seed is None else sampler_seed
        fseed = seed + 0xFA17 if fault_seed is None else fault_seed
        c: dict = {"seed": seed, "params0": params0, "sampler_seed": sseed,
                   "fault_seed": fseed, "batch_indices": batch_indices,
                   "sampler_draws": sampler_draws, "fault_draws": fault_draws}
        if self.use_masks:
            if masks is None or tuple(masks.shape) != (cfg.rounds, n):
                raise ValueError(f"a mask cell needs masks of shape "
                                 f"{(cfg.rounds, n)}")
            c["masks"] = _host(masks, torch.bool, dev)
        else:
            if process is None:
                if mode is None:
                    raise ValueError("device-side availability needs a "
                                     "process or a mode")
                process = mode.process()
            c["process"], c["avail_seed"] = process, avail_seed
            c["avail_draws"] = avail_draws
            c["proc"] = process.params()
            c["proc_state"] = process.init(avd.init_draw(
                process.draw_dist, n, avail_seed, dev, draws=avail_draws),
                device=dev)
        sproc = sampler_process if sampler_process is not None else \
            make_sampler_process(cfg.sampler, alpha=alpha,
                                 d_factor=cfg.poc_d_factor)
        sp = sproc.params(data_sizes=self.ds.sizes)
        c["sampler_process"] = sproc
        c["sampler"] = {**sp, "log_sizes": sp["log_sizes"].to(dev)}
        aproc = aggregator_process if aggregator_process is not None else \
            make_aggregator_process(cfg.aggregator)
        c["aggregator_process"], c["agg"] = aproc, aproc.params()
        fproc = fault_process if fault_process is not None else \
            make_fault_process(cfg.fault, n, frac=cfg.fault_frac)
        c["fault_process"], c["fault"] = fproc, fproc.params()
        if fproc.family != "none":
            eps = None
            if fproc.family == "straggler_stale":
                eps = self._normal(fault_draws, "init", None, (n,), (fseed,))
            c["fault_state"] = fproc.init(eps, device=dev)
        if cfg.graph_refresh_every > 0:
            gp = graph_init_params
            gp = self.model.init(torch.Generator().manual_seed(seed + 778),
                                 device=dev) if gp is None else \
                {k: _host(v, torch.float32, dev) for k, v in gp.items()}
            if graph_batch_indices is None:
                u = torch.rand(
                    (n, cfg.local_steps, cfg.batch_size), dtype=torch.float64,
                    generator=avd.stream_generator((seed + 778, 0, 1), dev),
                    device=dev)
                gidx = indices_from_uniform(u, self._sizes_i)
            else:
                gidx = _host(graph_batch_indices, torch.int64, dev)
            c["graph_init"] = (gp, gidx)
        elif h is not None:
            c["h"] = _host(h, torch.float32, dev)
        elif sproc.family == "fedgs":
            raise ValueError("a static FedGS cell needs a normalized H")
        else:
            c["h"] = None
        return c

    def host_draws(self, seed: int, process=None) -> dict:
        """Seams for ``cell(..., **eng.host_draws(seed, process))`` that
        draw every random number of the cell on the host, from numpy
        ``SeedSequence([seed, stream, t + 1, kind])``: a card run and a CPU
        run of the cell then draw the same numbers.  ``process`` is the
        cell's availability process (its draws' distribution), if any."""
        cfg, n, sizes = self.cfg, self.n, np.asarray(self.ds.sizes)
        dist = None if process is None else process.draw_dist

        def rng(stream, t, kind=0):
            return np.random.default_rng(np.random.SeedSequence(
                [seed, stream, 0 if t is None else t + 1, kind]))

        def sample(g, d, shape):
            return g.random(shape, np.float32) if d == "uniform" else \
                g.standard_normal(shape, np.float32)

        def indices(g, rows, shape):
            u = g.random((len(rows),) + shape)
            hi = np.maximum(np.asarray(rows), 1).reshape(-1, *[1] * len(shape))
            return np.minimum(np.floor(u * hi), hi - 1).astype(np.int64)

        def avail(kind, t, shape):
            g = rng(1, t, ("init", "u", "force", "step").index(kind))
            if kind == "force":
                return g.integers(n)
            return sample(g, "uniform" if kind == "u" else dist, shape)

        def batch(t, sel, sel_sizes):
            return indices(rng(2, t), sel_sizes,
                           (cfg.local_steps, cfg.batch_size))

        def sampler(kind, t, arg):
            if kind == "gumbel":
                u = rng(3, t, 0).random(arg, np.float32)
                return -np.log(-np.log(u))
            return indices(rng(3, t, 1), arg, (cfg.poc_probe,))

        def fault(kind, t, shape):
            return sample(rng(4, t, ("init", "noise", "innovations").index(
                kind)), "normal", shape)

        out = {"avail_draws": avail, "batch_indices": batch,
               "sampler_draws": sampler, "fault_draws": fault}
        if cfg.graph_refresh_every > 0:
            out["graph_batch_indices"] = indices(
                rng(5, None), sizes, (cfg.local_steps, cfg.batch_size))
        return out

    def _normal(self, draws, kind, t, shape, entropy) -> torch.Tensor:
        """A standard-normal draw: ``draws(kind, t, shape)`` or the default
        stream of ``entropy`` on the engine's device."""
        if draws is not None:
            return _host(draws(kind, t, shape), torch.float32, self.device)
        gen = avd.stream_generator(entropy, self.device)
        return torch.randn(shape, generator=gen, device=self.device,
                           dtype=torch.float32)

    # ------------------------------------------------------------ the plan
    def _plan(self, cells: list[dict], whole: Optional[list] = None,
              mesh=None) -> _Plan:
        """The plan of ``cells``; on a mesh, of this rank's block of the
        ``whole`` padded batch."""
        whole = cells if whole is None else whole
        # a plan holds its cells, so their ids stay unique while it lives
        key = (tuple(id(c) for c in cells), tuple(id(c) for c in whole),
               None if mesh is None else mesh.rank)
        return self._programs.get(
            key, lambda: self._build_plan(cells, whole, mesh))

    def _build_plan(self, cells: list[dict], whole: list[dict],
                    mesh=None) -> _Plan:
        cfg, dev, n, m = self.cfg, self.device, self.n, self.cfg.m
        plan = _Plan(cells=list(cells), whole=list(whole), mesh=mesh)
        plan.psum = mesh is not None and mesh.silo > 1 and \
            cfg.silo_reduce == "psum"
        fams = {c["aggregator_process"].family for c in whole}
        plan.krum = "krum" in fams
        plan.memory_any = "memory" in fams
        plan.fault_any = any(c["fault_process"].family != "none"
                             for c in whole)
        if plan.psum and plan.memory_any and n % mesh.silo:
            raise ValueError(f"silo_reduce='psum' row-shards the (N, P) "
                             f"memory panel: N={n} must divide by "
                             f"silo={mesh.silo}")
        if self.use_masks:
            plan.masks = torch.stack([c["masks"] for c in cells])
        else:
            for fam, idx in _family_groups(cells):
                plan.groups.append((fam, idx, avd.stack_params(
                    [cells[i]["proc"] for i in idx], dev)))
        probe = self._probe_losses
        for i, c in enumerate(cells):
            fam = c["sampler_process"].family
            if fam == "fedgs":
                plan.fedgs.append(i)
                plan.fedgs_alphas.append(c["sampler"]["alpha"])
                plan.sampler_steps.append(None)
            else:
                plan.sampler_steps.append(make_sampler_step(
                    n, m, family=fam, max_sweeps=cfg.max_sweeps,
                    d_cand=self._d_cand, probe_losses=probe))
            afam = c["aggregator_process"].family
            if afam == "fedavg":
                plan.fedavg.append(i)
            else:
                plan.agg_steps[i] = make_aggregator_step(
                    n, m, c["params0"], family=afam,
                    data_sizes=self.ds.sizes,
                    panel=mesh if plan.psum and afam == "memory" else None)
                if afam == "memory":
                    plan.memory.append(i)
            ffam = c["fault_process"].family
            if ffam != "none":
                plan.fault_steps[i] = (make_fault_step(ffam),
                                       device_params(c["fault"], dev),
                                       _flat_template(c["params0"]))
        plan.fedavg_index = torch.as_tensor(plan.fedavg, dtype=torch.int64,
                                            device=dev)
        plan.fedgs_index = torch.as_tensor(plan.fedgs, dtype=torch.int64,
                                           device=dev)
        plan.fedgs_scales = alpha_scales(plan.fedgs_alphas, n, dev)
        return plan

    # --------------------------------------------------------------- carry
    def init_carry(self, cells: list[dict]) -> CarryHandle:
        """The state of every cell before round 0, on the device, in a
        ``CarryHandle``: the stacked (B, ...) global params, per-cell
        aggregator and fault state (int-keyed by cell), the (B, N) counts,
        each cell's H and dynamic-3DG embeddings (None where a cell has
        none) and each availability family group's stacked process state.
        ``run_segment`` consumes the handle and advances the carry in
        place.  On a mesh each rank builds its block's carry and every
        rank gets the whole batch's (the memory panels whole too)."""
        plan = self._batch_plan(cells)
        tree = self._init_tree(plan)
        if plan.mesh is not None:
            tree = self._gather_carry(tree, plan, len(cells))
        return CarryHandle(tree)

    def _init_tree(self, plan: _Plan) -> dict:
        """The carry of a plan's cells before round 0 (a rank's block)."""
        cells, n = plan.cells, self.n
        rows_mem = n // plan.mesh.silo if plan.psum else n
        carry = {"params": {k: torch.stack([c["params0"][k] for c in cells])
                            for k in cells[0]["params0"]},
                 "counts": torch.zeros(len(cells), n, dtype=torch.float32,
                                       device=self.device),
                 "agg": {}, "fault": {}, "h": [], "emb": [], "proc": {}}
        for i, c in enumerate(cells):
            if i in plan.agg_steps:
                memory = c["aggregator_process"].family == "memory"
                st = init_agg_state(c["params0"], n,
                                    memory_rows=rows_mem if memory else 0,
                                    tau_rows=n if memory else 0)
                carry["agg"][i] = {k: v for k, v in st.items() if k != "prev"}
            if i in plan.fault_steps:
                stale = c["fault_process"].family == "straggler_stale"
                carry["fault"][i] = init_fault_state(
                    c["fault_state"], c["params0"], n if stale else 0)
            if self._probe is not None:
                # the probe round: every client trains from a fresh model
                # (the paper's everyone-available-at-init assumption)
                gp, gidx = c["graph_init"]
                stacked = self._trainer(gp, self._x, self._y,
                                        float(np.float32(self.cfg.lr)), gidx)
                emb = probe_embeddings(self.model.embed, stacked, self._probe)
                carry["emb"].append(emb)
                carry["h"].append(build_h(emb, self._gcfg))
            else:
                carry["emb"].append(None)
                carry["h"].append(c["h"])
        for fam, idx, _ in plan.groups:
            carry["proc"][fam] = avd.stack_state(
                [cells[i]["proc_state"] for i in idx])
        return carry

    # --------------------------------------------------------------- draws
    def _sampler_draw(self, cell, t):
        """(the round's (N,) Gumbel noise, the cell's sampler generator —
        None with injected draws; the PoC probe draws from it next)."""
        if cell["sampler_draws"] is not None:
            return _host(cell["sampler_draws"]("gumbel", t, (self.n,)),
                         torch.float32, self.device), None
        gen = avd.stream_generator((cell["sampler_seed"], t), self.device)
        return gumbel_noise(gen, (self.n,), self.device), gen

    def _probe_losses(self, inputs, cidx, cvalid):
        """Power-of-Choice's probe: the global model's loss on a
        ``poc_probe`` batch of each candidate's data (the reference's
        in-scan ``probe_losses``)."""
        draws, t = inputs["cell"]["sampler_draws"], inputs["t"]
        sizes = self._sizes_i[cidx]
        if draws is not None:
            idx = _host(draws("probe", t, sizes.cpu().numpy()), torch.int64,
                        self.device)
        else:
            u = torch.rand((cidx.shape[0], self.cfg.poc_probe),
                           generator=inputs["gen"], device=self.device,
                           dtype=torch.float64)
            idx = indices_from_uniform(u, sizes)
        return self._prober(inputs["params"], self._x[cidx], self._y[cidx],
                            idx)

    def _batch_indices(self, cells, t, sel) -> torch.Tensor:
        """(B·M, E, B) training indices for the padded ``sel`` (B, M)."""
        cfg, dev = self.cfg, self.device
        shape = (cfg.m, cfg.local_steps, cfg.batch_size)
        rows, host_sel = [], None
        for i, c in enumerate(cells):
            if c["batch_indices"] is None:
                gen = avd.stream_generator((c["seed"], t, 1), dev)
                rows.append(indices_from_uniform(
                    torch.rand(shape, generator=gen, device=dev,
                               dtype=torch.float64), self._sizes_i[sel[i]]))
            else:
                if host_sel is None:
                    host_sel = sel.cpu().numpy()
                s = host_sel[i]
                rows.append(_host(c["batch_indices"](t, s, self.ds.sizes[s]),
                                  torch.int64, dev))
        return torch.cat(rows)

    # --------------------------------------------------------------- round
    def _round(self, plan: _Plan, carry: dict, t: int) -> dict:
        cfg, dev, n, m = self.cfg, self.device, self.n, self.cfg.m
        cells, b = plan.cells, len(plan.cells)
        params, counts = carry["params"], carry["counts"]

        # 1. availability A_t
        if plan.masks is not None:
            avail = plan.masks[:, t]
        else:
            rows = [None] * b
            for fam, idx, gparams in plan.groups:
                dist = avd.DRAW_DIST[fam]
                draws = avd.stack_draws([avd.round_draws(
                    dist, n, cells[i]["avail_seed"], t, dev,
                    draws=cells[i]["avail_draws"]) for i in idx])
                a, carry["proc"][fam] = avd.proc_draw(
                    gparams, carry["proc"][fam], draws, t)
                for j, i in enumerate(idx):
                    rows[i] = a[j]
            avail = torch.stack(rows)

        # 2. sampler: S_t ⊆ A_t, |S_t| = min(M, |A_t|); the FedGS cells in
        # one batched solve, the others per cell
        with self.tracer.span("sampler"):
            s_rows = [None] * b
            if plan.fedgs:
                g = plan.fedgs
                whole = len(g) == b
                s_f = fedgs_select_cells(
                    [carry["h"][i] for i in g],
                    counts if whole else counts[plan.fedgs_index],
                    avail if whole else avail[plan.fedgs_index],
                    plan.fedgs_alphas, m=m, max_sweeps=cfg.max_sweeps,
                    scales=plan.fedgs_scales)
                for j, i in enumerate(g):
                    s_rows[i] = s_f[j]
            for i, c in enumerate(cells):
                if plan.sampler_steps[i] is None:       # solved above
                    continue
                gumbel, gen = self._sampler_draw(c, t)
                inputs = {"h": carry["h"][i], "counts": counts[i],
                          "params": {k: v[i] for k, v in params.items()},
                          "cell": c, "t": t, "gen": gen}
                s_rows[i], _ = plan.sampler_steps[i](
                    c["sampler"], {}, inputs, avail[i], t, gumbel=gumbel)
            s = s_f if len(plan.fedgs) == b else torch.stack(s_rows)
            sel, valid = select_k(s, m)

        # 3. local training: every cell's M gathered clients in one call
        # (on a silo'd mesh, this rank's chunk of them)
        with self.tracer.span("local_train"):
            lr = float(np.float32(cfg.lr * cfg.lr_decay ** t))
            idx = self._batch_indices(cells, t, sel)
            if plan.mesh is not None and plan.mesh.silo > 1:
                local = self._silo_train(plan.mesh, params, sel, idx, lr)
            else:
                flat = sel.reshape(-1)
                local = self._trainer.cells(params, self._x[flat],
                                            self._y[flat], lr, idx)
            per_cell = [{k: v[i * m:(i + 1) * m] for k, v in local.items()}
                        for i in range(b)]

        # 3b. the fault seam, per fault cell, on the flat (M, P) panel
        fault_mag = {}
        for i, (step, fp, (ravel, unravel, p)) in plan.fault_steps.items():
            c = cells[i]
            fam = c["fault_process"].family
            draws, fseed = c["fault_draws"], c["fault_seed"]
            noise = self._normal(draws, "noise", t, (m, p), (fseed, t)) \
                if fam == "gaussian_noise" else None
            innov = self._normal(draws, "innovations", t, (n,), (fseed, t)) \
                if fam == "straggler_stale" else None
            cleanf = ravel(per_cell[i])
            updf, carry["fault"][i] = step(
                fp, carry["fault"][i], cleanf,
                ravel({k: v[i] for k, v in params.items()}), avail[i], t,
                sel[i], valid[i], noise=noise, innovations=innov)
            per_cell[i] = unravel(updf)
            if cfg.telemetry:
                # measured here, where the clean panel is still in hand
                fault_mag[i] = fault_corruption_norm(updf, cleanf, valid[i])

        # 4. server update: Eq. 18 weights, pads weigh zero
        with self.tracer.span("aggregate"):
            w = self._sizes_f[sel] * valid.to(torch.float32)
            new_rows = [None] * b
            chosen = None
            if plan.fedavg:
                g = plan.fedavg
                whole = len(g) == b
                prev = params if whole else {
                    k: v.index_select(0, plan.fedavg_index)
                    for k, v in params.items()}
                stacked = {k: torch.stack([per_cell[i][k] for i in g])
                           for k in params}
                new = fedavg_cells(stacked,
                                   w if whole else w[plan.fedavg_index], prev)
                for j, i in enumerate(g):
                    new_rows[i] = {k: v[j] for k, v in new.items()}
            for i, step in plan.agg_steps.items():
                c = cells[i]
                state = {**carry["agg"][i],
                         "prev": {k: v[i] for k, v in params.items()}}
                new_rows[i], state = step(c["agg"], state, None, per_cell[i],
                                          w[i], s[i], avail[i], t, sel[i],
                                          valid[i])
                if "chosen" in state:
                    if chosen is None:
                        chosen = [torch.zeros(m, dtype=torch.bool,
                                              device=dev) for _ in range(b)]
                    chosen[i] = state.pop("chosen")
                carry["agg"][i] = {k: v for k, v in state.items()
                                   if k != "prev"}
            params_prev = params
            if plan.fedavg and len(plan.fedavg) == b:
                params = new
            else:
                params = {k: torch.stack([r[k] for r in new_rows])
                          for k in params}
            carry["params"] = params

        # 5. counts v^{t+1}
        counts = counts + s.to(torch.float32)
        carry["counts"] = counts

        # dynamic 3DG: re-embed the participants; rebuild H every K rounds
        if self._probe is not None:
            every = {k: torch.cat([r[k] for r in per_cell]) for k in params}
            e_all = probe_embeddings(self.model.embed, every, self._probe)
            rebuild = (t + 1) % cfg.graph_refresh_every == 0
            for i in range(b):
                emb, si = carry["emb"][i], sel[i]
                e_i = torch.where(valid[i][:, None], e_all[i * m:(i + 1) * m],
                                  emb[si])
                emb = emb.index_put((si,), e_i)
                carry["emb"][i] = emb
                if rebuild:
                    carry["h"][i] = build_h(emb, self._gcfg)

        # 6. eval on the eval_every cadence (always on the last round)
        with self.tracer.span("eval"):
            out = {"count_var": count_variance_device(counts),
                   "gini": gini_device(counts), "sel": sel, "valid": valid}
            if cfg.eval_every == 1 or t % cfg.eval_every == 0 \
                    or t == cfg.rounds - 1:
                xv = self._xv.expand(b, *self._xv.shape)
                yv = self._yv.expand(b, *self._yv.shape)
                with torch.no_grad():
                    out["val_loss"] = self.model.loss(params, xv, yv)
                    out["val_acc"] = self.model.accuracy(params, xv, yv)
        if plan.krum:
            out["chosen"] = torch.stack(chosen) if chosen is not None else \
                torch.zeros(b, m, dtype=torch.bool, device=dev)
        if cfg.telemetry:
            out["telemetry"] = self._telemetry(
                plan, carry, t, avail, sel, valid, per_cell, params_prev,
                params, w, fault_mag)
        return out

    def _silo_train(self, mesh, params, sel, idx, lr) -> dict:
        """Local training on a silo'd mesh: the M slots of every cell, padded
        with the last one to ceil(M/silo)·silo, cut into silo chunks; this
        rank trains its chunk of each cell from the cell's own (M, E, B)
        draw, then the chunks are all-gathered in slot order (the
        reference's ``all_gather(..., tiled=True)[:m]``).  Each client's
        update is the one the unsplit call gives it."""
        b, m = sel.shape
        silo = mesh.silo
        chunk = -(-m // silo)
        pad = chunk * silo - m
        idx = idx.reshape(b, m, *idx.shape[1:])
        if pad:
            sel = torch.cat([sel, sel[:, -1:].expand(b, pad)], 1)
            idx = torch.cat([idx, idx[:, -1:].expand(b, pad,
                                                     *idx.shape[2:])], 1)
        i0 = mesh.silo_rank * chunk
        sel_l = sel[:, i0:i0 + chunk].reshape(-1)
        idx_l = idx[:, i0:i0 + chunk].reshape(b * chunk, *idx.shape[2:])
        part = self._trainer.cells(params, self._x[sel_l], self._y[sel_l],
                                   lr, idx_l.contiguous())
        ravel, unravel, p = _flat_template({k: v[0] for k, v in
                                            params.items()})
        full = mesh.all_gather_silo(ravel(part))       # (silo·b·chunk, P)
        full = full.reshape(silo, b, chunk, p).transpose(0, 1)
        return unravel(full.reshape(b, silo * chunk, p)[:, :m]
                       .reshape(b * m, p))

    def _telemetry(self, plan, carry, t, avail, sel, valid, per_cell,
                   params_prev, params, w, fault_mag) -> dict:
        """The round's (B, ...) health metrics, as the reference's per-cell
        channel gives them to a batch: a cell without H reads dispersion
        0, a batch with a memory cell has the staleness histogram (tau 0
        for its other cells) and one with a fault cell the corruption
        magnitude (0 for its benign cells)."""
        b, n, dev = len(plan.cells), self.n, self.device
        zero_h = torch.zeros(n, n, dtype=torch.float32, device=dev) \
            if any(h is None for h in carry["h"]) else None
        hs = torch.stack([zero_h if h is None else h for h in carry["h"]])
        tau = None
        if plan.memory_any:
            zeros = torch.zeros(n, dtype=torch.float32, device=dev)
            tau = torch.stack([carry["agg"][i]["tau"] if i in plan.memory
                               else zeros for i in range(b)])
        mag = None
        if plan.fault_any:
            zero = torch.zeros((), dtype=torch.float32, device=dev)
            mag = torch.stack([fault_mag.get(i, zero) for i in range(b)])
        local = {k: torch.stack([r[k] for r in per_cell]) for k in params}
        return round_telemetry(
            avail=avail, valid=valid, sel=sel, local=local,
            params_prev=params_prev, params_new=params, weights=w,
            h=hs, clip_thresh=self.cfg.telemetry_clip_thresh,
            tau=tau, t=t, fault_mag=mag)

    def run_segment(self, cells: list[dict], carry: CarryHandle, t0: int,
                    seg_len: int):
        """Rounds ``t0 … t0 + seg_len − 1`` from the carry handle.  With
        ``cfg.donate_carry`` the handle is CONSUMED (the segment advances
        its carry in place, and a later read of it raises); without, the
        segment runs on a clone and the handle stays alive.  Returns
        ``(new_handle, traj)``: ``traj`` holds (B, seg_len, ...) device
        tensors, nothing read back to the host.  Every per-round draw is
        keyed by the round index alone, so a ``(k) + (T − k)`` split
        replays the uninterrupted run bit for bit.  On a mesh the handle
        holds the whole batch's carry (``init_carry``'s); each rank runs
        its block, and every rank gets the whole new carry and
        trajectory."""
        with self.tracer.span("program_get", seg_len=seg_len):
            plan = self._batch_plan(cells)
        if plan.mesh is None:
            return self._segment(plan, carry, t0, seg_len)
        tree = carry.consume() if self.cfg.donate_carry \
            else clone_tree(carry.tree)
        local = CarryHandle(self._local_carry(tree, plan, len(cells)))
        local, traj = self._segment(plan, local, t0, seg_len)
        traj = self._gather_traj(_numpy_tree(host_snapshot(traj).wait()),
                                 plan, len(cells))
        return (CarryHandle(self._gather_carry(local.tree, plan, len(cells))),
                _device_tree(traj, self.device))

    def _segment(self, plan: _Plan, carry: CarryHandle, t0: int,
                 seg_len: int):
        """``run_segment`` on a plan's own cells (a rank's block)."""
        with self.tracer.span("dispatch_segment", t0=t0, rounds=seg_len):
            tree = carry.consume() if self.cfg.donate_carry \
                else clone_tree(carry.tree)
            b = len(plan.cells)
            nan = torch.full((b,), float("nan"), device=self.device)
            rounds = [self._round(plan, tree, t)
                      for t in range(t0, t0 + seg_len)]
            traj = {}
            for k in ("val_loss", "val_acc", "count_var", "gini", "sel",
                      "valid", "chosen"):
                if k in rounds[0] or k in ("val_loss", "val_acc"):
                    traj[k] = torch.stack([r.get(k, nan) for r in rounds], 1)
            if "telemetry" in rounds[0]:
                traj["telemetry"] = {
                    k: torch.stack([r["telemetry"][k] for r in rounds], 1)
                    for k in rounds[0]["telemetry"]}
        return CarryHandle(tree), traj

    # ----------------------------------------------------- host plumbing
    def _fetch_segment(self, t0: int, k: int, snap, b: int,
                       plan: _Plan) -> dict:
        """A segment's trajectory on the host (``snap`` from
        ``host_snapshot``, started when the segment was dispatched), as
        numpy with ``sel`` int32, the whole batch's on a mesh.  The
        telemetry subtree is split off — kept for the histories and
        streamed to the sink — so what flows into checkpoints and stream
        consumers is the telemetry-off trajectory."""
        with self.tracer.span("device_get", t0=t0, rounds=k):
            traj_h = _numpy_tree(snap.wait())
            if plan.mesh is not None:
                traj_h = self._gather_traj(traj_h, plan, b)
        traj_h["sel"] = traj_h["sel"].astype(np.int32)
        tel_h = traj_h.pop("telemetry", None)
        if tel_h is not None:
            self._tel_parts.append((t0, k, tel_h))
        self._emit_segment_metrics(b, t0, k, traj_h, tel_h)
        return traj_h

    def _emit_segment_metrics(self, b: int, t0: int, k: int, traj_h: dict,
                              tel_h: Optional[dict]):
        """One fetched segment's per-round rows to the metrics sink, as the
        segment lands on the host."""
        if self.sink is None:
            return
        with self.tracer.span("metrics_emit", t0=t0, rounds=k):
            for j in range(b):
                for r in range(k):
                    row = {"cell": j, "t": t0 + r,
                           "n_valid": int(np.sum(traj_h["valid"][j][r]))}
                    for f in ("val_loss", "val_acc", "count_var", "gini"):
                        row[f] = float(traj_h[f][j][r])
                    if tel_h is not None:
                        row["metrics"] = {
                            kk: np.asarray(v[j][r])
                            for kk, v in tel_h.items()}
                    self.sink.emit("round", row)
            self.sink.emit("segment",
                           {"t0": t0, "rounds": k, "cells": b,
                            "programs": self._programs.stats()})

    def _assemble_telemetry(self) -> Optional[dict]:
        """The stashed per-segment telemetry as (B, T, ...) arrays; a
        resumed run's prefix (telemetry is not checkpointed) is NaN, so
        round indices stay aligned."""
        if not self._tel_parts:
            return None
        parts, t_next = [], 0
        for t0, k, tel in self._tel_parts:
            if t0 > t_next:
                gap = t0 - t_next
                parts.append({kk: np.full(x.shape[:1] + (gap,) + x.shape[2:],
                                          np.nan, x.dtype)
                              for kk, x in tel.items()})
            parts.append(tel)
            t_next = t0 + k
        return {kk: np.concatenate([p[kk] for p in parts], axis=1)
                for kk in parts[0]}

    @staticmethod
    def _ckpt_carry(tree: dict) -> dict:
        """The carry as a checkpoint tree: a cell without H or embeddings
        (None) is an empty dict, which the flat npz format keeps."""
        return {**tree, "h": [{} if v is None else v for v in tree["h"]],
                "emb": [{} if v is None else v for v in tree["emb"]]}

    def _carry_from_ckpt(self, node: dict, b: int) -> dict:
        """A loaded checkpoint carry back on the engine's device, leaves
        with their saved dtypes, int cell keys and None restored."""
        dev = self.device

        def leaf(x):
            return torch.as_tensor(x).to(dev)

        def tree(x):
            return {k: tree(v) for k, v in x.items()} \
                if isinstance(x, dict) else leaf(x)

        def cells_list(x):
            vals = [x[str(i)] for i in range(b)]
            return [None if isinstance(v, dict) else leaf(v) for v in vals]

        return {"params": tree(node["params"]), "counts": leaf(node["counts"]),
                "agg": {int(i): tree(v) for i, v in node["agg"].items()},
                "fault": {int(i): tree(v) for i, v in node["fault"].items()},
                "h": cells_list(node["h"]), "emb": cells_list(node["emb"]),
                "proc": tree(node["proc"])}

    # ----------------------------------------------------------------- mesh
    def _mesh(self):
        """This rank's ``EngineMesh`` (made at the first meshed run, as the
        reference makes its mesh), or None without ``cfg.mesh``."""
        if self.cfg.mesh is None:
            return None
        if self._mesh_obj is None:
            self._mesh_obj = make_engine_mesh(self.cfg.mesh)
        return self._mesh_obj

    def _pad_cells(self, cells: list[dict], mesh) -> list[dict]:
        """Pad an uneven batch to a multiple of the "cells" axis by
        repeating the last cell (pad trajectories are dropped on return)."""
        if mesh is None or not self.cfg.cell_sharding:
            return list(cells)
        r = len(cells) % mesh.cells
        return list(cells) + [cells[-1]] * ((mesh.cells - r) % mesh.cells)

    def _block(self, n_padded: int, mesh) -> range:
        """The positions of the padded batch that this rank runs: its
        cells-row's contiguous block, or all with ``cell_sharding=False``."""
        if not self.cfg.cell_sharding:
            return range(n_padded)
        per = n_padded // mesh.cells
        return range(mesh.cell_rank * per, (mesh.cell_rank + 1) * per)

    def _batch_plan(self, cells: list[dict], mesh=False) -> _Plan:
        """The plan of a batch: of all of it, or on a mesh (``cfg.mesh``
        unless ``mesh`` is given), of this rank's block of it padded."""
        mesh = self._mesh() if mesh is False else mesh
        if mesh is None:
            return self._plan(cells)
        whole = self._pad_cells(cells, mesh)
        block = self._block(len(whole), mesh)
        return self._plan([whole[i] for i in block], whole, mesh)

    def _carry_specs(self, tree: dict, plan: _Plan) -> dict:
        return engine_carry_specs(tree, cell_sharding=self.cfg.cell_sharding,
                                  panel_sharded=plan.psum)

    @staticmethod
    def _pieces(tree: dict, groups, b: int) -> list[dict]:
        """A carry cut into its cells' own parts (views), in cell order."""
        where = {i: (fam, j) for fam, idx in groups
                 for j, i in enumerate(idx)}
        out = []
        for i in range(b):
            piece = {"params": {k: v[i] for k, v in tree["params"].items()},
                     "counts": tree["counts"][i], "agg": tree["agg"].get(i),
                     "fault": tree["fault"].get(i), "h": tree["h"][i],
                     "emb": tree["emb"][i], "proc": None}
            if i in where:
                fam, j = where[i]
                piece["proc"] = {k: v[j] for k, v in
                                 tree["proc"][fam].items()}
            out.append(piece)
        return out

    @staticmethod
    def _join(pieces: list[dict], groups) -> dict:
        """Cells' own parts (tensors, or numpy) back into one carry (the
        inverse of :meth:`_pieces`)."""
        return {"params": {k: _stack([p["params"][k] for p in pieces])
                           for k in pieces[0]["params"]},
                "counts": _stack([p["counts"] for p in pieces]),
                "agg": {i: p["agg"] for i, p in enumerate(pieces)
                        if p["agg"] is not None},
                "fault": {i: p["fault"] for i, p in enumerate(pieces)
                          if p["fault"] is not None},
                "h": [p["h"] for p in pieces],
                "emb": [p["emb"] for p in pieces],
                "proc": {fam: {k: _stack([pieces[i]["proc"][k]
                                          for i in idx])
                               for k in pieces[idx[0]]["proc"]}
                         for fam, idx in groups}}

    def _gather_carry(self, tree: dict, plan: _Plan, b: int, *,
                      on_device: bool = True) -> dict:
        """The whole batch's carry from every rank's block (collective:
        every rank calls it): the memory panels' rows all-gathered over
        silo under ``psum`` (``sharding.rules``), the blocks over the
        world, pads dropped — the layout of the unmeshed run's carry.  On
        the device, or as numpy (``on_device=False``)."""
        mesh = plan.mesh
        groups = [(fam, idx) for fam, idx, _ in plan.groups]
        pieces = self._pieces(tree, groups, len(plan.cells))
        specs = self._carry_specs(pieces, plan)
        for piece, spec in zip(pieces, specs):
            # the memory panels' rows (same cells, so the same calls, on
            # every silo rank of a cells-row)
            if spec["agg"] is not None and "silo" in spec["agg"]["mem"] \
                    and piece["agg"]["mem"].shape[0]:
                piece["agg"] = {**piece["agg"], "mem": mesh.all_gather_silo(
                    piece["agg"]["mem"])}
        every = mesh.gather_objects(_host_tree(pieces))
        rows = [every[c * mesh.silo] for c in range(mesh.cells)] \
            if self.cfg.cell_sharding else [every[0]]
        whole = [p for r in rows for p in r][:b]
        if on_device:
            whole = _device_tree(whole, self.device)
        return self._join(whole, _family_groups(plan.whole[:b]))

    def _local_carry(self, tree: dict, plan: _Plan, b: int) -> dict:
        """This rank's block of a whole batch's carry (the inverse of
        :meth:`_gather_carry`): pads take copies of the last cell's state,
        and under ``psum`` a memory panel keeps this silo rank's rows."""
        pieces = self._pieces(tree, _family_groups(plan.whole[:b]), b)
        pieces += [clone_tree(pieces[-1]) for _ in range(len(plan.whole) - b)]
        block = self._block(len(plan.whole), plan.mesh)
        mine = [pieces[i] for i in block]
        rows = self.n // plan.mesh.silo
        off = plan.mesh.silo_rank * rows
        for piece, spec in zip(mine, self._carry_specs(mine, plan)):
            if spec["agg"] is not None and "silo" in spec["agg"]["mem"] \
                    and piece["agg"]["mem"].shape[0]:
                piece["agg"] = {**piece["agg"], "mem": piece["agg"]["mem"][
                    off:off + rows].clone()}
        return self._join(mine, [(fam, idx) for fam, idx, _ in plan.groups])

    def _gather_traj(self, traj_h: dict, plan: _Plan, b: int) -> dict:
        """The whole batch's host trajectory from every rank's block, pads
        dropped (collective)."""
        mesh = plan.mesh
        every = mesh.gather_objects(traj_h)
        rows = [every[c * mesh.silo] for c in range(mesh.cells)] \
            if self.cfg.cell_sharding else [every[0]]

        def cat(parts):
            if isinstance(parts[0], dict):
                return {k: cat([p[k] for p in parts]) for k in parts[0]}
            return np.concatenate(parts, axis=0)[:b]
        return cat(rows)

    # ----------------------------------------------------------------- runs
    def run(self, cell: dict) -> ScanHistory:
        """One cell (the batch path with a batch of one, on this rank
        alone: the mesh applies to ``run_batch``)."""
        parts = [traj for _, _, traj in self._stream([cell], mesh=None)]
        hist = self._histories([cell], _concat(parts),
                               self._assemble_telemetry())[0]
        self.params = {k: v[0] for k, v in self.params.items()}
        return hist

    def run_batch_stream(self, cells: list[dict], *,
                         ckpt_path: Optional[str] = None,
                         ckpt_every: int = 0, resume: bool = False):
        """Generator over the segmented run: yields ``(t_start, seg_len,
        traj_host)`` per segment IN ORDER, ``traj_host`` a dict of (B,
        seg_len, ...) numpy arrays (``sel`` int32).  With ``ckpt_path``
        the whole carry, the trajectory so far and the next round are saved
        after every segment but the last; ``resume=True`` starts from that
        file when it exists (first yielding ``(0, t, traj_so_far)``), else
        from round 0.

        ``cfg.async_pipeline=False``: each segment is fetched, and
        checkpointed, inline.  Otherwise, with a checkpoint path, the
        carry's host copy is started (pinned, non-blocking, in stream
        order) before the next segment updates it in place, and the npz
        write runs on a background ``AsyncCheckpointWriter``; without one,
        segment k's trajectory is fetched after segment k + 1 is
        dispatched.  The rounds run are the same either way, so the
        results are bitwise equal.  Afterwards ``self.params`` (on the
        device) and ``self.final_counts`` (numpy) hold the final state.

        On a mesh (``cfg.mesh``) each rank runs its block of the padded
        batch, every rank yields the whole batch's trajectory, and
        checkpoints are written inline: the whole gathered carry (the
        memory panels whole), by rank 0 while the others wait at a barrier.
        So a run resumes on the same mesh, on another one, or on none."""
        return self._stream(cells, mesh=self._mesh(), ckpt_path=ckpt_path,
                            ckpt_every=ckpt_every, resume=resume)

    def _stream(self, cells: list[dict], *, mesh,
                ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                resume: bool = False):
        cfg, b, rounds = self.cfg, len(cells), self.cfg.rounds
        every = int(ckpt_every) if ckpt_every else rounds
        self._tel_parts = []
        self._writer_stats = None
        if self.sink is not None:
            self.sink.emit("run_start",
                           {"cells": b, "rounds": rounds, "mesh": cfg.mesh,
                            "telemetry": bool(cfg.telemetry),
                            "ckpt_every": int(ckpt_every)})
        plan = self._batch_plan(cells, mesh)
        t0, parts, handle = 0, [], None
        if resume and ckpt_path is not None and os.path.exists(
                ckpt_path if ckpt_path.endswith(".npz")
                else ckpt_path + ".npz"):
            with self.tracer.span("checkpoint_load"):
                state = load_checkpoint(ckpt_path)
                t0 = int(state["round"])
                tree = self._carry_from_ckpt(state["carry"], b)
                if mesh is not None:
                    tree = self._local_carry(tree, plan, b)
                handle = CarryHandle(tree)
            parts.append(state["traj"])
            yield 0, t0, state["traj"]
        if handle is None:
            with self.tracer.span("init_carry", cells=b):
                handle = CarryHandle(self._init_tree(plan))
        # a meshed run's checkpoints gather the carry: inline, on every rank
        inline = not cfg.async_pipeline or (mesh is not None and
                                            ckpt_path is not None)
        writer = AsyncCheckpointWriter() \
            if (ckpt_path is not None and not inline) else None
        pending = None                      # (t_start, seg_len, snapshot)

        def meta_of(t_next):
            return {"round": t_next, "rounds": rounds, "b": b,
                    "cells": b, "mesh": cfg.mesh}

        def ckpt_tree(carry_h, sn, t_next):
            return {"carry": carry_h, "round": np.int64(t_next),
                    "traj": _concat(sn)}

        def whole_carry():
            if mesh is None:
                return handle.tree
            return self._gather_carry(handle.tree, plan, b, on_device=False)
        try:
            while t0 < rounds:
                k = min(every, rounds - t0)
                if mesh is None and self.cfg.mesh is None:
                    handle, traj_dev = self.run_segment(cells, handle, t0, k)
                else:
                    with self.tracer.span("program_get", seg_len=k):
                        plan = self._batch_plan(cells, mesh)
                    handle, traj_dev = self._segment(plan, handle, t0, k)
                # the trajectory's copy is queued right behind the segment
                snap = host_snapshot(traj_dev)
                t1 = t0 + k
                need_ckpt = ckpt_path is not None and t1 < rounds
                if inline:
                    traj_h = self._fetch_segment(t0, k, snap, b, plan)
                    parts.append(traj_h)
                    if need_ckpt:
                        carry_w = self._ckpt_carry(whole_carry())
                        if mesh is None or mesh.rank == 0:
                            with self.tracer.span("checkpoint_write",
                                                  round=t1):
                                save_checkpoint(
                                    ckpt_path,
                                    ckpt_tree(carry_w, parts, t1),
                                    metadata=meta_of(t1))
                        if mesh is not None:
                            mesh.barrier()
                    yield t0, k, traj_h
                elif need_ckpt:
                    if pending is not None:
                        ph = self._fetch_segment(*pending, b, plan)
                        parts.append(ph)
                        yield pending[0], pending[1], ph
                        pending = None
                    # the carry's copy, queued before the next segment
                    # overwrites it in place; the writer waits for it
                    carry_snap = host_snapshot(self._ckpt_carry(handle.tree))
                    traj_h = self._fetch_segment(t0, k, snap, b, plan)
                    parts.append(traj_h)
                    snapshot = list(parts)

                    def _write(cs=carry_snap, sn=snapshot, tn=t1):
                        with self.tracer.span("checkpoint_write", round=tn):
                            save_checkpoint(ckpt_path,
                                            ckpt_tree(cs.wait(), sn, tn),
                                            metadata=meta_of(tn))
                    writer.submit(_write)
                    yield t0, k, traj_h
                else:
                    # free-running: fetch the PREVIOUS segment now that
                    # this one is dispatched
                    if pending is not None:
                        ph = self._fetch_segment(*pending, b, plan)
                        parts.append(ph)
                        yield pending[0], pending[1], ph
                    pending = (t0, k, snap)
                t0 = t1
            if pending is not None:
                ph = self._fetch_segment(*pending, b, plan)
                parts.append(ph)
                yield pending[0], pending[1], ph
            final = handle.tree if mesh is None else \
                self._gather_carry(handle.tree, plan, b)
            self.params = final["params"]
            self.final_counts = final["counts"].cpu().numpy()
        finally:
            if writer is not None:
                try:
                    writer.close()
                finally:
                    self._writer_stats = writer.stats()
            if self.sink is not None:
                self.sink.emit("run_end", {"runtime": self.runtime_stats()})

    def run_batch(self, cells: list[dict], *,
                  ckpt_path: Optional[str] = None, ckpt_every: int = 0,
                  resume: bool = False) -> list[ScanHistory]:
        """B cells, round by round side by side, through
        ``run_batch_stream``.  ``ckpt_every`` runs the rounds in segments
        of that length (the same results, with or without a checkpoint
        path); ``ckpt_path`` saves after each segment but the last and
        ``resume=True`` picks up from it if it exists (else starts fresh):
        the tail replays the unbroken run bit for bit."""
        parts = [traj for _, _, traj in self.run_batch_stream(
            cells, ckpt_path=ckpt_path, ckpt_every=ckpt_every,
            resume=resume)]
        return self._histories(cells, _concat(parts),
                              self._assemble_telemetry())

    def _histories(self, cells: list[dict], traj: dict,
                  telemetry: Optional[dict] = None) -> list[ScanHistory]:
        """Per-cell ``ScanHistory`` from a whole (B, T, ...) host
        trajectory and the last run's final counts."""
        out = []
        for i, c in enumerate(cells):
            krum = c["aggregator_process"].family == "krum"
            out.append(ScanHistory(
                val_loss=traj["val_loss"][i], val_acc=traj["val_acc"][i],
                count_var=traj["count_var"][i], gini=traj["gini"][i],
                sel=traj["sel"][i].astype(np.int32), valid=traj["valid"][i],
                counts=self.final_counts[i],
                chosen=traj["chosen"][i] if krum else None,
                telemetry=None if telemetry is None else
                {k: v[i] for k, v in telemetry.items()}))
        return out

    # -------------------------------------------------- not in this port
    def lower_batch(self, *a, **kw):
        raise NotImplementedError(f"lower_batch {_NO_TORCH_MEANING}")

    # ------------------------------------------------------------ dry run
    def carry_shapes(self, cells: list[dict]) -> dict:
        """The per-rank carry's leaves as ``LeafShape`` (shape, dtype), in
        :meth:`init_carry`'s layout (None where a cell has no H or
        embeddings), derived from the configuration and the cells alone:
        no carry is allocated and no process group is needed (only
        ``cfg.mesh`` is read).  On a mesh it is the first cells-row's block
        of the padded batch; under ``psum`` a memory panel holds N/silo
        rows — the dry run's pin on the carry's footprint."""
        cfg, n = self.cfg, self.n
        ncells, silo = cfg.mesh if cfg.mesh is not None else (1, 1)
        whole = list(cells)
        if cfg.mesh is not None and cfg.cell_sharding:
            whole += [cells[-1]] * ((ncells - len(cells) % ncells) % ncells)
            whole = whole[:len(whole) // ncells]
        psum = silo > 1 and cfg.silo_reduce == "psum"
        memory = [c["aggregator_process"].family == "memory" for c in cells]
        if psum and any(memory) and n % silo:
            raise ValueError(f"silo_reduce='psum' row-shards the (N, P) "
                             f"memory panel: N={n} must divide by "
                             f"silo={silo}")
        f32, b = torch.float32, len(whole)

        def like(x, lead=()):
            return LeafShape(tuple(lead) + tuple(x.shape), x.dtype)
        p0 = whole[0]["params0"]
        p = sum(v.numel() for v in p0.values())
        out = {"params": {k: like(v, (b,)) for k, v in p0.items()},
               "counts": LeafShape((b, n), f32), "agg": {}, "fault": {},
               "h": [], "emb": [], "proc": {}}
        if self._probe is not None:
            meta = {k: torch.empty((1,) + tuple(v.shape), dtype=v.dtype,
                                   device="meta") for k, v in p0.items()}
            x = torch.empty((1, 1) + tuple(self.ds.x_val.shape[1:]),
                            device="meta")
            emb_dim = self.model.embed(meta, x).shape[-1]
        for i, c in enumerate(whole):
            afam = c["aggregator_process"].family
            if afam != "fedavg":
                rows = (n // silo if psum else n) if afam == "memory" else 0
                zeros = {k: like(v) for k, v in c["params0"].items()}
                out["agg"][i] = {
                    "m1": zeros, "m2": dict(zeros),
                    "mem": LeafShape((rows, p), f32),
                    "tau": LeafShape((n if afam == "memory" else 0,), f32)}
            ffam = c["fault_process"].family
            if ffam != "none":
                out["fault"][i] = {
                    **{k: like(v) for k, v in c["fault_state"].items()},
                    "stale": LeafShape(
                        (n if ffam == "straggler_stale" else 0, p), f32)}
            if self._probe is not None:
                out["h"].append(LeafShape((n, n), f32))
                out["emb"].append(LeafShape((n, emb_dim), f32))
            else:
                out["h"].append(None if c["h"] is None else like(c["h"]))
                out["emb"].append(None)
        for fam, idx in _family_groups(whole):
            out["proc"][fam] = {k: like(v, (len(idx),)) for k, v in
                                whole[idx[0]]["proc_state"].items()}
        return out


@dataclass(frozen=True)
class LeafShape:
    """A carry leaf's shape and dtype (``ScanEngine.carry_shapes``)."""
    shape: tuple
    dtype: torch.dtype


def _numpy_tree(x):
    """A host tree's tensors as numpy arrays."""
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return {k: _numpy_tree(v) for k, v in x.items()}


def _host_tree(x):
    """A tree (dicts, lists, None) with every tensor copied to numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _host_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_host_tree(v) for v in x]
    return x


def _device_tree(x, device):
    """A tree (dicts, lists, None) with every numpy array on ``device``."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x).to(device)
    if isinstance(x, dict):
        return {k: _device_tree(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_device_tree(v, device) for v in x]
    return x


def _stack(xs: list):
    return np.stack(xs) if isinstance(xs[0], np.ndarray) else torch.stack(xs)


def _concat(parts: list[dict]) -> dict:
    """Per-segment (B, k, ...) trajectories joined along the round axis."""
    return {k: np.concatenate([p[k] for p in parts], axis=1)
            for k in parts[0]}
