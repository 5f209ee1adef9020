"""The FEDERATED ROUND ITSELF at datacenter client counts, on the card (the
port of ``repro.launch.fedsim``).

The reference lowers and compiles these programs on its production mesh
without running them.  Torch traces no programs, so here each program
RUNS on the card at the reference's shapes, and its record keeps the
reference's keys where they have a torch meaning.  The cohort is the
reference's: the sampled clients padded to the production mesh's dp
width (16 on one pod, 32 on two with ``--multi-pod``; M = 416 at N =
4096 on both), the programs run on one card on either mesh, and the record
and its ``mesh`` tag say which:

  round_step(global_params, xs, ys, sizes, lr, idx)
    -> E local SGD steps on the M sampled clients at once (logistic
       regression, the paper's Synthetic(0.5, 0.5) model)
    -> Eq. 18 weighted aggregation
  graph_pipeline(feats, counts, avail, ...)
    -> the server-side 3DG build (fused adjacency + Floyd–Warshall) and
       the FedGS Eq. 16 solve for N clients (greedy + Q-free swaps)
  aggregator_program(family, N, M)
    -> one server update of any family (memory: the (N, P) panel through
       memagg)
  sweep_program((cells, silo))
    -> the batched sweep engine on the (cells, silo) mesh of
       ``torch.distributed`` ranks

    PYTHONPATH=src python -m repro_torch.launch.fedsim [--clients 4096]
        [--aggregator memory] [--sweep-mesh 2x1] [--device cpu]

Inputs come from a seeded ``torch.Generator``.  Each program runs once
cold under ``torch.utils.flop_counter.FlopCounterMode`` and once measured:
``mem`` is ``torch.cuda.max_memory_allocated`` around the measured call;
``flops`` the kernels' operations (the formulas of PERF.md §6, by their
launches) plus what ``FlopCounterMode`` counts of the rest; ``device_ms``
the measured call between two CUDA events; the roofline terms use one
H100's published peaks.  On the CPU the kernels' plain versions run,
no kernel launches, and no device number is recorded.  Records go to
``build/dryrun/fedsim__*.json`` (gitignored).  The reference's
``--solver-backend`` / ``--agg-backend`` are not offered: the tensors'
device picks kernel or plain version.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch import resolve_device

DIM, CLASSES = 60, 10          # the paper's Synthetic(0.5, 0.5) model
RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
# one H100 SXM's published peaks (NVIDIA data sheet) at its 700 W limit:
# f32 outside the tensor cores, bf16 dense on them, HBM bandwidth (the
# dry-run's roofline reads them here too)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
HBM_BW = 3.35e12


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


# ------------------------------------------------------------ the programs
def round_step_factory(local_steps: int, batch: int):
    """One federated round: local logistic-regression training of the M
    sampled clients at once, then the Eq. 18 aggregate.  ``idx`` (M, E, B)
    holds each client's batch indices (the RNG seam; the reference draws
    them in the program from ``keys``)."""
    from repro_torch.fed.aggregator_device import fedavg_combine
    from repro_torch.fed.client import make_local_trainer
    from repro_torch.fed.models import logistic_regression

    trainer = make_local_trainer(logistic_regression(DIM, CLASSES),
                                 local_steps=local_steps, batch_size=batch)

    def round_step(global_params, xs, ys, sizes, lr, idx):
        locals_ = trainer(global_params, xs, ys, float(np.float32(lr)), idx)
        # the shared Eq. 18 combine (zero-weight guard = params kept)
        return fedavg_combine(locals_, sizes.to(torch.float32),
                              global_params)

    return round_step


def graph_pipeline(feats, counts, avail, alpha, m_sel, max_sweeps: int = 32,
                   *, eps: float = 0.1, sigma2: float = 0.01):
    """The server-side FedGS pipeline: features -> H (the fused adjacency
    and Floyd–Warshall on the card) -> the Eq. 16 solve (``m_sel`` greedy
    steps and ``max_sweeps`` Q-free swap sweeps).  Returns the (N,) bool
    selection."""
    from repro_torch.core.graph_device import GraphConfig, build_h
    from repro_torch.core.sampler_device import fedgs_select
    h = build_h(feats, GraphConfig(eps=eps, sigma2=sigma2))
    return fedgs_select(h, counts, avail, float(alpha), m=m_sel,
                        max_sweeps=max_sweeps)


def pipeline_inputs(n_clients: int, *, device=None, seed: int = 0):
    """The server pipeline's (feats (N, C), counts (N,), avail (N,)) from a
    seeded generator: label-distribution-like features, past
    participation counts, ~80% of clients available."""
    g = _gen(seed)
    feats = torch.rand((n_clients, CLASSES), generator=g)
    feats = feats / feats.sum(1, keepdim=True)
    counts = torch.randint(0, 20, (n_clients,), generator=g).float()
    avail = torch.rand(n_clients, generator=g) < 0.8
    dev = resolve_device(device, who="fedsim")
    return feats.to(dev), counts.to(dev), avail.to(dev)


def round_inputs(m_sel: int, n_max: int, local_steps: int, batch: int, *,
                 device=None, seed: int = 0):
    """The round program's (global params, xs, ys, sizes, lr, idx)."""
    from repro_torch.fed.client import indices_from_uniform
    g = _gen(seed + 1)
    dev = resolve_device(device, who="fedsim")
    gp = {"w": torch.randn((DIM, CLASSES), generator=g) * 0.01,
          "b": torch.zeros(CLASSES)}
    xs = torch.randn((m_sel, n_max, DIM), generator=g)
    ys = torch.randint(0, CLASSES, (m_sel, n_max), generator=g)
    sizes = torch.randint(1, n_max + 1, (m_sel,), generator=g)
    idx = indices_from_uniform(
        torch.rand((m_sel, local_steps, batch), generator=g,
                   dtype=torch.float64), sizes)
    return ({k: v.to(dev) for k, v in gp.items()}, xs.to(dev), ys.to(dev),
            sizes.to(dev), 0.1, idx.to(dev))


def aggregator_program(aggregator: str, n_clients: int, m_sel: int, *,
                       device=None, seed: int = 0):
    """One server update of the named family over the logistic params at
    datacenter client counts (for ``memory``, the (N, P) panel through
    memagg).  Returns ``(apply, args)``: ``apply(state, upd, w, s, avail,
    t)`` and concrete arguments from a seeded generator (the family's own
    state: non-memory families carry a 0-row panel)."""
    from repro_torch.fed.aggregator_device import (init_agg_state,
                                                   make_aggregator_process,
                                                   make_aggregator_step)
    dev = resolve_device(device, who="fedsim")
    g = _gen(seed + 2)
    gp = {"w": (torch.randn((DIM, CLASSES), generator=g) * 0.01).to(dev),
          "b": torch.zeros(CLASSES, device=dev)}
    proc = make_aggregator_process(aggregator)
    step = make_aggregator_step(n_clients, m_sel, gp, family=proc.family)
    aparams = proc.params()

    def apply(state, upd, wts, s, avail, t):
        return step(aparams, state, None, upd, wts, s, avail, t)

    rows = n_clients if proc.family == "memory" else 0
    state = init_agg_state(gp, n_clients, memory_rows=rows)
    upd = {"w": torch.randn((m_sel, DIM, CLASSES), generator=g).to(dev),
           "b": torch.randn((m_sel, CLASSES), generator=g).to(dev)}
    wts = torch.randint(1, 100, (m_sel,), generator=g).float().to(dev)
    pick = torch.randperm(n_clients, generator=g)[:m_sel]
    s = torch.zeros(n_clients, dtype=torch.bool)
    s[pick] = True
    avail = s | (torch.rand(n_clients, generator=g) < 0.5)
    return apply, (state, upd, wts, s.to(dev), avail.to(dev), 3)


def sweep_program(mesh_shape: tuple, *, n_clients: int = 32, rounds: int = 8,
                  aggregator: str = "memory", device=None) -> dict:
    """The batched sweep engine (``fed.scan_engine.run_batch`` under
    ``ScanConfig.mesh``, DESIGN.md §13) at dry-run scale, on the ranks of
    the initialized ``torch.distributed`` world: one cell per cells-rank,
    the silo axis splitting local training (and the memory panel via
    ``silo_reduce="psum"`` when it divides N).  Every rank returns the
    same record: the mesh, the sets' digest and the run's seconds."""
    from repro_torch.core.availability_device import make_process
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine

    shape = tuple(mesh_shape) if len(mesh_shape) == 2 else \
        (mesh_shape[0], 1)
    silo = shape[1]
    ds = make_synthetic(n_clients=n_clients, alpha=0.5, beta=0.5, seed=0)
    cfg = ScanConfig(rounds=rounds, m=4, local_steps=2, batch_size=8,
                     sampler="uniform", aggregator=aggregator, mesh=shape,
                     silo_reduce="psum" if silo > 1 and n_clients % silo == 0
                     else "gather")
    eng = ScanEngine(ds, logistic_regression(dim=ds.x.shape[-1]), cfg,
                     device=device)
    cells = [eng.cell(seed=s, process=make_process(
        "GE", n_clients=n_clients, data_sizes=ds.sizes, rounds=rounds))
        for s in range(shape[0])]
    t0 = time.perf_counter()
    hists = eng.run_batch(cells)
    sets = np.stack([h.sel for h in hists])
    return {"mesh": list(shape), "silo_reduce": cfg.silo_reduce,
            "cells": len(hists), "rounds": rounds,
            "sel_sum": int(sets.sum()), "counts": [h.counts.tolist()
                                                   for h in hists],
            "final_val_loss": [float(h.val_loss[-1]) for h in hists],
            "seconds": time.perf_counter() - t0}


def _sweep_rank(rank, world, mesh_shape, device_type):
    if device_type == "cuda":
        dev = f"cuda:{rank % torch.cuda.device_count()}"
        torch.cuda.set_device(torch.device(dev))
    else:
        dev = "cpu"
    return sweep_program(mesh_shape, device=dev)


def run_sweep_ranks(mesh_shape: tuple, *, device=None,
                    timeout: float = 600.0) -> dict:
    """``sweep_program`` on cells·silo ranks started here (``launch.mesh.
    run_ranks``): NCCL when every rank has a card of its own, else gloo
    (two ranks may share one card).  Returns rank 0's record."""
    from repro_torch.launch.mesh import run_ranks
    dev = resolve_device(device, who="fedsim")
    world = int(np.prod(mesh_shape))
    backend = "nccl" if dev.type == "cuda" and \
        world <= torch.cuda.device_count() else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        recs = run_ranks(_sweep_rank, world, (tuple(mesh_shape), dev.type),
                         init_file=os.path.join(tmp, "init"),
                         backend=backend, timeout=timeout)
    return {**recs[0], "backend": backend, "world": world}


def datacenter_cell_dryrun(n_clients: int = 100_000, mesh: tuple = (1, 8), *,
                           rounds: int = 2, m: int = 32,
                           aggregator: str = "memory",
                           samples_per_client: int = 4, dim: int = 8,
                           classes: int = 4, device=None):
    """The silo axis at datacenter N without running it: ONE N = 10^5 sweep
    cell on a (cells, silo) mesh with the psum-split memory panel.  Torch
    lowers nothing, so the first item is None; the second is the per-rank
    carry's shapes (``ScanEngine.carry_shapes``), whose memory-panel leaf
    must read (N / silo, P) rows — a carry-size regression (the panel
    going whole again) shows as a shape change here.  No process group is
    needed and no carry is allocated."""
    from repro_torch.core.availability_device import make_process
    from repro_torch.data.fed_dataset import FedDataset
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine

    silo = mesh[1] if len(mesh) > 1 else 1
    if n_clients % max(silo, 1):
        raise ValueError(f"N={n_clients} must divide by silo={silo}")
    # a tiny payload per client: the client COUNT is what is under test
    s = samples_per_client
    ds = FedDataset(
        x=np.zeros((n_clients, s, dim), np.float32),
        y=np.zeros((n_clients, s), np.int32),
        sizes=np.full((n_clients,), s, np.int64),
        x_val=np.zeros((8, dim), np.float32),
        y_val=np.zeros((8,), np.int32),
        num_classes=classes,
        label_dist=np.zeros((n_clients, classes)))
    cfg = ScanConfig(rounds=rounds, m=m, local_steps=1, batch_size=2,
                     sampler="uniform", aggregator=aggregator,
                     mesh=tuple(mesh), silo_reduce="psum")
    eng = ScanEngine(ds, logistic_regression(dim=dim, classes=classes), cfg,
                     device=device)
    cells = [eng.cell(
        seed=0, process=make_process("GE", n_clients=n_clients,
                                     data_sizes=ds.sizes, rounds=rounds))
        for _ in range(mesh[0])]
    return None, eng.carry_shapes(cells)


# --------------------------------------------------------------- measuring
# the kernels the programs launch: (operations, bytes) per call, PERF.md
# §6's formulas at the program's shapes
def kernel_work(n: int, m: int, d: int, p: int) -> dict:
    return {
        "fused_adjacency": (n * (n + 1) * d + 5 * n * n, 4 * (n * d + n * n)),
        "floyd_warshall": (2 * n ** 3, 8 * n * n),
        "greedy_argmax": (4 * n, 9 * n),
        "swap_best_fused": (10 * m * n, 8 * m * n + 4 * n + 17 * m),
        "memagg": (2 * n * p, 4 * (m * p + n * p + n + p) + 9 * m),
    }


def _nbytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_nbytes(v) for v in tree)
    return 0


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def measure(fn, dev: torch.device, work: dict) -> tuple[object, dict]:
    """``fn()`` twice: a first call under ``FlopCounterMode`` (the torch
    ops' operations; its wall ms is the cold call's), then the measured
    call, whose output is returned with a record of its device ms (CUDA
    events), wall ms, peak device memory, kernel launches and operations
    (kernel formulas by launch + the first call's torch count)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import ops
    cuda = dev.type == "cuda"
    counter = FlopCounterMode(display=False)
    _sync(dev)
    t0 = time.perf_counter()
    with counter:
        fn()
    _sync(dev)
    first_ms = (time.perf_counter() - t0) * 1e3
    ops.reset_launches()
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    out = fn()
    if cuda:
        stop.record()
        stop.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in ops.launches().items() if v}
    kernel_flops = sum(work[k][0] * v for k, v in launches.items()
                       if k in work)
    kernel_bytes = sum(work[k][1] * v for k, v in launches.items()
                       if k in work)
    rec = {"launches": launches, "wall_ms": wall_ms,
           "first_call_ms": first_ms,
           "torch_flops": int(counter.get_total_flops()),
           "kernel_flops": int(kernel_flops),
           "kernel_bytes": int(kernel_bytes),
           "flops": int(counter.get_total_flops() + kernel_flops)}
    if cuda:
        rec["device_ms"] = start.elapsed_time(stop)
        rec["mem"] = {"peak_bytes": torch.cuda.max_memory_allocated(dev),
                      "peak_over_start_bytes":
                          torch.cuda.max_memory_allocated(dev) - base}
    else:
        rec["device_ms"] = "not measured (CPU)"
        rec["mem"] = "not measured (CPU)"
    return out, rec


def dp_width(*, multi_pod: bool = False) -> int:
    """The production mesh's dp width: 16 on one pod, 32 on two."""
    from repro_torch.launch.mesh import make_production_mesh, make_shard_ctx
    return make_shard_ctx(make_production_mesh(multi_pod=multi_pod)).dp_size


def cohort_size(n_clients: int, sample_frac: float, dp: int) -> int:
    """The sampled cohort, padded to the dp width as the reference pads it
    (production pads the cohort with zero-weight clients):
    ``max(dp, round(frac·N))`` rounded up to a multiple of dp."""
    m_sel = max(dp, int(round(sample_frac * n_clients)))
    return ((m_sel + dp - 1) // dp) * dp


def record_key(n_clients: int, *, multi_pod: bool = False,
               aggregator: str = "fedavg", sweep_mesh=None) -> str:
    key = f"fedsim__c{n_clients}__{'pod2' if multi_pod else 'pod1'}"
    if sweep_mesh:
        key += f"__sweep{'x'.join(str(s) for s in sweep_mesh)}"
    if aggregator != "fedavg":
        key += f"__{aggregator}"
    return key


def run(n_clients: int, *, multi_pod: bool = False, sample_frac: float = 0.1,
        n_max: int = 512, local_steps: int = 10, batch: int = 10,
        max_sweeps: int = 32, force: bool = False,
        aggregator: str = "fedavg", sweep_mesh: tuple | None = None,
        tracer=None, sink=None, device=None, seed: int = 0) -> dict:
    """Run the round, server-pipeline and aggregator programs (and the
    meshed sweep with ``sweep_mesh``) once each and write their record to
    ``build/dryrun/<key>.json``; an existing record is returned unless
    ``force``.  A failure is recorded (``ok`` False, the traceback) and
    the CLI exits 1."""
    from repro_torch.fed.telemetry import NULL_TRACER
    tracer = tracer if tracer is not None else NULL_TRACER
    key = record_key(n_clients, multi_pod=multi_pod, aggregator=aggregator,
                     sweep_mesh=sweep_mesh)
    out_path = RESULTS_DIR / f"{key}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    rec = {"arch": f"fedsim-c{n_clients}", "shape": "fl_round",
           "mesh": "pod2" if multi_pod else "pod1", "variant": "baseline",
           "kind": "fl_round", "ok": False}
    t0 = time.time()
    try:
        dev = resolve_device(device, who="fedsim")
        rec["device"] = torch.cuda.get_device_name(dev) \
            if dev.type == "cuda" else "cpu"
        dp = dp_width(multi_pod=multi_pod)
        m_sel = cohort_size(n_clients, sample_frac, dp)
        rec["dp"] = dp
        p = DIM * CLASSES + CLASSES
        work = kernel_work(n_clients, m_sel, CLASSES, p)

        # ---- the round program: M sampled clients ----------------------
        step = round_step_factory(local_steps, batch)
        args = round_inputs(m_sel, n_max, local_steps, batch, device=dev,
                            seed=seed)
        with tracer.span("run", stage="round"):
            new, r = measure(lambda: step(*args), dev, work)
        r.update({"m_sampled": m_sel, "n_max": n_max,
                  "bytes": _nbytes(args) + _nbytes(new),
                  "collective_bytes": 0,
                  "finite": bool(all(torch.isfinite(v).all()
                                     for v in new.values()))})
        rec["round"] = r

        # ---- the server-side FedGS pipeline (N x N graph + solve) --------
        feats, counts, avail = pipeline_inputs(n_clients, device=dev,
                                               seed=seed)
        with tracer.span("run", stage="server_pipeline"):
            s, g = measure(lambda: graph_pipeline(
                feats, counts, avail, 1.0, m_sel, max_sweeps), dev, work)
        sel = torch.nonzero(s).flatten().cpu().tolist()
        g.update({"n_clients": n_clients, "m_sampled": m_sel,
                  "max_sweeps": max_sweeps, "n_selected": len(sel),
                  "selected": sel})
        rec["server_pipeline"] = g

        # ---- the server-update (aggregator) program ----------------------
        apply, aargs = aggregator_program(aggregator, n_clients, m_sel,
                                          device=dev, seed=seed)
        with tracer.span("run", stage="aggregator"):
            (new_p, _), a = measure(lambda: apply(*aargs), dev, work)
        a.update({"family": aggregator, "n_clients": n_clients,
                  "m_sampled": m_sel, "p": p,
                  "finite": bool(all(torch.isfinite(v).all()
                                     for v in new_p.values()))})
        rec["aggregator"] = a

        # ---- the sweep engine on the (cells, silo) mesh -------------------
        if sweep_mesh:
            import torch.distributed as dist
            with tracer.span("run", stage="sweep_engine"):
                rec["sweep_engine"] = sweep_program(
                    sweep_mesh, device=dev) if dist.is_initialized() else \
                    run_sweep_ranks(sweep_mesh, device=dev)
        # roofline terms of the round program on one H100
        rec["compute_term_s"] = r["flops"] / PEAK_F32_FLOPS
        rec["memory_term_s"] = r["bytes"] / HBM_BW
        rec["collective_term_s"] = 0.0
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"],
                 "collective": rec["collective_term_s"]}
        rec["dominant"] = max(terms, key=terms.get)
        # FedGS takes min(M, |A_t|) clients
        rec["ok"] = r["finite"] and a["finite"] and \
            len(sel) == min(m_sel, int(avail.sum()))
    except Exception as e:              # recorded; the CLI exits 1
        import traceback
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    if sink is not None:
        sink.emit("dryrun", {"key": key, "ok": rec["ok"],
                             "total_s": rec["total_s"],
                             "spans": tracer.summary()})
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    print(f"[fedsim] {key}: "
          f"{'ok' if rec['ok'] else 'FAIL ' + rec.get('error', '')[:120]} "
          f"({rec['total_s']}s)", flush=True)
    return rec


def main(argv=None) -> int:
    from repro_torch.fed.aggregator_device import FAMILIES
    from repro_torch.launch.obs_cli import (add_observability_args,
                                            finish_observability,
                                            make_observability)
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=4096)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--aggregator", default="fedavg", choices=FAMILIES,
                    help="server-update family of the aggregator program "
                         "(fed/aggregator_device.py)")
    ap.add_argument("--sweep-mesh", default=None, metavar="CxS",
                    help="also run the sweep engine on a (cells[, silo]) "
                         "mesh of ranks, e.g. 2 or 2x1 (fed/scan_engine.py,"
                         " DESIGN.md §13)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' for the plain "
                         "versions)")
    ap.add_argument("--seed", type=int, default=0)
    add_observability_args(ap)
    args = ap.parse_args(argv)
    sweep = tuple(int(s) for s in args.sweep_mesh.split("x")) \
        if args.sweep_mesh else None
    tracer, sink = make_observability(args, run=f"fedsim-c{args.clients}")
    try:
        rec = run(args.clients, multi_pod=args.multi_pod, force=args.force,
                  aggregator=args.aggregator, sweep_mesh=sweep,
                  tracer=tracer, sink=sink, device=args.device,
                  seed=args.seed)
    finally:
        trace = finish_observability(tracer, sink, args)
        if trace:
            print(f"trace: {trace}")
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
