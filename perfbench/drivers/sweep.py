"""Driver of the FedGS sweep cells: the program's batched sweep engine
(``repro_torch.fed.scan_engine.ScanEngine``) runs a batch of cells (the
mix's availability modes × seeds) segment by segment, closed loop, and
the plain reference under ``perfbench/reference/fedsweep.py`` replays
every round afterwards.

Set-up: the Synthetic data, every cell's masks, initial weights and seeds
from ``--seed``; the engine; H through the program's 3DG build (FedGS
cells); one warm-up segment, which builds and loads the kernels.  The
window: segments of ``segment_rounds`` rounds, each read back to the host
(the closed loop a sweep's driver runs), until ``--seconds`` have passed;
the rate is whole rounds over the whole window.  ``--trace 1`` records the
engine's spans over the window and then profiles ``trace_rounds`` more
rounds.  Afterwards the reference runs every round the program ran, from
the same inputs, and the two are compared (``readings``): H, every cell's
set in every round and the counts, free-running from round 0; the
val_loss of every round and the weights at each segment's end, the
reference's weights restarted at the segment's start from the program's
(the recipe's SGD amplifies a rounding difference from round to round),
with the segment's first round apart, and the rest as a percentile over
the (cell, segment) pairs; and the val_loss the program
reported for each segment's last round against the reference's val_loss
of the weights the program carried out of it.
"""
from __future__ import annotations

import sys
import time

import numpy as np
import torch

import harness
from reference import fedsweep as ref
from roofline import PEAK_F32_OPS_PER_S
from traffic import availability
from traffic.synthetic import make_synthetic


def _seeds(seed: int, k: int) -> list[np.random.Generator]:
    return [np.random.default_rng(s)
            for s in np.random.SeedSequence(seed).spawn(k)]


def make_inputs(cfg: dict, tr: dict, seed: int) -> tuple[dict, list[dict]]:
    """The dataset and the cells' inputs, all from ``seed``."""
    g_data, g_mask, g_w, g_cell = _seeds(seed, 4)
    dc = cfg["dataset"]
    data = make_synthetic(dc["alpha"], dc["beta"], n_clients=tr["n_clients"],
                          seed=int(g_data.integers(2 ** 31)),
                          val_frac=dc["val_frac"], min_size=dc["min_size"],
                          max_size=dc["max_size"], dim=dc["dim"],
                          classes=dc["classes"])
    mode_seed = int(g_mask.integers(2 ** 31))
    cells = []
    for mode in tr["modes"]:
        table = availability.probs_table(
            mode, sizes=data["sizes"], label_sets=data["label_sets"],
            num_labels=dc["classes"], seed=mode_seed,
            period=tr["mode_period"])
        for _ in range(tr["seeds_per_mode"]):
            cells.append({
                "mode": mode,
                "masks": availability.draw_masks(table, tr["max_rounds"],
                                                 g_mask),
                "w0": (0.01 * g_w.standard_normal(
                    (dc["dim"], dc["classes"]))).astype(np.float32),
                "b0": np.zeros(dc["classes"], np.float32),
                "seed": int(g_cell.integers(2 ** 31)),
                "sampler_seed": int(g_cell.integers(2 ** 31))})
    return data, cells


def round_flops(cfg: dict, tr: dict, n_val: int, cells: int) -> float:
    """The operations a batch round needs: each sampled client's E steps of
    B samples (logits and weight gradient, 2 d C each), the eval's logits
    for loss and accuracy, and the FedGS solve's greedy (4 N a step) and
    swaps (10 m N a sweep) by the kernels' formulas."""
    dc = cfg["dataset"]
    dcx = dc["dim"] * dc["classes"]
    m, n = tr["m"], tr["n_clients"]
    train = m * cfg["local_steps"] * cfg["batch_size"] * 4 * dcx
    evals = 2 * 2 * n_val * dcx
    solve = m * 4 * n + cfg["max_sweeps"] * 10 * m * n \
        if tr["sampler"] == "fedgs" else 0
    return float(cells * (train + evals + solve))


def run(*, spec: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    from repro_torch.data.fed_dataset import FedDataset
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine, oracle_h
    from repro_torch.fed.telemetry import NULL_TRACER, Tracer
    from repro_torch.kernels import ops

    cfg, tr, lim = spec["config"], spec["traffic"], spec["limits"]
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    if cuda:
        torch.cuda.set_device(device)
    data, cells = make_inputs(cfg, tr, seed)
    ds = FedDataset(data["x"], data["y"], data["sizes"], data["x_val"],
                    data["y_val"], data["classes"], data["label_dist"])
    m, seg = tr["m"], tr["segment_rounds"]
    eng = ScanEngine(ds, logistic_regression(cfg["dataset"]["dim"],
                                             cfg["dataset"]["classes"]),
                     ScanConfig(rounds=tr["max_rounds"], m=m,
                                local_steps=cfg["local_steps"],
                                batch_size=cfg["batch_size"], lr=cfg["lr"],
                                lr_decay=cfg["lr_decay"],
                                eval_every=cfg["eval_every"],
                                sampler=tr["sampler"],
                                max_sweeps=cfg["max_sweeps"],
                                aggregator=cfg["aggregator"],
                                fault=cfg["fault"]),
                     use_masks=True, device=device)
    g = cfg["graph"]
    h = oracle_h(data["opt_params"], eps=g["eps"], sigma2=g["sigma2"],
                 device=device) if tr["sampler"] == "fedgs" else None
    ecells = [eng.cell(seed=c["seed"], masks=c["masks"], alpha=cfg["alpha"],
                       h=h, sampler_seed=c["sampler_seed"],
                       init_params={"w": c["w0"], "b": c["b0"]})
              for c in cells]
    b = len(ecells)
    trajs, ends = [], {}

    def segment(handle, t0, k):
        handle, traj = eng.run_segment(ecells, handle, t0, k)
        trajs.append({key: v.cpu().numpy() for key, v in traj.items()})
        p = handle.tree["params"]
        ends[t0 + k] = (p["w"].cpu().numpy(), p["b"].cpu().numpy())
        return handle

    handle = eng.init_carry(ecells)
    t = tr["warmup_rounds"]
    handle = segment(handle, 0, t)                    # warm-up
    sync()
    t_w0 = time.perf_counter()
    setup_s = t_w0 - t_start

    tracer = Tracer() if trace else NULL_TRACER
    eng.tracer = tracer
    ops.reset_launches()
    marks = [t_w0]
    while True:
        if t + seg > tr["max_rounds"]:
            raise harness.BenchError(f"max_rounds {tr['max_rounds']} ran out "
                                     f"before the window closed")
        handle = segment(handle, t, seg)
        t += seg
        marks.append(time.perf_counter())
        if marks[-1] - t_w0 >= seconds:
            break
    window_s = marks[-1] - t_w0
    # each segment's seconds, to tell noise within a run from noise between
    print("segment_s " + " ".join(f"{b - a:.4f}" for a, b in
                                  zip(marks, marks[1:])), file=sys.stderr)
    rounds_w = t - tr["warmup_rounds"]
    launches = ops.launches()
    spans = tracer.events()

    layer_ctx, brk = None, None
    if trace:
        k = tr["trace_rounds"]
        acts = [torch.profiler.ProfilerActivity.CPU] + \
            ([torch.profiler.ProfilerActivity.CUDA] if cuda else [])
        with torch.profiler.profile(activities=acts) as prof:
            sync()
            handle = segment(handle, t, k)
            sync()
        t += k
        tr_ev = harness.parse_profile(prof)
        # the traced window, on the profiler's clock: its host events
        a0 = min(s for _, s, _ in tr_ev["host"])
        a1 = max(e for _, _, e in tr_ev["host"])
        busy = harness.union_seconds(tr_ev["device"], a0, a1)
        brk = harness.breakdown(tr_ev, a0, a1)
        layer_ctx = {
            "cells": b, "rounds": rounds_w, "window_s": window_s,
            "spans": spans, "launches": launches, "n": tr["n_clients"],
            "m": m,
            "flops_per_round": round_flops(cfg, tr, len(data["y_val"]), b),
            "peak_flops": PEAK_F32_OPS_PER_S,
            "trace": tr_ev, "trace_rounds": k,
            "trace_window_s": (a1 - a0) / 1e6, "busy_s": busy}
    sync()
    dev_info = harness.device_info(torch, device, int(spec["entry"]["chips"]))
    if trace:
        dev_info["busy_s"] = layer_ctx["busy_s"]
        dev_info["window_s"] = layer_ctx["trace_window_s"]

    # the program's results, then its state freed before the reference
    traj = {k: np.concatenate([x[k] for x in trajs], 1) for k in trajs[0]}
    counts = handle.tree["counts"].cpu().numpy()
    del handle, eng, ecells
    if cuda:
        torch.cuda.empty_cache()
    got = compare(data, cells, cfg, tr, device, t, h, traj, ends, counts)
    return {"end_to_end": {"cell_rounds_per_s": b * rounds_w / window_s,
                           "setup_s": setup_s},
            "checks": [(k, got[k], lim[k]) for k in lim], "readings": got,
            "attempted": b * rounds_w, "failed": 0,
            "device": dev_info, "layer_ctx": layer_ctx, "breakdown": brk}


def reference(data, cells, cfg, tr, device, rounds, *, ends=(),
              starts=None, tf32=False) -> dict:
    g = cfg["graph"]
    return ref.run(data, cells, rounds=rounds, m=tr["m"],
                   sampler=tr["sampler"], alpha=cfg["alpha"],
                   sweeps=cfg["max_sweeps"], local_steps=cfg["local_steps"],
                   batch_size=cfg["batch_size"], lr=cfg["lr"],
                   lr_decay=cfg["lr_decay"], eps=g["eps"], sigma2=g["sigma2"],
                   device=device, ends=ends, starts=starts, tf32=tf32)


def readings(out: dict, want: dict, m: int, ends_eval: dict) -> dict:
    """The numbers of a run ``out`` against the reference's ``want``: H's
    largest gap, the (cell, round) pairs whose set differs, the largest
    count gap, the largest val_loss gap in the first round of a segment
    (one round from the program's weights), the largest gap between the
    val_loss the program reported for a segment's last round and the
    reference's val_loss of the weights it carried out of that segment
    (``ends_eval``, {t: (B,)}), and the 90th percentile over the (cell,
    segment) pairs of each pair's largest val_loss gap over the segment's
    rounds and of its weight gap at the segment's end (largest over the
    cell's largest reference weight).  A percentile, not the largest: the
    recipe's SGD lifts a rounding difference to 1e-2 within a segment in a
    few pairs of thousands, as far as the TF32 control lifts it."""
    starts = sorted([0] + [t for t in want["params"]
                           if t < want["val_loss"].shape[1]])
    gap = np.abs(out["val_loss"] - want["val_loss"])
    seg_gap = np.stack([gap[:, t0:t1].max(1) for t0, t1 in
                        zip(starts, starts[1:] + [gap.shape[1]])])
    sets = np.zeros(want["sets"].shape, bool)
    b, t = np.indices(out["sel"].shape[:2])
    for j in range(m):
        ok = out["valid"][..., j]
        sets[b[ok], t[ok], out["sel"][..., j][ok]] = True
    w_gap = []
    for t, (w, bias) in want["params"].items():
        ref_flat = np.concatenate([w.reshape(len(w), -1), bias], 1)
        got_flat = np.concatenate([out["params"][t][0].reshape(len(w), -1),
                                   out["params"][t][1]], 1)
        scale = np.maximum(np.abs(ref_flat).max(1), 1e-30)
        w_gap.append(np.abs(got_flat - ref_flat).max(1) / scale)
    w_gap = np.stack(w_gap)
    h_gap = 0.0 if want["h"] is None else \
        float(np.max(np.abs(out["h"] - want["h"])))
    return {"h_gap": h_gap,
            "set_mismatches": int(np.sum(np.any(sets != want["sets"], -1))),
            "count_gap": float(np.max(np.abs(out["counts"]
                                             - want["counts"]))),
            "val_loss_gap_first": float(gap[:, starts].max()),
            "eval_gap_end": max(float(np.max(np.abs(
                out["val_loss"][:, t - 1] - v))) for t, v in ends_eval.items()),
            "val_loss_gap_p90": float(np.quantile(seg_gap, 0.9)),
            "weight_gap_p90": float(np.quantile(w_gap, 0.9))}


def compare(data, cells, cfg, tr, device, rounds, h, traj, ends,
            counts) -> dict:
    """The reference over every round the program ran, its weights
    restarted at each segment's start from the program's (the sets and
    counts run free), against the program's results."""
    want = reference(data, cells, cfg, tr, device, rounds, ends=list(ends),
                     starts={t: p for t, p in ends.items() if t < rounds})
    out = {"h": h, "sel": traj["sel"], "valid": traj["valid"],
           "counts": counts, "val_loss": traj["val_loss"], "params": ends}
    return readings(out, want, tr["m"], evals(data, ends, device))


def control(data, cells, cfg, tr, device, rounds) -> dict:
    """The readings of the control: the reference in TF32 put in the
    program's place for ``rounds`` rounds (its segments as a run's), held
    against the float32 reference restarted from its weights."""
    seg, w = tr["segment_rounds"], tr["warmup_rounds"]
    ends = [w] + list(range(w + seg, rounds + 1, seg))
    ctrl = reference(data, cells, cfg, tr, device, rounds, ends=ends,
                     tf32=True)
    want = reference(data, cells, cfg, tr, device, rounds, ends=ends,
                     starts={e: p for e, p in ctrl["params"].items()
                             if e < rounds})
    sets = ctrl["sets"]
    n = sets.shape[-1]
    sel = np.argsort(np.where(sets, np.arange(n), n + np.arange(n)), -1,
                     kind="stable")[..., :tr["m"]]
    out = {"h": ctrl["h"], "sel": sel,
           "valid": np.take_along_axis(sets, sel, -1),
           "counts": ctrl["counts"], "val_loss": ctrl["val_loss"],
           "params": ctrl["params"]}
    return readings(out, want, tr["m"], evals(data, ctrl["params"], device))


def evals(data, params: dict, device) -> dict:
    """The reference's val_loss of the given weights at each segment end."""
    return {t: ref.evaluate(data, w, bias, device)
            for t, (w, bias) in params.items()}
