#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  1. build    every CUDA kernel of the main path from ``src/repro_torch/
              kernels/csrc`` (one nvcc per source, all at once); prints the
              card's name and power limit.
  2. kernels  each kernel against its plain PyTorch version on the card at
              N in {30, 130, 1024, 4096} (swap panel m = ceil(0.1 N), and
              the engine's own M = 6 at N = 30 and M = 102 at N = 1024, the
              shapes phases 3 and 4 give it), under the stated tolerance; kernel, plain and (where one PyTorch
              call computes the same function) library times by CUDA
              events, beside the least time the card could take.
  3. slice    the quickstart: Synthetic(0.5, 0.5), N = 30, logistic
              regression, LN(0.5) availability, 40 rounds of FedGS
              (alpha = 1, oracle 3DG built by the kernels) and of Uniform
              on the card; then FedGS again on the CPU with the card's H, the
              same init and index draws: the same clients every round,
              val_loss within 1e-4.  Launch counts are reset just before the
              card's FedGS run and read just after.
  4. scale    5 rounds of FedGS on the card at N = 30 (M = 6) and at
              N = 1024 clients (M = 102): graph build, per-round solve and
              training times, and one profiled round's device busy share.
  5. the ``{"kernels": [...]}`` line (times at the main path's N = 30,
     M = 6).
The last line is ``{"ok": true, "device": {...}}``.  The script needs a CUDA
device and the repository's ``src/`` beside it; without either it exits
non-zero and prints no result.  Full output also goes to
``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SIZES = (30, 130, 1024, 4096)
# (N, sample_frac) of the engine runs in phases 3 and 4; the first is the
# main path.  The engine's M is max(1, round(frac * N)).
ENGINE_RUNS = ((30, 0.2), (1024, 0.1))
MAIN_N = ENGINE_RUNS[0][0]
NEG = -1e18

KERNEL_INFO = {
    "fused_adjacency": ("src/repro_torch/kernels/csrc/graph_fused.cu",
                        "src/repro/kernels/graph_fused.py:42"),
    "floyd_warshall": ("src/repro_torch/kernels/csrc/floyd_warshall.cu",
                       "src/repro/kernels/floyd_warshall.py:50"),
    "greedy_argmax": ("src/repro_torch/kernels/csrc/solver.cu",
                      "src/repro/kernels/solver.py:83"),
    "swap_best_fused": ("src/repro_torch/kernels/csrc/solver.cu",
                        "src/repro/kernels/solver.py:191"),
}

_log_lines: list[str] = []


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    _log_lines.append(line)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, *, budget_s: float = 0.25, max_reps: int = 200) -> float:
    """Mean ms of ``fn`` over a run of launches, by CUDA events (warm)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = time.perf_counter() - t0
    reps = int(max(1, min(max_reps, budget_s / max(est, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def engine_m(n: int, frac: float) -> int:
    return max(1, int(round(frac * n)))


MAIN_M = engine_m(*ENGINE_RUNS[0])


def swap_panels(n: int) -> list[int]:
    """Panel rows the swap kernel is held at for N = n: ceil(0.1 N) and the
    engine's M wherever an engine run has this N."""
    return sorted({max(1, math.ceil(0.1 * n))} |
                  {engine_m(nn, f) for nn, f in ENGINE_RUNS if nn == n})


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def features(np, torch, n: int, seed: int, d: int = 610):
    """Rows shaped like the Synthetic dataset's local optima (N, 610)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.0, np.sqrt(0.5), (n, 1))
    return torch.as_tensor(rng.normal(mu, 1.0, (n, d)), dtype=torch.float32)


# ------------------------------------------------------------ phase 2
def kernel_checks(np, torch, n: int, dev) -> dict:
    """Every kernel against its plain version at N = n.  Returns name -> row."""
    from repro_torch.core.graph_device import cap_and_normalize
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import graph_fused as gf
    from repro_torch.kernels import solver as sv

    rows = {}
    d = 610
    u = features(np, torch, n, seed=n, d=d).to(dev)
    tiny = float(np.finfo(np.float32).tiny)

    # fused adjacency: lo/hi bitwise, same inf pattern, finite R rtol 1e-4
    r_k, s_k = gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)
    r_p, s_p = gf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    if not torch.equal(s_k, s_p):
        raise AssertionError(f"fused_adjacency N={n}: lo/hi {s_k} != {s_p}")
    if not torch.equal(torch.isinf(r_k), torch.isinf(r_p)):
        raise AssertionError(f"fused_adjacency N={n}: inf pattern differs")
    fin = torch.isfinite(r_p)
    err = (r_k[fin] - r_p[fin]).abs()
    if not bool((err <= 1e-4 * r_p[fin].abs() + tiny).all()):
        raise AssertionError(f"fused_adjacency N={n}: R beyond rtol 1e-4")
    # V = U·Uᵀ is symmetric: N(N+1)/2 dot products of 2d operations each,
    # then the min-max, threshold and exp epilogue, ~5 per entry
    b, by = bound(4 * n * d + 4 * n * n + 8, n * (n + 1) * d + 5 * n * n)
    rows["fused_adjacency"] = dict(
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        tolerance="lo/hi bitwise, inf pattern identical, finite R rtol 1e-4",
        ms=cuda_ms(torch, lambda: gf.fused_adjacency_cuda(u, eps=0.1,
                                                          sigma2=0.01)),
        plain_ms=cuda_ms(torch, lambda: gf.fused_adjacency_plain(
            u, eps=0.1, sigma2=0.01), max_reps=20),
        bound_ms=b, bound_by=by, library_ms=None,
        library="none: no single PyTorch call computes the thresholded "
                "min-max adjacency")

    # Floyd–Warshall on the plain R: bitwise
    h_k = fw.floyd_warshall_cuda(r_p)
    h_p = fw.floyd_warshall_plain(r_p)
    if not torch.equal(h_k, h_p):
        raise AssertionError(f"floyd_warshall N={n}: not bitwise")
    b, by = bound(2 * 4 * n * n, 2 * n ** 3)
    rows["floyd_warshall"] = dict(
        max_abs_err=0.0, tolerance="bitwise",
        ms=cuda_ms(torch, lambda: fw.floyd_warshall_cuda(r_p), budget_s=0.5,
                   max_reps=50),
        plain_ms=cuda_ms(torch, lambda: fw.floyd_warshall_plain(r_p),
                         budget_s=0.5, max_reps=20),
        bound_ms=b, bound_by=by, library_ms=None,
        library="none: PyTorch has no shortest-path call")

    # solver inputs from this graph: H, z, one greedy pass's r and S
    rng = np.random.default_rng(n + 1)
    h = cap_and_normalize(h_p)
    m = max(1, math.ceil(0.1 * n))
    z = torch.as_tensor(2.0 * (rng.integers(0, 5, n) - 2.0 - m / n) + 1.0,
                        dtype=torch.float32, device=dev)
    al = float(np.float32(1.0) / np.float32(n))
    avail = torch.as_tensor(rng.random(n) < 0.7, device=dev)
    diag = sv.q_diag(h, z, al)

    def selection(m: int):
        """A random S of m clients and its greedy accumulator r."""
        s_np = np.zeros(n, bool)
        s_np[rng.choice(n, m, replace=False)] = True
        s = torch.as_tensor(s_np, device=dev)
        sel = torch.nonzero(s).flatten()
        r = torch.zeros(n, dtype=torch.float32, device=dev)
        for k in sel:
            r = r + sv.q_row(h, z, al, k)
        return s, sel, r

    s, sel, r = selection(m)
    mask = avail & ~s
    kv, ki = sv.masked_argmax_cuda(diag, r, mask)
    pv, pi = sv.masked_argmax_plain(diag, r, mask)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    ev, ei = sv.masked_argmax_cuda(diag, r, none)
    if not (torch.equal(kv, pv) and torch.equal(ki, pi)):
        raise AssertionError(f"greedy_argmax N={n}: ({kv}, {ki}) != ({pv}, {pi})")
    if float(ev) != float(np.float32(NEG)) or int(ei) != 0:
        raise AssertionError(f"greedy_argmax N={n}: all-masked gave ({ev}, {ei})")
    gain = torch.where(mask, diag + 2.0 * r, torch.full_like(r, NEG))
    b, by = bound(n * (4 + 4 + 1) + 12, 4 * n)
    rows["greedy_argmax"] = dict(
        max_abs_err=0.0, tolerance="bitwise (value and index)",
        ms=cuda_ms(torch, lambda: sv.masked_argmax_cuda(diag, r, mask)),
        plain_ms=cuda_ms(torch, lambda: sv.masked_argmax_plain(diag, r, mask)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.argmax(gain)),
        library="torch.argmax over the masked gain")

    for m in swap_panels(n):
        s, sel, r = selection(m)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        a = (-2.0 * r + diag)[sel]
        bb = torch.where(~s & avail, 2.0 * r + diag, torch.full_like(r, NEG))
        kargs = (h, z, al, sel, valid, a, bb)
        k3 = sv.swap_best_cuda(*kargs)
        p3 = sv.swap_best_plain(*kargs)
        if not all(torch.equal(x, y) for x, y in zip(k3, p3)) \
                or float(k3[0]) <= NEG / 2:
            raise AssertionError(f"swap_best_fused N={n} m={m}: {k3} != {p3}")
        b, by = bound(2 * 4 * m * n + 4 * n + 4 * m + 8 * m + m + 4 * m + 20,
                      10 * m * n)
        rows[f"swap_best_fused/m={m}"] = dict(
            max_abs_err=0.0, tolerance="bitwise (best, rank, j)", m=m,
            ms=cuda_ms(torch, lambda: sv.swap_best_cuda(*kargs)),
            plain_ms=cuda_ms(torch, lambda: sv.swap_best_plain(*kargs)),
            bound_ms=b, bound_by=by, library_ms=None,
            library="none: no single PyTorch call rebuilds Q and arg-maxes it")
    return rows


# ------------------------------------------------------------ phases 3, 4
def quickstart_cfg(FLConfig, rounds=40):
    return FLConfig(rounds=rounds, sample_frac=0.2, local_steps=10,
                    batch_size=10, lr=0.1, eval_every=4, seed=0)


def slice_run(np, torch, dev) -> tuple[dict, dict]:
    from repro_torch.core.availability import make_mode
    from repro_torch.core.fairness import count_variance, gini
    from repro_torch.core.sampler import FedGSSampler, UniformSampler
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import logistic_regression
    from repro_torch.kernels import ops

    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)

    def mode():
        return make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                    mode(), quickstart_cfg(FLConfig), device=dev)
    card.install_oracle_graph(ds.opt_params)
    h_card = card.run()
    torch.cuda.synchronize()
    fedgs_s = time.perf_counter() - t0
    launches = ops.launches()
    if card.m != MAIN_M:
        raise AssertionError(f"quickstart M = {card.m}, expected {MAIN_M}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")

    uni = FLEngine(ds, logistic_regression(), UniformSampler(), mode(),
                   quickstart_cfg(FLConfig), device=dev)
    h_uni = uni.run()
    for nm, hh in (("fedgs", h_card), ("uniform", h_uni)):
        if not (np.all(np.isfinite(hh.val_loss)) and len(hh.val_loss) == 11):
            raise AssertionError(f"{nm}: val_loss {hh.val_loss}")

    cpu = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                   mode(), quickstart_cfg(FLConfig), device="cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    h_cpu = cpu.run()
    same = [a == b for a, b in zip(h_card.all_sampled, h_cpu.all_sampled)]
    if len(same) != 40 or not all(same):
        raise AssertionError(f"card and CPU sets differ in rounds "
                             f"{[t for t, ok in enumerate(same) if not ok]}")
    dloss = float(np.max(np.abs(np.subtract(h_card.val_loss, h_cpu.val_loss))))
    if dloss > 1e-4:
        raise AssertionError(f"val_loss card vs CPU differs by {dloss}")

    # the card's 3DG against the plain build on the CPU
    from repro_torch.core.graph import build_3dg
    _, r_cpu, _ = build_3dg(ds.opt_params, device="cpu")
    r_card = card.install_oracle_graph(ds.opt_params)
    if not np.array_equal(np.isinf(r_card), np.isinf(r_cpu)):
        raise AssertionError("card R and CPU R: inf pattern differs")
    fin = np.isfinite(r_cpu)
    r_rel = float(np.max(np.abs(r_card[fin] - r_cpu[fin]) /
                         np.maximum(np.abs(r_cpu[fin]), 1e-38)))

    info = {"phase": "slice", "n": 30, "m": card.m, "rounds": 40,
            "fedgs_card_s": fedgs_s,
            "fedgs_best_loss": h_card.best_loss,
            "uniform_best_loss": h_uni.best_loss,
            "fedgs_count_var": count_variance(card.counts),
            "uniform_count_var": count_variance(uni.counts),
            "fedgs_gini": gini(card.counts), "uniform_gini": gini(uni.counts),
            "sets_identical_card_vs_cpu": True,
            "val_loss_max_diff_card_vs_cpu": dloss,
            "r_max_rel_card_vs_cpu": r_rel, "launches": launches}
    return info, launches


def scale_run(np, torch, dev, *, n_clients: int, frac: float,
              rounds: int = 5) -> dict:
    """FedGS on the card with the solve and the training timed per round
    (a sync around each), then one more round (with its eval) under
    torch.profiler for the device's busy share."""
    from repro_torch.core.availability import make_mode
    from repro_torch.core.sampler import FedGSSampler
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import logistic_regression

    t0 = time.perf_counter()
    ds = make_synthetic(n_clients=n_clients, alpha=0.5, beta=0.5, seed=0)
    data_s = time.perf_counter() - t0
    sampler = FedGSSampler(alpha=1.0)

    def engine(n_rounds):
        cfg = FLConfig(rounds=n_rounds, sample_frac=frac, local_steps=10,
                       batch_size=10, lr=0.1, eval_every=1, seed=0)
        return FLEngine(ds, logistic_regression(), sampler,
                        make_mode("LN", n_clients=ds.n_clients, beta=0.5,
                                  seed=99), cfg, device=dev)

    eng = engine(rounds)
    if eng.m != engine_m(n_clients, frac):
        raise AssertionError(f"N={n_clients}: M = {eng.m}, expected "
                             f"{engine_m(n_clients, frac)}")
    times = {"solve": [], "train": []}

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.install_oracle_graph(ds.opt_params)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    sample = sampler.sample
    sampler.sample = timed(sample, "solve")
    eng._trainer = timed(eng._trainer, "train")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = eng.run()
    run_s = time.perf_counter() - t0
    sampler.sample = sample
    if not (np.all(np.isfinite(hist.val_loss)) and
            all(len(s) == eng.m for s in hist.all_sampled)):
        raise AssertionError(f"scale run: {hist.val_loss}, "
                             f"{[len(s) for s in hist.all_sampled]}")

    one = engine(1)
    one.run()                                   # warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): an operator's
    # row repeats the device time of the kernels it launched
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    top = sorted(((e.key, e.self_device_time_total, e.count) for e in on_dev),
                 key=lambda x: -x[1])[:6]
    return {"phase": "scale", "n": n_clients, "m": eng.m, "rounds": rounds,
            "x_bytes": int(ds.x.nbytes), "data_gen_s": data_s,
            "graph_build_ms": graph_ms, "solve_ms_per_round": times["solve"],
            "train_ms_per_round": times["train"], "run_s": run_s,
            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
            "val_loss": hist.val_loss,
            "profiled_round_wall_ms": wall_ms,
            "profiled_round_device_ms": dev_us / 1e3 if dev_us else None,
            "device_busy_share": dev_us / 1e3 / wall_ms if dev_us else None,
            "top_device_ms": [[k, t / 1e3, c] for k, t, c in top]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    emit(smi)
    t0 = time.perf_counter()
    logs = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    emit({"phase": "build", "seconds": build_s, "sources": sorted(logs),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    per_n = {}
    for n in SIZES:
        rows = kernel_checks(np, torch, n, dev)
        per_n[n] = rows
        emit({"phase": "kernels", "n": n, "card": smi, "rows": rows})

    info, launches = slice_run(np, torch, dev)
    emit(info)
    for n, frac in ENGINE_RUNS:
        emit(scale_run(np, torch, dev, n_clients=n, frac=frac))

    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        row = per_n[MAIN_N][f"{name}/m={MAIN_M}" if name == "swap_best_fused"
                            else name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"], "n": MAIN_N,
                        **({"m": row["m"]} if "m" in row else {}),
                        "parity": "pass"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    (OUT / "chip_smoke.jsonl").write_text("\n".join(_log_lines) + "\n")
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
