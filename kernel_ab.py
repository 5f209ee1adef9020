#!/usr/bin/env python3
"""Device times of the port's kernel rows in two checkouts, on one GPU.

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [--pairs 10] [--sizes 30]
                         [--groups per_n,staged,swap,robust,edges,fused]

Runs the kernel checks of ``chip_smoke.py`` phase 2 of each checkout for
``--pairs`` pairs, in the order A B, B A, A B, ...  ``--groups`` picks
them: ``per_n`` the rows at each N of ``--sizes`` (30 by default),
``staged`` the staged similarity and adjacency rows, ``swap`` the
dense-swap rows, ``robust`` the memagg and krum rows, ``edges`` the fused
adjacency's edge shapes and the greedy argmax's threshold rows (where the
checkout's ``chip_smoke.py`` has them); all by default.  ``fused`` times
the fused adjacency as ``fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)``
plans it at N = 1024 and 4096 (d = 610; the tile pass plus the in-place
epilogue launch) with this script's own harness.  ``argmax`` times the
greedy argmax's wrapper, ``masked_argmax_cuda(diag, r, mask)``, with this
script's own harness on both checkouts: its inputs at each N of
``--sizes`` are the first allocations of the turn (so both checkouts'
kernels read the addresses the caching allocator hands out first, which a
tiny kernel's time depends on), ``device_ms`` by CUDA-graph replay, ``ms``
by CUDA events over 20,000 calls with Python's garbage collector paused.

Both checkouts run in this one process, turn about: each checkout's
``chip_smoke`` and ``repro_torch`` are imported side by side (their
modules swapped in and out of ``sys.modules`` around each turn), so both
checkouts' kernels read inputs that the same allocator places (a ~2 µs
kernel reads ±10% by where its inputs lie), and every pair is a turn of
each.  Each checkout builds its own kernels (into that checkout's
``build/``), runs that checkout's own checks, which hold every kernel
against its plain version and fail on a mismatch, and hands back each
row's ``device_ms`` (20 calls replayed from a CUDA graph) and ``ms`` (CUDA
events over a loop of calls: a short call reads its host time).  Prints
the card's name and power limit, then one JSON line per row that both
checkouts have: the median, least and largest ``device_ms`` and the
median ``ms`` of each, and the change's medians over the parent's.  Every
line also goes to ``kernel_ab.jsonl`` in the output directory (``OUT``).
Exits non-zero if a check fails or there is no CUDA device.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"


GROUPS = ("per_n", "staged", "swap", "robust", "edges", "fused")
# the fused adjacency's N in the ``fused`` group (d = 610)
FUSED_SIZES = (1024, 4096)


def argmax_rows(torch, np, cs, sizes: list[int]) -> dict:
    """The greedy argmax wrapper of the checkout, timed by one harness."""
    import gc

    from repro_torch.kernels import solver as sv
    dev = torch.device("cuda")
    inputs = {}
    for n in sizes:                       # the turn's first allocations
        rng = np.random.default_rng(n)
        inputs[n] = (
            torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.normal(size=n), dtype=torch.float32, device=dev),
            torch.as_tensor(rng.random(n) < 0.6, device=dev))
    rows = {}
    for n, args in inputs.items():
        want = sv.masked_argmax_plain(*args)
        if not all(torch.equal(x, y)
                   for x, y in zip(sv.masked_argmax_cuda(*args), want)):
            raise AssertionError(f"greedy argmax n={n}: not bitwise")
        dev_ms = cs.device_ms(torch, lambda: sv.masked_argmax_cuda(*args))
        reps = 20000
        gc.disable()
        try:
            sv.masked_argmax_cuda(*args)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                sv.masked_argmax_cuda(*args)
            end.record()
            end.synchronize()
        finally:
            gc.enable()
        rows[f"argmax/n={n}"] = {"device_ms": dev_ms,
                                 "ms": start.elapsed_time(end) / reps}
    return rows


def fused_rows(torch, np, cs) -> dict:
    """The fused adjacency as the checkout plans it, one harness."""
    from repro_torch.kernels import graph_fused as gf
    dev = torch.device("cuda")
    rows = {}
    for n in FUSED_SIZES:
        u = cs.features(np, torch, n, seed=n, d=610).to(dev)

        def call():
            return gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)
        rows[f"fused/n={n}"] = {"device_ms": cs.device_ms(torch, call),
                                "ms": cs.cuda_ms(torch, call)}
    return rows


def group_rows(torch, np, cs, sizes: list[int], groups: list[str]) -> dict:
    """Every row of ``groups`` from the checkout whose modules are loaded
    (``cs`` its chip_smoke): name -> {device_ms, ms}."""
    dev = torch.device("cuda")
    rows = {}
    if "argmax" in groups:                # first: its inputs' addresses
        rows.update(argmax_rows(torch, np, cs, sizes))
    if "per_n" in groups:
        rows.update({f"n={n}/{k}": v for n in sizes
                     for k, v in cs.kernel_checks(np, torch, n, dev).items()})
    if "staged" in groups:
        rows.update(cs.staged_kernel_checks(np, torch, dev))
    if "swap" in groups:
        rows.update(cs.swap_gain_checks(np, torch, dev))
    if "robust" in groups:
        rows.update(cs.robust_kernel_checks(np, torch, dev))
    if "edges" in groups:
        for fn in ("fused_edge_checks", "argmax_edge_checks"):
            if hasattr(cs, fn):
                for name, blob in getattr(cs, fn)(np, torch, dev).items():
                    rows.update({f"{name}/{k}": v
                                 for k, v in blob["rows"].items()})
    if "fused" in groups:
        rows.update(fused_rows(torch, np, cs))
    return {k: {"device_ms": v["device_ms"], "ms": v.get("ms")}
            for k, v in rows.items() if "device_ms" in v}


def _ours(name: str) -> bool:
    return name == "chip_smoke" or name.split(".")[0] == "repro_torch"


def load_tree(tree: Path) -> dict:
    """Import ``tree``'s chip_smoke (and through it its repro_torch) with
    no other checkout's modules loaded; returns its modules, which stay
    in sys.modules until the next swap."""
    for k in [k for k in sys.modules if _ours(k)]:
        del sys.modules[k]
    sys.path[:0] = [str(tree / "src"), str(tree)]
    try:
        import chip_smoke as cs
        import repro_torch.kernels.ops  # noqa: F401  (every kernel module)
    finally:
        del sys.path[:2]
    if Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s")
    return {k: v for k, v in sys.modules.items() if _ours(k)}


def swap_in(mods: dict, tree: Path) -> None:
    """Make ``tree`` the checkout that imports resolve to: its modules in
    sys.modules (those imported lazily during its last turn included),
    its ``src/`` first on the path."""
    for k in [k for k in sys.modules if _ours(k)]:
        del sys.modules[k]
    sys.modules.update(mods)
    sys.path[:] = [str(tree / "src"), str(tree)] + [
        p for p in sys.path if p not in (str(tree / "src"), str(tree))]


def run_pairs(trees: list[Path], sizes: list[int], groups: list[str],
              pairs: int) -> list[list[dict]]:
    """Both checkouts in this process, turn about, ``pairs`` pairs:
    per checkout, the rows of every pair."""
    import numpy as np
    import torch
    base_path = list(sys.path)
    mods = [load_tree(t) for t in trees]
    times: list[list[dict]] = [[], []]
    for i in range(pairs):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            sys.path[:] = base_path
            swap_in(mods[side], trees[side])
            rows = group_rows(torch, np, mods[side]["chip_smoke"], sizes,
                              groups)
            mods[side] = {k: v for k, v in sys.modules.items() if _ours(k)}
            times[side].append(rows)
    return times


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sizes", default="30",
                    help="comma-separated N of the per-N kernel rows")
    ap.add_argument("--groups", default=",".join(GROUPS),
                    help="comma-separated row groups: argmax, " +
                    ", ".join(GROUPS))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if len(args.trees) != 2:
        ap.error("give PARENT_DIR and CHANGE_DIR")
    trees = [t.resolve() for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = [smi]
    print(smi, flush=True)
    times = run_pairs(trees, [int(n) for n in args.sizes.split(",")],
                      args.groups.split(","), args.pairs)
    for name in times[0][0]:
        if name not in times[1][0]:
            continue
        a = [t[name]["device_ms"] for t in times[0]]
        b = [t[name]["device_ms"] for t in times[1]]
        row = {"row": name, "card": smi, "pairs": args.pairs,
               "parent_median": statistics.median(a), "parent_min": min(a),
               "parent_max": max(a), "change_median": statistics.median(b),
               "change_min": min(b), "change_max": max(b),
               "change_over_parent":
                   statistics.median(b) / statistics.median(a)}
        ha = [t[name]["ms"] for t in times[0] if t[name]["ms"] is not None]
        hb = [t[name]["ms"] for t in times[1] if t[name]["ms"] is not None]
        if ha and hb:
            row.update(parent_ms_median=statistics.median(ha),
                       change_ms_median=statistics.median(hb),
                       change_over_parent_ms=statistics.median(hb) /
                       statistics.median(ha))
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "kernel_ab.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
