#!/usr/bin/env python3
"""Device times of the port's kernel rows in two checkouts, on one GPU.

    python3 kernel_ab.py PARENT_DIR CHANGE_DIR [--pairs 10] [--sizes 30]

Runs the kernel checks of ``chip_smoke.py`` phase 2 (the rows at each N of
``--sizes``, 30 by default, the staged similarity and adjacency rows, the
dense-swap rows, and the memagg and krum rows) of each checkout in a
process of its own, in the
order A B, B A, A B, ... for ``--pairs`` pairs.  Each process builds its
checkout's kernels (into that checkout's ``build/``), runs that checkout's
own checks, which hold every kernel against its plain version and fail on
a mismatch, and hands back each row's ``device_ms`` (20 calls replayed from
a CUDA graph).  Prints the card's name and power limit, then one JSON line
per row that both checkouts have: the median, least and largest
``device_ms`` of each, and the change's median over the parent's.  Every
line also goes to ``chiprun_out/kernel_ab.jsonl``.  Exits non-zero if any
process fails or there is no CUDA device.
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


def worker(tree: Path, sizes: list[int]) -> dict:
    """Every kernel row of the checkout at ``tree``: name -> device_ms."""
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import numpy as np
    import torch

    import chip_smoke as cs
    if Path(cs.__file__).resolve().parent != tree:
        raise RuntimeError(f"imported {cs.__file__}, not {tree}'s")
    dev = torch.device("cuda")
    rows = {f"n={n}/{k}": v for n in sizes
            for k, v in cs.kernel_checks(np, torch, n, dev).items()}
    rows.update(cs.staged_kernel_checks(np, torch, dev))
    rows.update(cs.swap_gain_checks(np, torch, dev))
    rows.update(cs.robust_kernel_checks(np, torch, dev))
    return {k: v["device_ms"] for k, v in rows.items() if "device_ms" in v}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*", type=Path)
    ap.add_argument("--pairs", type=int, default=10)
    ap.add_argument("--sizes", default="30",
                    help="comma-separated N of the per-N kernel rows")
    ap.add_argument("--worker", type=Path)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if args.worker:
        sizes = [int(n) for n in args.sizes.split(",")]
        print(json.dumps(worker(args.worker.resolve(), sizes)), flush=True)
        return 0
    if len(args.trees) != 2:
        ap.error("give PARENT_DIR and CHANGE_DIR")
    trees = [t.resolve() for t in args.trees]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    lines = [smi]
    print(smi, flush=True)
    times: list[list[dict]] = [[], []]
    for i in range(args.pairs):
        for side in ((0, 1) if i % 2 == 0 else (1, 0)):
            run = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--worker",
                 str(trees[side]), "--sizes", args.sizes], cwd=trees[side],
                capture_output=True, text=True, timeout=600)
            if run.returncode != 0:
                print(run.stdout[-4000:], run.stderr[-4000:], file=sys.stderr)
                return 1
            times[side].append(json.loads(run.stdout.strip().splitlines()[-1]))
    for name in times[0][0]:
        if name not in times[1][0]:
            continue
        a = [t[name] for t in times[0]]
        b = [t[name] for t in times[1]]
        row = {"row": name, "card": smi, "pairs": args.pairs,
               "parent_median": statistics.median(a), "parent_min": min(a),
               "parent_max": max(a), "change_median": statistics.median(b),
               "change_min": min(b), "change_max": max(b),
               "change_over_parent":
                   statistics.median(b) / statistics.median(a)}
        lines.append(json.dumps(row))
        print(lines[-1], flush=True)
    OUT.mkdir(exist_ok=True)
    (OUT / "kernel_ab.jsonl").write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
