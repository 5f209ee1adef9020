"""Readings that a sweep cell's limits are set from (not run by the
benchmark's own runs).

    python perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--fault-seeds 1,2,3 [--faults a,b]] \
        --seconds 10 [--out FILE]

For each of ``--seeds`` it runs the cell as a benchmark run does (set-up,
a window of ``--seconds``, the reference) and records the compared numbers
of the program against the reference (the lower readings).  For each of
``--control-seeds`` it puts the reference computed in TF32 (the nearest
precision below the configuration's float32) in the program's place, over
as many rounds as that seed's program run made (else
``--control-rounds``), and records the same
numbers (the control's readings, the upper ones).  For each of
``--fault-seeds`` it runs the cell with each fault of ``faults.py`` (or
those named by ``--faults``) planted in the program.  One process, so the
kernels are built and loaded once.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--control-rounds", type=int, default=0)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    harness.prepare_environment()
    import torch
    spec = harness.cell(args.workload)
    harness.require_chips(torch, int(spec["entry"]["chips"]))
    dev = torch.device("cuda", 0)
    drv = harness.driver(spec["traffic"]["driver"])
    tr, cfg = spec["traffic"], spec["config"]
    rows, rounds = [], {}
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        out = drv.run(spec=spec, seed=seed, seconds=args.seconds,
                      trace=False, device=dev, t_start=t0)
        got = out["readings"]
        rounds[seed] = out["attempted"] // (len(tr["modes"]) *
                                            tr["seeds_per_mode"]) + \
            tr["warmup_rounds"]
        rows.append({"side": "program", "seed": seed, **got,
                     "rate": out["end_to_end"]["cell_rounds_per_s"],
                     "setup_s": out["end_to_end"]["setup_s"]})
        print(json.dumps(rows[-1]), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        data, cells = drv.make_inputs(cfg, tr, seed)
        t = rounds.get(seed, args.control_rounds or
                       max(rounds.values(), default=40))
        got = drv.control(data, cells, cfg, tr, dev, t)
        rows.append({"side": "control_tf32", "seed": seed, "rounds": t,
                     **got})
        print(json.dumps(rows[-1]), flush=True)
    import faults
    names = [f for f in args.faults.split(",") if f] or sorted(faults.FAULTS)
    for seed in [int(s) for s in args.fault_seeds.split(",") if s]:
        for name in names:
            with faults.FAULTS[name]():
                out = drv.run(spec=spec, seed=seed, seconds=args.seconds,
                              trace=False, device=dev,
                              t_start=time.perf_counter())
            rows.append({"side": name, "seed": seed, **out["readings"]})
            print(json.dumps(rows[-1]), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
