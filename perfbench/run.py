"""Run one benchmark cell once and print its result line.

    python perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (inputs and weights from the seed, the kernels' build and warm-up)
is timed from the start of this process; then the cell's driver measures
for ``--seconds`` and checks what the timed path produced against the
plain reference under ``perfbench/reference``.  ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics with the
device's busy time.  The last line of standard output is one JSON object;
the compared numbers and their limits are also the last lines of standard
error.  A run that cannot give a result exits non-zero and prints none.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import harness  # noqa: E402


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device=None, t_start: float | None = None,
             overrides: dict | None = None) -> dict:
    """One run of a cell: the result line as a dict.  ``device`` None means
    the card (and raises without enough of them); tests pass "cpu" and
    ``overrides`` (traffic keys) to drive the rest of a run at a small
    size."""
    harness.prepare_environment()
    import torch
    spec = harness.cell(workload)
    if overrides:
        spec["traffic"] = {**spec["traffic"], **overrides}
    chips = int(spec["entry"]["chips"])
    if device is None:
        harness.require_chips(torch, chips)
        device = torch.device("cuda", 0)
    else:
        device = torch.device(device)
    drv = harness.driver(spec["traffic"]["driver"])
    out = drv.run(spec=spec, seed=seed, seconds=seconds, trace=trace,
                  device=device,
                  t_start=T_START if t_start is None else t_start)
    found = harness.forbidden_modules()
    if found:
        raise harness.BenchError(f"loaded in the run's process: {found}")
    metrics = {}
    if trace:
        for m in spec["per_layer"]:
            value = harness.reader(m["name"]).read(out["layer_ctx"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": out["end_to_end"][m["name"]],
                                  "unit": m["unit"]}
    checks = out["checks"]
    extra = {"breakdown": out["breakdown"]} if trace and \
        out.get("breakdown") else None
    return harness.result_line(
        correct=harness.judge(checks), attempted=out["attempted"],
        failed=out["failed"], metrics=metrics, device=out["device"],
        checks=checks, extra=extra)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace))
    except harness.BenchError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
