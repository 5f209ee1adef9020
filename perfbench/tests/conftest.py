"""Puts the benchmark's modules and the program on the path."""
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
for p in (str(BENCH), str(BENCH.parent / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# the size at which the CPU runs a cell: every part of a run, few cells
SMALL = {"n_clients": 30, "m": 4, "modes": ["IDL", "LN"], "seeds_per_mode": 2,
         "segment_rounds": 2, "max_rounds": 200, "trace_rounds": 1,
         "warmup_rounds": 1}
