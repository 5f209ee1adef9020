"""Each cell once on the card, through the command the driver runs: a
correct result line on the platform the cell asks for.  Skips without a
CUDA device (the card is checked in a fixture, not at import)."""
import json
import subprocess
import sys

import pytest

import harness
from conftest import BENCH

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.fixture
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(card, workload, trace):
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        workload, "--seed", str(2 ** 31 + 99), "--seconds",
                        "2", "--trace", str(trace)], capture_output=True,
                       text=True, timeout=900, cwd=BENCH.parent)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"
