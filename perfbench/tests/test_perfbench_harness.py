"""The result line, the data-driven lookup of cells and metrics, and the
exits without a result."""
import json
import shutil
import subprocess
import sys
import time

import pytest

import harness
import run
from conftest import BENCH, SMALL

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", CELLS)
def test_last_line_shape(workload, trace):
    spec = harness.cell(workload)
    line = run.run_cell(workload, 2 ** 31 + 77, 0.5, bool(trace),
                        device="cpu", t_start=time.perf_counter(),
                        overrides=SMALL)
    json.dumps(line)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = {m["name"] for m in spec["per_layer" if trace else "end_to_end"]}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["checks"]) == set(spec["limits"])


def test_cell_and_metric_added_as_files(tmp_path, monkeypatch):
    """A cell, its mix, its limits and a metric added as files only."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = harness.benchmark()
    tr = harness.load_json(BENCH / "traffic" / "fedgs-7modes-x8-n100.json")
    (root / "perfbench" / "traffic" / "fedgs-ln-x2-n40.json").write_text(
        json.dumps({**tr, "modes": ["LN"], "seeds_per_mode": 2,
                    "n_clients": 40}))
    (root / "perfbench" / "limits" / "sweep-fedgs-n40.json").write_text(
        (BENCH / "limits" / "sweep-fedgs-n100.json").read_text())
    (root / "perfbench" / "metrics" / "rounds_seen.sweep.py").write_text(
        "def read(ctx):\n    return float(ctx['rounds'])\n")
    bench["workloads"].append({"name": "sweep-fedgs-n40",
                               "config": "synthetic-logreg",
                               "traffic": "fedgs-ln-x2-n40", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"][0]["workloads"].append("sweep-fedgs-n40")
    bench["per_layer"].append({"name": "rounds_seen.sweep", "unit": "rounds",
                               "better": "higher", "source": "host_clock",
                               "layer": "device", "moves": "cell_rounds_per_s",
                               "workloads": ["sweep-fedgs-n40"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "BENCH", root / "perfbench")
    monkeypatch.setattr(harness, "ROOT", root)
    spec = harness.cell("sweep-fedgs-n40")
    assert spec["traffic"]["n_clients"] == 40
    assert [m["name"] for m in spec["per_layer"]] == ["rounds_seen.sweep"]
    assert harness.reader("rounds_seen.sweep").read({"rounds": 7}) == 7.0
    assert harness.driver(spec["traffic"]["driver"]).run


def _bare_checkout(tmp_path):
    root = tmp_path / "bare"
    shutil.copytree(BENCH, root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(BENCH.parent / "BENCHMARK.json", root / "BENCHMARK.json")
    return root


def test_no_result_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    root = _bare_checkout(tmp_path)
    p = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=root, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_no_result_without_a_card():
    """This machine has no CUDA device: no result, a non-zero exit."""
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_forbidden_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_union_and_breakdown():
    trace = {"device": [("k1", 0.0, 10.0), ("k2", 5.0, 20.0),
                        ("k1", 40.0, 50.0)],
             "host": [("outer", -1.0, 100.0), ("inner", 19.0, 45.0)]}
    assert harness.union_seconds(trace["device"], 0.0, 100.0) == 30e-6
    b = harness.breakdown(trace, 0.0, 100.0)
    assert b["device_ops"][0] == ["k1", 20e-6]
    assert b["idle_gaps"][0] == ["outer", 50e-6]
    assert b["idle_gaps"][1] == ["inner", 20e-6]
