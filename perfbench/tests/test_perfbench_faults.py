"""The comparison that decides ``correct`` has to fail: the reference in
TF32 put in the program's place (the control), and a run whose timed path
is broken underneath (a round that leaves its state unchanged; half of
the batch left out of the average; each of these two only after a
segment's first round, with the eval kept consistent; an answer altered
where it is produced).  One chip only, so no exchange between chips exists to leave
out.  The card-side check of the harness is skipped (device "cpu"), the
rest of the run is the benchmark's own."""
import time

import numpy as np
import pytest
import torch

import faults
import harness
import run
from conftest import SMALL

CELLS = [w["name"] for w in harness.benchmark()["workloads"]
         if harness.load_json(harness.BENCH / "traffic" / f"{w['traffic']}"
                              ".json")["driver"] == "sweep"]


def _run(cell):
    return run.run_cell(cell, 12345, 0.3, False, device="cpu",
                        t_start=time.perf_counter(), overrides=SMALL)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert _run(cell)["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails(cell):
    spec = harness.cell(cell)
    tr, cfg = {**spec["traffic"], **SMALL}, spec["config"]
    drv = harness.driver(tr["driver"])
    data, cells = drv.make_inputs(cfg, tr, 7)
    got = drv.control(data, cells, cfg, tr, "cpu", 21)
    checks = [(k, got[k], v) for k, v in spec["limits"].items()]
    assert not harness.judge(checks), checks


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(cell, fault):
    with faults.FAULTS[fault]():
        line = _run(cell)
    checks = line["checks"]
    assert line["correct"] is False, checks
    if fault == "altered_answer":
        assert checks["set_mismatches"]["value"] >= 1
    if fault.endswith("_late"):
        # sound in a segment's first round, its eval consistent: only the
        # rounds after the first see it
        for name in ("val_loss_gap_first", "eval_gap_end"):
            if name in checks:
                assert checks[name]["value"] <= checks[name]["limit"], checks


def test_tf32_rounding():
    from reference.fedsweep import round_tf32
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -3.14159])
    np.testing.assert_array_equal(
        round_tf32(x).numpy(),
        np.float32([1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -3.140625]))
