"""The readers of the engine's layer spans: the four per-round ms metrics
from a traced CPU run of each cell, and the sampler's share of the device's
idle time from a hand-built trace."""
import time

import pytest

import harness
import run
from conftest import SMALL

CELLS = ["sweep-fedgs-n100", "sweep-uniform-n100"]
LAYERS = ["sampler_ms_per_round.sweep", "local_train_ms_per_round.sweep",
          "aggregate_ms_per_round.sweep", "eval_ms_per_round.sweep"]


@pytest.mark.parametrize("workload", CELLS)
def test_layer_ms_inside_dispatch(workload):
    line = run.run_cell(workload, 2 ** 31 + 1234, 0.5, True, device="cpu",
                        t_start=time.perf_counter(), overrides=SMALL)
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(LAYERS) <= set(got)
    assert all(got[k] >= 0 for k in LAYERS)
    assert all(line["metrics"][k]["unit"] == "ms" for k in LAYERS)
    assert sum(got[k] for k in LAYERS) <= \
        got["dispatch_ms_per_round.sweep"]
    # no device events on the CPU: nothing to read
    assert "sampler_idle_share.sweep" not in got


def _ctx(device, host):
    a0 = min(s for _, s, _ in host)
    a1 = max(e for _, _, e in host)
    return {"trace": {"device": device, "host": host},
            "trace_window_s": (a1 - a0) / 1e6,
            "busy_s": harness.union_seconds(device, a0, a1)}


def test_sampler_idle_share_by_hand():
    read = harness.reader("sampler_idle_share.sweep").read
    device = [("k", 10.0, 20.0), ("k", 50.0, 60.0)]
    host = [("dispatch_segment", 0.0, 100.0), ("sampler", 5.0, 55.0),
            ("local_train", 55.0, 90.0)]
    # idle 80 us of 100; inside the sampler's 50 us the device is busy
    # 10 (10-20) + 5 (50-55): 35 of the 80 idle us
    got = read(_ctx(device, host))
    assert got == pytest.approx(100.0 * 35 / 80)
    assert 0.0 <= got <= 100.0
    # the whole window a sampler range: every idle us is the sampler's
    whole = read(_ctx(device, [("sampler", 0.0, 100.0)]))
    assert whole == pytest.approx(100.0)
    assert read(_ctx([], host)) is None
    # a program without the span
    assert read(_ctx(device, [h for h in host if h[0] != "sampler"])) is None
