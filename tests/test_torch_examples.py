"""The example twins (``repro_torch.examples``) on the CPU, each run as its
users run it (``python -m repro_torch.examples.<name> --device cpu``, a
subprocess with a timeout): its printed sets and counts equal the port's
engine API for the same configuration.

The twins and the in-test runs use one intra-op thread each, so that the
suite's parallel workers do not oversubscribe the cores.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core.availability import make_mode
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed.models import logistic_regression

ROOT = Path(__file__).resolve().parents[1]
TWIN_TIMEOUT = 300


@pytest.fixture
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _twin(name: str, *args: str) -> tuple[str, dict]:
    """Run a twin on the CPU; its stdout and its JSON lines by run label."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *args], env=env, capture_output=True, text=True,
        timeout=TWIN_TIMEOUT, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = {}
    for line in out.stdout.splitlines():
        if line.startswith("{"):
            rec = json.loads(line)
            runs[rec["run"]] = rec
    return out.stdout, runs


def test_quickstart_twin_equals_the_engine(one_thread):
    from repro_torch.core.sampler import FedGSSampler, UniformSampler
    from repro_torch.examples import quickstart
    from repro_torch.fed.engine import FLEngine
    text, runs = _twin("quickstart")
    assert "== summary under LogNormal(0.5) availability ==" in text
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    for label, sampler in (("uniform", UniformSampler()),
                           ("fedgs", FedGSSampler(alpha=1.0, device="cpu"))):
        eng = FLEngine(ds, logistic_regression(), sampler,
                       make_mode("LN", n_clients=30, beta=0.5, seed=99),
                       quickstart.config(), device="cpu")
        if label == "fedgs":
            eng.install_oracle_graph(ds.opt_params)
        hist = eng.run()
        assert runs[label]["sets"] == [list(map(int, s))
                                       for s in hist.all_sampled]
        assert runs[label]["counts"] == eng.counts.tolist()


def test_availability_scenarios_twin_equals_the_engine(one_thread):
    """The five scenario cells as one batch: each cell's sets and counts
    are ``run_batch``'s on the same cells, built here."""
    from repro_torch.examples import availability_scenarios as av
    text, runs = _twin("availability_scenarios")
    assert "running 5 scenario families as ONE batch" in text
    eng, labels, cells = av.build("cpu")
    assert set(runs) == set(labels)
    for label, hist in zip(labels, eng.run_batch(cells)):
        assert runs[label]["sets"] == [hist.sampled(t).tolist()
                                       for t in range(av.ROUNDS)]
        assert runs[label]["counts"] == hist.counts.tolist()


def test_federated_vision_twin_equals_the_engine(one_thread):
    from repro_torch.data.vision import make_cifar_like
    from repro_torch.examples import federated_vision as fv
    text, runs = _twin("federated_vision", "--rounds", "2", "--clients",
                       "10")
    assert "(cells: best val loss / final count variance)" in text
    assert len(runs) == len(fv.MODES) * len(fv.METHODS)
    ds = make_cifar_like(n_clients=10, n_total=4000, seed=0)
    for name, fn in fv.METHODS:
        hist, counts = fv.run_one(ds, fn, "LN", 0.5, 2, "cpu")
        assert runs[f"{name}/LN"]["sets"] == [list(map(int, s))
                                              for s in hist.all_sampled]
        assert runs[f"{name}/LN"]["counts"] == counts.tolist()


def test_serve_llm_twin_serves_the_reduced_config(one_thread):
    from repro_torch.launch import serve
    text, _ = _twin("serve_llm", "--batch", "2", "--gen", "4")
    tokens = serve.main(["--reduced", "--batch", "2", "--gen", "4",
                         "--device", "cpu"])
    assert f"first sequence: {tokens[0][:16].tolist()}" in text


def test_train_federated_lm_twin_equals_train_main(one_thread):
    """The twin fills the reference's defaults (reduced, 16 clients, FedGS
    under SLN) and trains: its sets and counts are ``train.main``'s on the
    same flags."""
    from repro_torch.examples import train_federated_lm as twin
    from repro_torch.launch import train
    argv = ["--rounds", "2", "--local-steps", "1", "--batch", "2", "--seq",
            "16"]
    text, runs = _twin("train_federated_lm", *argv)
    full = twin.with_defaults(argv + ["--device", "cpu"])
    assert full[len(argv) + 2:] == ["--reduced", "--clients", "16",
                                    "--sampler", "fedgs", "--mode", "SLN"]
    sets = []
    _, counts = train.main(full, on_round=lambda i: sets.append(
        [int(k) for k in i["sel"]]))
    assert runs["train_federated_lm"]["sets"] == sets
    assert runs["train_federated_lm"]["counts"] == counts.tolist()
    assert "round   1" in text and "done in" in text
