"""Availability scenarios: FedGS under STATEFUL client availability the
paper's Table-1 modes cannot express — Gilbert–Elliott churn, regional
cluster outages, non-stationary drift, deadline stragglers — swept together
with a legacy mode as ONE batch of the scan engine (the twin of
``examples/availability_scenarios.py`` on the port).

  PYTHONPATH=src python -m repro_torch.examples.availability_scenarios \\
      [--device cpu]

Every cell is a different ``AvailabilityProcess`` family
(core/availability_device.py), drawn on the device; ``ScanEngine.
run_batch`` runs the whole heterogeneous sweep side by side.  Printed per
scenario: best validation loss, mean participation rate, and the
sampling-count fairness gap FedGS balances; then each cell's sets and
counts.
"""
import argparse
import json

import numpy as np

from repro_torch.core.availability import make_mode
from repro_torch.core.availability_device import (ClusterOutage,
                                                  DeadlineProcess,
                                                  DriftProcess,
                                                  GilbertElliott)
from repro_torch.core.fairness import count_variance, gini
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed.models import logistic_regression
from repro_torch.fed.scan_engine import ScanConfig, ScanEngine, oracle_h

ROUNDS = 40


def scenarios(ds, rounds: int = ROUNDS) -> dict:
    n = ds.n_clients
    mdf = make_mode("MDF", n_clients=n, data_sizes=ds.sizes).probs_table()
    ldf = make_mode("LDF", n_clients=n, data_sizes=ds.sizes).probs_table()
    return {
        "LN (legacy)": make_mode("LN", n_clients=n, beta=0.5,
                                 seed=99).process(),
        "GE churn": GilbertElliott(n, mean_on=8, mean_off=4),
        "cluster outage": ClusterOutage(n, n_clusters=4, p_fail=0.1,
                                        p_recover=0.3, floor=0.05),
        "MDF->LDF drift": DriftProcess(mdf, ldf, t0=5, t1=rounds - 5),
        "deadline": DeadlineProcess(n, deadline=1.0, rho=0.8, sigma=0.2),
    }


def build(device=None):
    """The engine, the scenario labels and their cells."""
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    eng = ScanEngine(ds, logistic_regression(),
                     ScanConfig(rounds=ROUNDS, m=6, sampler="fedgs",
                                local_steps=10, batch_size=10, lr=0.1,
                                eval_every=4, max_sweeps=32),
                     device=device)
    h = oracle_h(ds.opt_params, device=device)
    scen = scenarios(ds)
    cells = [eng.cell(seed=0, process=proc, alpha=1.0, h=h,
                      avail_seed=1234 + i)
             for i, proc in enumerate(scen.values())]
    return eng, list(scen), cells


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    eng, labels, cells = build(args.device)
    print(f"running {len(cells)} scenario families as ONE batch "
          f"({ROUNDS} rounds, FedGS alpha=1) ...")
    hists = eng.run_batch(cells)

    print(f"\n{'scenario':16s} {'best loss':>10s} {'cohort fill':>11s} "
          f"{'Var(v^T)':>9s} {'gini':>6s}")
    for label, sh in zip(labels, hists):
        # participation proxy: how full the M-slot cohort ran on average
        fill = sh.counts.sum() / (ROUNDS * eng.cfg.m)
        print(f"{label:16s} {sh.best_loss:10.4f} {fill:11.3f} "
              f"{count_variance(sh.counts):9.2f} {gini(sh.counts):6.3f}")
    for label, sh in zip(labels, hists):
        print(json.dumps({"run": label,
                          "sets": [sh.sampled(t).tolist()
                                   for t in range(ROUNDS)],
                          "counts": sh.counts.tolist()}))
    if not all(np.isfinite(sh.best_loss) for sh in hists):
        raise SystemExit("a scenario's best loss is not finite")
    return dict(zip(labels, hists))


if __name__ == "__main__":
    main()
