"""Quickstart: FedGS vs UniformSample on the paper's Synthetic(0.5, 0.5)
dataset under skewed (LogNormal) client availability — the twin of
``examples/quickstart.py`` on the port.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Prints the two methods' loss curves and final sampling-count fairness —
the paper's core claim in miniature — then each run's sets and counts.
"""
import argparse
import json

import numpy as np

from repro_torch.core.availability import make_mode
from repro_torch.core.fairness import count_variance, gini
from repro_torch.core.sampler import FedGSSampler, UniformSampler
from repro_torch.data.synthetic import make_synthetic
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import logistic_regression


def config() -> FLConfig:
    return FLConfig(rounds=40, sample_frac=0.2, local_steps=10,
                    batch_size=10, lr=0.1, eval_every=4, seed=0)


def run(sampler, ds, label, device=None):
    mode = make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)
    eng = FLEngine(ds, logistic_regression(), sampler, mode, config(),
                   device=device)
    if isinstance(sampler, FedGSSampler):
        eng.install_oracle_graph(ds.opt_params)      # 3DG from local optima
    hist = eng.run(progress=lambda t, l, a: print(
        f"  [{label}] round {t:3d}  val_loss={l:.4f}  val_acc={a:.3f}"))
    return hist, eng.counts


def sets_line(label: str, hist, counts) -> str:
    """One JSON line: the run's sampled set every round and its counts."""
    return json.dumps({"run": label,
                       "sets": [[int(k) for k in s] for s in hist.all_sampled],
                       "counts": [float(c) for c in counts]})


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    print(f"Synthetic(0.5, 0.5): {ds.n_clients} clients, "
          f"sizes {ds.sizes.min()}..{ds.sizes.max()}")

    print("\n-- UniformSample (McMahan et al. 2017) --")
    h_u, c_u = run(UniformSampler(), ds, "uniform", args.device)
    print("\n-- FedGS (this paper, alpha=1) --")
    h_g, c_g = run(FedGSSampler(alpha=1.0, device=args.device), ds,
                   "fedgs", args.device)

    print("\n== summary under LogNormal(0.5) availability ==")
    print(f"{'method':15s} {'best loss':>10s} {'Var(v^T)':>10s} {'gini':>6s}")
    print(f"{'UniformSample':15s} {h_u.best_loss:10.4f} "
          f"{count_variance(c_u):10.2f} {gini(c_u):6.3f}")
    print(f"{'FedGS':15s} {h_g.best_loss:10.4f} "
          f"{count_variance(c_g):10.2f} {gini(c_g):6.3f}")
    print(sets_line("uniform", h_u, c_u))
    print(sets_line("fedgs", h_g, c_g))
    if not np.isfinite(h_g.best_loss):
        raise SystemExit("FedGS's best loss is not finite")
    return {"uniform": (h_u, c_u), "fedgs": (h_g, c_g)}


if __name__ == "__main__":
    main()
