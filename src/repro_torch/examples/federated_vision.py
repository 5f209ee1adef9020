"""Availability-mode study on the CIFAR10-like federated vision surrogate:
run one method under several availability modes and watch the degradation —
then run FedGS and watch it hold (paper Table 2's phenomenon).  The twin of
``examples/federated_vision.py`` on the port.

  PYTHONPATH=src python -m repro_torch.examples.federated_vision \\
      [--rounds 30] [--clients 50] [--device cpu]
"""
import argparse
import json

from repro_torch.core.availability import make_mode
from repro_torch.core.fairness import count_variance
from repro_torch.core.sampler import FedGSSampler, UniformSampler
from repro_torch.data.vision import make_cifar_like
from repro_torch.fed.engine import FLConfig, FLEngine
from repro_torch.fed.models import small_cnn

MODES = [("IDL", None), ("LN", 0.5), ("MDF", 0.7), ("LDF", 0.7)]
METHODS = [("UniformSample", lambda device: UniformSampler()),
           ("FedGS(a=1)", lambda device: FedGSSampler(alpha=1.0,
                                                      device=device))]


def config(rounds: int) -> FLConfig:
    return FLConfig(rounds=rounds, sample_frac=0.1, local_steps=10,
                    batch_size=32, lr=0.03, eval_every=5, seed=0)


def run_one(ds, sampler_fn, mode_name, beta, rounds, device=None):
    sampler = sampler_fn(device)
    mode = make_mode(mode_name, n_clients=ds.n_clients, data_sizes=ds.sizes,
                     label_sets=ds.label_sets(), num_labels=ds.num_classes,
                     beta=beta, seed=99)
    eng = FLEngine(ds, small_cnn(shape=(8, 8, 3)), sampler, mode,
                   config(rounds), device=device)
    if isinstance(sampler, FedGSSampler):
        eng.install_oracle_graph()          # label-distribution 3DG
    hist = eng.run()
    return hist, eng.counts


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--clients", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA; 'cpu' for the CPU)")
    args = ap.parse_args(argv)

    ds = make_cifar_like(n_clients=args.clients, n_total=4000, seed=0)
    print(f"{'method':16s} " + " ".join(
        f"{m}{'' if b is None else b:}".rjust(10) for m, b in MODES))
    runs, lines = {}, []
    for name, fn in METHODS:
        row = []
        for mode_name, beta in MODES:
            hist, counts = run_one(ds, fn, mode_name, beta, args.rounds,
                                   args.device)
            runs[name, mode_name] = (hist, counts)
            row.append(f"{hist.best_loss:7.4f}/"
                       f"{count_variance(counts):4.0f}".rjust(10))
            lines.append(json.dumps({
                "run": f"{name}/{mode_name}",
                "sets": [[int(k) for k in s] for s in hist.all_sampled],
                "counts": [float(c) for c in counts]}))
        print(f"{name:16s} " + " ".join(row))
    print("(cells: best val loss / final count variance)")
    for line in lines:
        print(line)
    return runs


if __name__ == "__main__":
    main()
