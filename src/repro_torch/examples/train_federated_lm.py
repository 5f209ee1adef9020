"""End-to-end training driver: federated LM training (Algorithm 1) over
the model zoo with FedGS sampling — clients own distinct Markov token
streams, the 3DG is built from client unigram statistics.  The twin of
``examples/train_federated_lm.py`` on the port.

Default: ~200 federated training steps (50 rounds x 4 local steps) of the
reduced smollm-135m.  On the card, drop ``--reduced`` for the full width
and raise --seq/--batch.

  PYTHONPATH=src python -m repro_torch.examples.train_federated_lm \\
      --rounds 50 [--device cpu]

Besides the training log it prints one JSON line: the run's sets and
final participation counts.
"""
import json
import sys

from repro_torch.launch import train

DEFAULTS = ["--reduced", "--rounds", "50", "--clients", "16",
            "--sampler", "fedgs", "--mode", "SLN"]


def with_defaults(argv: list) -> list:
    """``argv`` with the defaults filling the flags it lacks (user-given
    flags win)."""
    have = {a for a in argv if a.startswith("--")}
    out = list(argv)
    i = 0
    while i < len(DEFAULTS):
        flag = DEFAULTS[i]
        has_val = i + 1 < len(DEFAULTS) and \
            not DEFAULTS[i + 1].startswith("--")
        if flag not in have:
            out.append(flag)
            if has_val:
                out.append(DEFAULTS[i + 1])
        i += 2 if has_val else 1
    return out


def main(argv=None):
    argv = with_defaults(list(sys.argv[1:] if argv is None else argv))
    sets = []
    params, counts = train.main(
        argv, on_round=lambda info: sets.append([int(k) for k in
                                                 info["sel"]]))
    print(json.dumps({"run": "train_federated_lm", "sets": sets,
                      "counts": [float(c) for c in counts]}))
    return params, counts, sets


if __name__ == "__main__":
    main()
