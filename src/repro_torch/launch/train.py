"""Federated LM training (the port of ``repro.launch.train``): the paper's
Algorithm 1 driving the model zoo.

Each federated client owns a distinct Markov-chain token stream (the LM
analogue of label skew); FedGS builds the 3DG from client unigram
statistics (the oracle 3DG, through the staged kernels), samples clients
under an availability mode, the selected clients run E local AdamW steps
one after another, and the server applies any aggregator family
(``--aggregator``: Eq. 18 FedAvg, server momentum, FedAdam,
proximal-weighted, the memory-rectified reduction over the (N, P) panel,
median, trimmed mean, Krum), optionally after a fault family
(``--fault``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --reduced --rounds 20 --clients 16 --mode LN --sampler fedgs \\
        --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
        --rounds 5 --clients 16 --mode SLN --aggregator memory

``--reduced`` uses the 2-layer smoke variant (f32); without it the full
config is built (bf16).  Every family trains but the audio one, whose
encoder needs frames the token streams do not have (it raises, naming
``audio_frames``); the VLM trains on text alone, as the reference's does.  ``--device`` defaults to CUDA and raises without
it.  The reference's ``--solver-backend`` / ``--agg-backend`` are not
offered: the tensors' device picks the kernel or its plain version.

The reference draws each local step's batch rows with ``jax.random`` on a
key chain; here they come from a generator on the device keyed by (seed,
round, client slot), so a resumed run draws what the unbroken run drew.
``main`` takes the seams ``init_params`` (a params dict, e.g. the
reference's weights through ``convert.lm_params_from_jax``) and
``batch_indices(t, slot, client) -> (E, B)`` rows, so a run can replay the
reference's draws; ``on_round(info)`` sees each round's decisions.
``--ckpt`` saves params, counts and the round every 10 rounds in the
reference's file layout and resumes from it; the availability and
sampler streams are replayed up to the resumed round, so with a stateless
server family and fault the resumed run is the unbroken one.
"""
from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.core import graph as graph_mod
from repro_torch.core.availability import ProcessMode, make_mode
from repro_torch.core.availability_device import (ALL_SCENARIOS,
                                                  make_process,
                                                  stream_generator)
from repro_torch.core.fairness import count_variance
from repro_torch.core.sampler import FedGSSampler, make_sampler
from repro_torch.data.lm_stream import token_batches
from repro_torch.fed.aggregator_device import FAMILIES as AGGREGATORS
from repro_torch.fed.aggregator_device import make_aggregator_process
from repro_torch.fed.faults_device import FAMILIES as FAULTS
from repro_torch.fed.faults_device import HostFaultInjector, make_fault_process
from repro_torch.fed.server import ServerAggregator
from repro_torch.fed.telemetry import NULL_TRACER
from repro_torch.launch.obs_cli import (add_observability_args,
                                        finish_observability,
                                        make_observability)
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import lm
from repro_torch.optim.optimizers import adamw

CKPT_EVERY = 10
# the batch rows' salt in their SeedSequence entropy (seed, t, slot, salt),
# apart from the port's other default streams keyed by (seed, t, ...)
_BATCH_STREAM = 0x7A17


def client_unigrams(tokens: np.ndarray, vocab: int) -> np.ndarray:
    """(N, n_seq, S+1) -> (N, vocab) normalized unigram histograms: the
    label-distribution analogue used as oracle 3DG features."""
    n = tokens.shape[0]
    out = np.zeros((n, vocab), np.float64)
    for k in range(n):
        out[k] = np.bincount(tokens[k].reshape(-1), minlength=vocab)
    return out / np.maximum(out.sum(1, keepdims=True), 1)


def default_batch_indices(seed: int, t: int, slot: int, n_seq: int,
                          steps: int, batch: int, device) -> torch.Tensor:
    """(E, B) int64 rows of a client's pool for round t's slot ``slot``,
    uniform in [0, n_seq), from a generator on ``device`` keyed by (seed,
    t, slot)."""
    gen = stream_generator((seed, t, slot, _BATCH_STREAM), device)
    return torch.randint(0, n_seq, (steps, batch), generator=gen,
                         device=device)


def _batch(seqs: torch.Tensor, rows: torch.Tensor) -> dict:
    b = seqs[rows]
    return {"tokens": b[:, :-1], "labels": b[:, 1:]}


def local_train(params: dict, cfg, opt, seqs: torch.Tensor, lr: float,
                idx: torch.Tensor):
    """E local steps of ``opt`` on one client's pool ``seqs`` (n_seq, S+1),
    step e on the rows ``idx[e]`` (``idx`` (E, B)), from a fresh optimizer
    state, without remat.  Returns (params, mean of the E losses)."""
    p, state = params, opt.init(params)
    losses = []
    for rows in idx:
        loss, g = value_and_grad(
            lambda q, b: lm.train_loss(q, cfg, b, remat=False), p,
            _batch(seqs, rows))
        with torch.no_grad():
            p, state = opt.update(g, state, p, lr)
        losses.append(loss)
    return p, torch.mean(torch.stack(losses))


def eval_loss(params: dict, cfg, seqs: torch.Tensor) -> torch.Tensor:
    """The loss over the (N, S+1) held-out sequences."""
    with torch.no_grad():
        return lm.train_loss(params, cfg, {"tokens": seqs[:, :-1],
                                           "labels": seqs[:, 1:]},
                             remat=False)


def nested(params: dict) -> dict:
    """The dotted-key params dict as the reference's nested pytree (the
    checkpoint's layout)."""
    out: dict = {}
    for key, t in params.items():
        *parts, last = key.split(".")
        node = out
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = t
    return out


def flattened(tree: dict, prefix: str = "") -> dict:
    """The inverse of :func:`nested`."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flattened(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--sample-frac", type=float, default=0.25)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--mode", default="LN",
                    help="Table-1 availability mode (IDL/MDF/LDF/YMF/YC/LN/"
                         "SLN) or a stateful scenario family "
                         "(GE/CLUSTER/DRIFT/DEADLINE)")
    ap.add_argument("--sampler", default="fedgs")
    ap.add_argument("--alpha", type=float, default=1.0)
    ap.add_argument("--aggregator", default="fedavg", choices=AGGREGATORS,
                    help="server-update family (fed/aggregator_device.py)")
    ap.add_argument("--fault", default="none", choices=FAULTS,
                    help="Byzantine/straggler fault family injected between "
                         "local training and aggregation; pair with a "
                         "robust --aggregator (median/trimmed_mean/krum)")
    ap.add_argument("--byzantine-frac", type=float, default=0.0,
                    help="fraction of clients made adversarial (ceil(frac*N) "
                         "by a seeded permutation; identity fixed per seed)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint path: saves params+counts every 10 "
                         "rounds and resumes if present")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    add_observability_args(ap)
    return ap


def parse_args(argv=None) -> argparse.Namespace:
    return _parser().parse_args(argv)


@dataclass
class Setup:
    """What a run builds before its first round: the config, the client
    pools (numpy, and on the device without the held-out sequence), the
    held-out sequences ``val``, the sampler (with the oracle 3DG installed
    for FedGS) and the availability mode."""
    cfg: object
    dev: torch.device
    n: int
    m: int
    pools: np.ndarray
    sizes: np.ndarray
    feats: np.ndarray
    sampler: object
    mode: object
    pools_t: torch.Tensor
    val: torch.Tensor


def setup(args: argparse.Namespace) -> Setup:
    dev = resolve_device(args.device, who="repro_torch.launch.train")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lm.check_family(cfg)
    if cfg.enc_dec:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder: its loss needs the batch's "
            f"audio_frames, which the clients' token streams do not carry "
            f"(repro.launch.train cannot train it either)")
    n, m = args.clients, max(1, int(round(args.sample_frac * args.clients)))
    vocab = min(cfg.vocab_size, 512)

    # ---- per-client token pools + oracle 3DG ------------------------------
    pools = token_batches(vocab, n, tokens_per_client=args.batch *
                          (args.seq + 1) * 8, seq_len=args.seq,
                          seed=args.seed)
    sizes = np.full(n, pools.shape[1], np.float64)
    feats = client_unigrams(pools, vocab)

    sampler = make_sampler(args.sampler, alpha=args.alpha, device=dev) \
        if args.sampler == "fedgs" else make_sampler(args.sampler)
    if isinstance(sampler, FedGSSampler):
        _, _, h = graph_mod.build_3dg(feats, eps=0.1, sigma2=0.01, device=dev)
        sampler.set_graph(h)
    if args.mode.upper() in ALL_SCENARIOS:
        mode = ProcessMode(make_process(args.mode, n_clients=n,
                                        data_sizes=sizes, rounds=args.rounds,
                                        seed=args.seed),
                           avail_seed=args.seed + 1234)
    else:
        mode = make_mode(args.mode, n_clients=n, data_sizes=sizes,
                         label_sets=[set(np.argsort(-feats[k])[:3].tolist())
                                     for k in range(n)],
                         num_labels=vocab)
    return Setup(cfg, dev, n, m, pools, sizes, feats, sampler, mode,
                 torch.as_tensor(pools[:, :-1], dtype=torch.int64,
                                 device=dev),
                 torch.as_tensor(pools[:, -1], dtype=torch.int64,
                                 device=dev))


def train_round(s: Setup, args, params: dict, server, faults, t: int,
                sel: np.ndarray, avail: np.ndarray, *, batch_indices=None,
                tracer=NULL_TRACER) -> dict:
    """One round on the selected clients ``sel`` (non-empty): E local
    AdamW steps each (a fresh optimizer per client), the fault family,
    the server update and the eval.  Returns the new ``params``, the
    ``stacked`` updates as aggregated, the clients' mean ``losses``,
    ``val_loss`` and the phases' seconds (host clock around synced
    work: ``train_s``, ``aggregate_s``, ``eval_s``)."""
    opt = adamw()
    n_seq = s.pools_t.shape[1]
    locals_, losses = [], []
    _sync(s.dev)
    t_train = time.perf_counter()
    with tracer.span("local_train", t=t, m=len(sel)):
        for j, k in enumerate(sel):
            idx = (default_batch_indices(args.seed, t, j, n_seq,
                                         args.local_steps, args.batch, s.dev)
                   if batch_indices is None else
                   torch.as_tensor(np.asarray(batch_indices(t, j, k)),
                                   dtype=torch.int64, device=s.dev))
            pk, lk = local_train(params, s.cfg, opt, s.pools_t[k], args.lr,
                                 idx)
            locals_.append(pk)
            losses.append(float(lk))
    t_agg = time.perf_counter()
    stacked = {key: torch.stack([p[key] for p in locals_]) for key in params}
    del locals_
    if faults is not None:
        stacked = faults.inject(stacked, params, sel, avail, t)
    with tracer.span("aggregate", t=t):
        params = server.apply(stacked, s.sizes[sel].astype(np.float32), sel,
                              avail, t)
        _sync(s.dev)
    t_eval = time.perf_counter()
    with tracer.span("eval", t=t):
        vl = float(eval_loss(params, s.cfg, s.val))
    return {"params": params, "stacked": stacked, "losses": losses,
            "val_loss": vl, "train_s": t_agg - t_train,
            "aggregate_s": t_eval - t_agg,
            "eval_s": time.perf_counter() - t_eval}


def main(argv=None, *, init_params: dict | None = None, batch_indices=None,
         on_round=None):
    """Run the federated training.  Returns (params, counts).

    ``init_params``: the initial params dict (default ``lm.init_params``
    from ``--seed``), moved to the device.  ``batch_indices(t, slot,
    client)``: the (E, B) pool rows of round t's ``slot``-th selected
    client (default :func:`default_batch_indices`).  ``on_round(info)``:
    called after each round with :func:`train_round`'s dict, the round's
    decisions (``t``, ``avail``, ``sel``, ``counts`` before the round's
    update), the :class:`Setup` and the ``server`` and ``faults``, whose
    state is then the next round's."""
    args = parse_args(argv)
    s = setup(args)
    tracer, sink = make_observability(args, run=f"train-{args.arch}")
    n, m, sizes, sampler, mode = s.n, s.m, s.sizes, s.sampler, s.mode

    # ---- model + server --------------------------------------------------
    if init_params is None:
        params = lm.init_params(s.cfg, seed=args.seed, device=s.dev)
    else:
        params = {k: v.to(s.dev) for k, v in init_params.items()}
    rng = np.random.default_rng(args.seed)
    avail_rng = np.random.default_rng(args.seed + 1234)
    counts = np.zeros(n)
    server = ServerAggregator(make_aggregator_process(args.aggregator),
                              n_clients=n, data_sizes=sizes, seed=args.seed)
    start = 0
    if args.ckpt:
        from repro_torch.checkpoint.ckpt import load_checkpoint
        path = args.ckpt if args.ckpt.endswith(".npz") else args.ckpt + ".npz"
        if os.path.exists(path):
            state = load_checkpoint(args.ckpt, like={
                "params": nested(params), "counts": counts,
                "round": np.zeros((), np.int64)})
            params = flattened(state["params"])
            counts = np.asarray(state["counts"], np.float64)
            start = int(state["round"]) + 1
            # replay the host streams up to the resumed round
            for t in range(start):
                avail = mode.sample(t, avail_rng)
                if not isinstance(sampler, FedGSSampler):
                    sampler.sample(avail=avail, m=m, rng=rng, counts=counts,
                                   data_sizes=sizes)
            print(f"resumed from {path} at round {start}")
    server.init(params)
    faults = None
    if args.fault != "none":
        faults = HostFaultInjector(
            make_fault_process(args.fault, n, frac=args.byzantine_frac),
            fault_seed=args.seed + 0xFA17)
        faults.init(params)
    t0 = time.time()
    try:
        for t in range(start, args.rounds):
            avail = mode.sample(t, avail_rng)
            before = counts.copy()
            sel = np.asarray(sampler.sample(avail=avail, m=m, rng=rng,
                                            counts=counts,
                                            data_sizes=sizes), int)
            if len(sel) == 0:
                # an empty A_t: the round keeps the params
                print(f"round {t:3d}  sel=[]  (no clients available; "
                      f"params kept)", flush=True)
                continue
            out = train_round(s, args, params, server, faults, t, sel, avail,
                              batch_indices=batch_indices, tracer=tracer)
            params, vl = out["params"], out["val_loss"]
            train = float(np.mean(out["losses"]))
            counts[sel] += 1
            if sink is not None:
                sink.emit("round", {"engine": "train-lm", "t": t,
                                    "val_loss": vl, "train_loss": train,
                                    "n_selected": int(len(sel)),
                                    "avail_rate": float(np.mean(avail)),
                                    "count_var":
                                    float(count_variance(counts))})
            if on_round is not None:
                on_round({**out, "t": t, "avail": avail, "sel": sel,
                          "counts": before, "setup": s, "server": server,
                          "faults": faults})
            del out
            print(f"round {t:3d}  sel={sel.tolist()}  train={train:.4f}  "
                  f"val={vl:.4f}  Var(v)={count_variance(counts):.3f}",
                  flush=True)
            if args.ckpt and (t + 1) % CKPT_EVERY == 0:
                from repro_torch.checkpoint.ckpt import save_checkpoint
                with tracer.span("checkpoint_write", round=t):
                    save_checkpoint(
                        args.ckpt, {"params": nested(params),
                                    "counts": counts,
                                    "round": np.asarray(t, np.int64)},
                        metadata={"round": t, "arch": s.cfg.name})
    finally:
        trace = finish_observability(tracer, sink, args)
        if trace:
            print(f"trace: {trace}")
    print(f"done in {time.time() - t0:.1f}s; final "
          f"Var(v^t)={count_variance(counts):.3f}")
    return params, counts


if __name__ == "__main__":
    main()
