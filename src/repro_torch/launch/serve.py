"""Serve an LM: prefill a batch of prompts, then decode tokens (the port of
``repro.launch.serve``'s LM branch).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --device cpu

Weights are random, drawn from ``--seed`` (``lm.init_params``); the prompts
are ``np.random.default_rng(seed)`` tokens, the reference's own draw, so
both packages serve the same prompts.  The cache is allocated at prompt +
gen slots up front (the reference pads it after prefill; the function is
the same).  Greedy decoding takes the first maximum, as ``jnp.argmax``
does; temperature sampling draws from a ``torch.Generator`` and matches the
reference only in distribution.  ``--device`` defaults to CUDA and raises
without it.  ``--fedsim`` (the federated-simulation service over the batched
engine) raises ``NotImplementedError`` until that engine is ported.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.models import lm


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _next_token(logits: torch.Tensor, temperature: float,
                gen: torch.Generator) -> torch.Tensor:
    if temperature > 0:
        probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0]
    return torch.argmax(logits, dim=-1)


def generate(params, cfg, tokens: torch.Tensor, *, gen: int,
             temperature: float = 0.0, seed: int = 0):
    """Prefill ``tokens`` (B, P) and decode ``gen`` tokens in all (the first
    from prefill's logits).  Returns (tokens (B, gen) int64 on the device,
    {"prefill_s", "decode_s"} by the host clock around synced work)."""
    dev = tokens.device
    sampler = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, {"tokens": tokens},
                               max_len=tokens.shape[1] + gen)
    _sync(dev)
    t_prefill = time.perf_counter() - t0
    toks = _next_token(logits, temperature, sampler)
    out = [toks]
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = lm.decode_step(params, cfg, toks, cache)
        toks = _next_token(logits, temperature, sampler)
        out.append(toks)
    _sync(dev)
    t_decode = time.perf_counter() - t1
    return torch.stack(out, 1), {"prefill_s": t_prefill, "decode_s": t_decode}


def main(argv=None) -> np.ndarray:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, raising without it)")
    ap.add_argument("--fedsim", action="store_true",
                    help="serve federated sweep cells instead of LM decode "
                         "(not ported yet)")
    args = ap.parse_args(argv)
    if args.fedsim:
        raise NotImplementedError(
            "--fedsim serves sweep cells through the batched ScanEngine, "
            "which the port does not have yet")
    if args.gen < 1:
        raise ValueError(f"--gen must be >= 1, got {args.gen}")

    dev = resolve_device(args.device, who="repro_torch.launch.serve")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, seed=args.seed, device=dev)
    rng = np.random.default_rng(args.seed)
    tokens = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len)),
        dtype=torch.int64, device=dev)

    out, t = generate(params, cfg, tokens, gen=args.gen,
                      temperature=args.temperature, seed=args.seed)
    gen = out.cpu().numpy()
    n_tok = gen.size
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} "
          f"gen={args.gen}")
    print(f"prefill: {t['prefill_s']:.3f}s  decode: {t['decode_s']:.3f}s "
          f"({n_tok / max(t['decode_s'], 1e-9):.1f} tok/s)")
    print("first sequence:", gen[0][:16].tolist())
    return gen


if __name__ == "__main__":
    main()
