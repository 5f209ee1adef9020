"""Serving entry points (the port of ``repro.launch.serve``): the LM decode
path and the federated-simulation service.

LM path — prefill a batch of prompts, then decode tokens:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
        --reduced --device cpu

Every family of the model zoo serves (``--arch``: smollm-135m,
granite-moe-1b-a400m, mamba2-780m, hymba-1.5b, llava-next-mistral-7b,
seamless-m4t-large-v2, ...).  Weights are random, drawn from ``--seed``
(``lm.init_params``; ``--draw device`` draws them on the card); the prompts
are ``np.random.default_rng(seed)`` tokens, then the VLM's image
embeddings and the audio family's frames from the same generator, the
reference's own draws, so both packages serve the same request.  The
cache is allocated at image prefix + prompt + gen slots up front (the
reference pads it after prefill; the function is the same).  Greedy decoding takes the first maximum, as ``jnp.argmax``
does; temperature sampling draws from a ``torch.Generator`` and matches the
reference only in distribution.  ``--device`` defaults to CUDA and raises
without it.

Federated-simulation path — a ``SimService`` over ONE ``ScanEngine``:
sweep-cell requests (mixed samplers / availability processes /
aggregators) run as one batch, and per-round metrics stream back segment
by segment through the engine's ``run_batch_stream``:

    PYTHONPATH=src python -m repro_torch.launch.serve --fedsim --cells 4 \\
        --rounds 24 --segment 8 [--device cpu] [--telemetry]

``--compile-cache-dir`` has no torch meaning (the kernel libraries persist
under ``build/``) and raises away from its default.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config
from repro_torch.launch.obs_cli import (add_observability_args,
                                        finish_observability,
                                        make_observability)
from repro_torch.models import lm


# ------------------------------------------------- simulation-as-a-service
@dataclass
class SegmentUpdate:
    """One streamed per-request slice of a segment."""
    request: int               # submit() ticket
    t0: int                    # first round of the segment
    rounds: int                # segment length
    val_loss: np.ndarray       # (rounds,) — NaN off the eval cadence
    val_acc: np.ndarray        # (rounds,)
    sel: np.ndarray            # (rounds, M) sampled sets (padded)
    valid: np.ndarray          # (rounds, M)
    metrics: dict | None = None   # per-round telemetry slice
    #                               (ScanConfig.telemetry only)


class SimService:
    """Queue sweep-cell requests, run them as ONE batch, stream
    per-segment metrics back as they land.

    The service owns one ``ScanEngine``, whose plan cache keeps the
    batches' plans across ``drain()`` calls.  ``submit`` takes whatever
    ``ScanEngine.cell`` does.  Per-request latencies land in
    ``self.timings`` — ``first_segment_s`` (submit -> first streamed
    segment) and ``complete_s`` (submit -> reassembled history) — and on
    the returned ``ScanHistory`` as ``.request_timing``; ``metrics_text()``
    renders the service counters and the engine's runtime snapshot as a
    Prometheus text exposition."""

    def __init__(self, engine):
        self.engine = engine
        self._pending: list[tuple[int, dict]] = []
        self._next = 0
        self.histories: dict[int, object] = {}   # request -> ScanHistory
        self.timings: dict[int, dict] = {}       # request -> latency dict
        self._counters = {"requests_total": 0, "drains_total": 0,
                          "segments_streamed_total": 0,
                          "updates_streamed_total": 0,
                          "rounds_streamed_total": 0,
                          "drain_busy_seconds_total": 0.0}

    def submit(self, **cell_kwargs) -> int:
        """Queue one sweep-cell request; returns its ticket."""
        rid = self._next
        self._next += 1
        self._pending.append((rid, self.engine.cell(**cell_kwargs)))
        self.timings[rid] = {"submit_time": time.time()}
        self._counters["requests_total"] += 1
        return rid

    def _segment_metrics(self, t0: int, j: int) -> dict | None:
        """This segment's per-request telemetry slice, if the engine just
        kept one (telemetry-off runs stream ``None``)."""
        parts = getattr(self.engine, "_tel_parts", None)
        if parts and parts[-1][0] == t0:
            return {k: v[j] for k, v in parts[-1][2].items()}
        return None

    def drain(self, *, segment: int = 0, ckpt_path=None, resume=False):
        """Run every pending request as one batch, yielding a
        ``SegmentUpdate`` per (request, segment) as soon as that segment's
        trajectory lands on the host.  ``segment=0`` runs the whole horizon
        as one segment.  The final ``ScanHistory`` objects land in
        ``self.histories``."""
        if not self._pending:
            return
        ids = [rid for rid, _ in self._pending]
        cells = [c for _, c in self._pending]
        self._pending = []
        t_start = time.time()
        self._counters["drains_total"] += 1
        parts = []
        for t0, k, traj in self.engine.run_batch_stream(
                cells, ckpt_every=segment, ckpt_path=ckpt_path,
                resume=resume):
            parts.append(traj)
            self._counters["segments_streamed_total"] += 1
            self._counters["rounds_streamed_total"] += k * len(ids)
            now = time.time()
            for j, rid in enumerate(ids):
                self.timings[rid].setdefault(
                    "first_segment_s",
                    now - self.timings[rid]["submit_time"])
                self._counters["updates_streamed_total"] += 1
                yield SegmentUpdate(
                    request=rid, t0=t0, rounds=k,
                    val_loss=traj["val_loss"][j], val_acc=traj["val_acc"][j],
                    sel=traj["sel"][j], valid=traj["valid"][j],
                    metrics=self._segment_metrics(t0, j))
        full = {key: np.concatenate([p[key] for p in parts], axis=1)
                for key in parts[0]}
        hists = self.engine._histories(cells, full,
                                       self.engine._assemble_telemetry())
        done = time.time()
        self._counters["drain_busy_seconds_total"] += done - t_start
        for rid, hist in zip(ids, hists):
            self.timings[rid]["complete_s"] = \
                done - self.timings[rid]["submit_time"]
            hist.request_timing = dict(self.timings[rid])
            self.histories[rid] = hist
            if self.engine.sink is not None:
                self.engine.sink.emit(
                    "request", {"request": rid, **self.timings[rid]})

    def stats(self) -> dict:
        """Service counters merged over the engine's runtime snapshot
        (plan-cache / checkpoint-writer / span counters)."""
        return {**self.engine.runtime_stats(), "service": dict(self._counters)}

    def metrics_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the service
        counters, per-request latencies and the engine's runtime
        counters."""
        from repro_torch.obs import render_prometheus
        eng = self.engine.runtime_stats()
        wall = max(self._counters["drain_busy_seconds_total"], 1e-9)
        fams = {
            "requests_total": {
                "type": "counter", "help": "Sweep-cell requests submitted.",
                "samples": [({}, self._counters["requests_total"])]},
            "segments_streamed_total": {
                "type": "counter", "help": "Scan segments streamed.",
                "samples": [({},
                             self._counters["segments_streamed_total"])]},
            "rounds_streamed_total": {
                "type": "counter",
                "help": "Cell-rounds streamed to clients.",
                "samples": [({}, self._counters["rounds_streamed_total"])]},
            "rounds_per_second": {
                "type": "gauge",
                "help": "Cell-rounds per busy drain second.",
                "samples": [({}, self._counters["rounds_streamed_total"]
                             / wall)]},
            "program_cache_hit_rate": {
                "type": "gauge",
                "help": "Plan cache hits / (hits + misses).",
                "samples": [({}, eng["hits"] / max(
                    eng["hits"] + eng["misses"], 1))]},
            "compile_ms_total": {
                "type": "counter",
                "help": "Kernel-library build and load wall-clock (ms).",
                "samples": [({}, eng["compile_ms"])]},
            "request_queue_seconds": {
                "type": "gauge",
                "help": "submit -> first streamed segment latency.",
                "samples": [({"request": str(r)}, tm["first_segment_s"])
                            for r, tm in sorted(self.timings.items())
                            if "first_segment_s" in tm]},
            "request_complete_seconds": {
                "type": "gauge",
                "help": "submit -> reassembled history latency.",
                "samples": [({"request": str(r)}, tm["complete_s"])
                            for r, tm in sorted(self.timings.items())
                            if "complete_s" in tm]},
        }
        return render_prometheus(fams)


def _fedsim_main(args):
    from repro_torch.core.availability_device import make_process
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine

    ds = make_synthetic(n_clients=args.n_clients, alpha=0.5, beta=0.5,
                        seed=args.seed)
    cfg = ScanConfig(rounds=args.rounds, m=4, local_steps=2, batch_size=8,
                     eval_every=1, sampler="uniform",
                     compile_cache_dir=args.compile_cache_dir,
                     telemetry=bool(args.telemetry))
    tracer, sink = make_observability(args)
    try:
        svc = SimService(ScanEngine(ds, logistic_regression(), cfg,
                                    device=args.device, tracer=tracer,
                                    sink=sink))
        scenarios = ("GE", "CLUSTER", "DRIFT", "DEADLINE")
        tickets = [svc.submit(
            seed=i, avail_seed=100 + i,
            process=make_process(scenarios[i % 4], n_clients=ds.n_clients,
                                 data_sizes=ds.sizes,
                                 label_sets=ds.label_sets(),
                                 num_labels=ds.num_classes,
                                 rounds=args.rounds, seed=7 + i))
            for i in range(args.cells)]
        t0 = time.time()
        n_updates = 0
        for upd in svc.drain(segment=args.segment):
            n_updates += 1
            loss = upd.val_loss[np.isfinite(upd.val_loss)]
            print(f"req {upd.request} rounds "
                  f"[{upd.t0}, {upd.t0 + upd.rounds}) "
                  f"loss {loss[-1]:.4f}" if loss.size else
                  f"req {upd.request} rounds "
                  f"[{upd.t0}, {upd.t0 + upd.rounds})")
        wall = time.time() - t0
        st = svc.stats()
        print(f"fedsim: {len(tickets)} cells x {args.rounds} rounds, "
              f"{n_updates} streamed updates in {wall:.2f}s "
              f"({len(tickets) * args.rounds / max(wall, 1e-9):.1f} "
              f"cell-rounds/s)")
        print(f"plans: {st['misses']} built, {st['hits']} cache hits; "
              f"kernel libraries: {st['compiles']} built or loaded "
              f"({st['compile_ms']:.0f} ms)")
        print(svc.metrics_text(), end="")
    finally:
        trace = finish_observability(tracer, sink, args)
        if trace:
            print(f"trace: {trace}")
    return [svc.histories[t] for t in tickets]


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
             temperature: float = 0.0, seed: int = 0,
             inputs: dict | None = None):
    """Prefill ``tokens`` (B, P) and decode ``gen`` tokens in all (the first
    from prefill's logits).  ``inputs``: the family's other prefill inputs
    (the VLM's ``image_emb``, the audio family's ``audio_frames``); the
    cache holds the image prefix, the prompt and the generated tokens.
    Returns (tokens (B, gen) int64 on the device, {"prefill_s",
    "decode_s"} by the host clock around synced work)."""
    dev = tokens.device
    batch = {"tokens": tokens, **(inputs or {})}
    prefix = batch["image_emb"].shape[1] \
        if cfg.family == "vlm" and "image_emb" in batch else 0
    sampler = torch.Generator(device=dev).manual_seed(seed)
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = lm.prefill(params, cfg, batch,
                               max_len=prefix + tokens.shape[1] + gen)
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


def prompt_inputs(cfg, batch: int, prompt_len: int, seed: int, dev,
                  frames: int | None = None):
    """The reference's request: ``np.random.default_rng(seed)`` tokens,
    then from the same generator the VLM's image embeddings (B,
    n_image_tokens, d) and the audio family's frames (B, frames, d;
    ``cfg.n_audio_frames`` by default), N(0, 0.02²) in ``cfg.dtype``, so
    both packages get the same bits.  Returns (tokens (B, P) int64, the
    other prefill inputs)."""
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                          (batch, prompt_len)),
                             dtype=torch.int64, device=dev)
    dtype = lm.torch_dtype(cfg.dtype)
    inputs = {}
    if cfg.family == "vlm" and cfg.n_image_tokens:
        inputs["image_emb"] = torch.as_tensor(rng.normal(
            0, 0.02, (batch, cfg.n_image_tokens, cfg.d_model))).to(dtype)
    if cfg.enc_dec:
        inputs["audio_frames"] = torch.as_tensor(rng.normal(
            0, 0.02, (batch, cfg.n_audio_frames if frames is None
                      else frames, cfg.d_model))).to(dtype)
    return tokens, {k: v.to(dev) for k, v in inputs.items()}


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
    ap.add_argument("--draw", choices=("host", "device"), default="host",
                    help="where the random weights are drawn: host (the "
                         "same weights on every device) or device (its own "
                         "generator: seconds, not minutes, at billions of "
                         "parameters)")
    # federated-simulation service mode (SimService over one ScanEngine)
    ap.add_argument("--fedsim", action="store_true",
                    help="serve federated sweep cells instead of LM decode")
    ap.add_argument("--cells", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=24)
    ap.add_argument("--segment", type=int, default=8,
                    help="streaming segment length (0 = one segment)")
    ap.add_argument("--n-clients", type=int, default=16)
    ap.add_argument("--compile-cache-dir", default=None,
                    help="no torch meaning (the kernel libraries persist "
                         "under build/): raises unless left unset")
    ap.add_argument("--telemetry", action="store_true",
                    help="per-round health metrics (ScanConfig.telemetry)")
    add_observability_args(ap)
    args = ap.parse_args(argv)
    if args.fedsim:
        return _fedsim_main(args)
    if args.gen < 1:
        raise ValueError(f"--gen must be >= 1, got {args.gen}")

    dev = resolve_device(args.device, who="repro_torch.launch.serve")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = lm.init_params(cfg, seed=args.seed, device=dev,
                            draw=args.draw)
    tokens, inputs = prompt_inputs(cfg, args.batch, args.prompt_len,
                                   args.seed, dev)
    out, t = generate(params, cfg, tokens, gen=args.gen,
                      temperature=args.temperature, seed=args.seed,
                      inputs=inputs)
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
