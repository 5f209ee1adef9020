"""Multi-pod dry-run of the LM stack (the port of ``repro.launch.dryrun``):
every (arch x shape x mesh) planned on the production mesh, its step traced
at full shape, and one device's argument shards allocated on the card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]
    ... --variant <name>     # perf variants (launch/variants.py)
    ... --force              # redo a pair whose record exists

The reference lowers and compiles each pair for 512 fake XLA devices and
reads XLA's memory and cost analyses (and its HLO text, ``utils/hlo.py``).
Torch has no SPMD compiler, so ``run_one`` does three things instead:

(a) **The plan** (no device, no allocation): the config under the variant
    (``specs.variant_for_shape``), the production mesh and its context,
    the params and inputs on the meta device (``specs``) and their specs
    (``steps.make_shardings``).  Each argument's shard on one device
    (``rules.local_shape``) gives ``mem.argument_size_in_bytes``: params,
    AdamW's m/v/t and the batch for train; params and the batch for
    prefill; params, the tokens (replicated) and the cache for decode.
    The learning rate (a host float) and the cache's ``len`` (a host int)
    are no device arguments here.
(b) **The trace**: the step (``steps.make_train_step`` /
    ``make_prefill_step`` / ``make_serve_step``) run once on the meta
    tensors under ``torch.utils.flop_counter.FlopCounterMode``: the global
    step at the reference's full shapes, backward and remat recompute
    included.  Prefill's attention kernel (B9) takes its meta route there,
    and its operations are added by its formula (``window_attention.
    attention_ops``, PERF.md §6) per call, as fedsim counts its kernels.
    ``flops_per_device`` is the global count over the chips, the ideal
    split (no replicated work counted).  The roofline terms use one H100
    SXM's published peaks (``fedsim.PEAK_*``, ``fedsim.HBM_BW``); the
    memory term reads each argument once.  The collective terms have no
    torch meaning (no SPMD partitioner) and say so.  The trace does not
    depend on the mesh (but for ``MOE_GROUPS = -1``, which reads its dp
    size), so pod1 and pod2 share it.
(c) **On the card** (``device="cuda"``): where the plan fits the card's
    free memory, one device's shards are allocated, each leaf at its local
    shape and dtype, and freed.  The allocator's count of requested bytes
    must grow by the plan's bytes exactly, and ``memory_allocated`` by the
    plan after the caching allocator's block rounding
    (:func:`allocator_block_bytes`).  A pair that does not fit is recorded
    ``fits_one_h100: false``, not as a failure.

``utils/hlo.py`` has no counterpart: it reads XLA's HLO text, and (b) takes
its place.  Records go to ``build/dryrun/<arch>__<shape>__<mesh>[__
<variant>].json`` (gitignored).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from pathlib import Path

import torch

from repro_torch.configs.base import INPUT_SHAPES, InputShape
from repro_torch.configs.registry import get_config, list_archs
from repro_torch.launch import steps
from repro_torch.launch.fedsim import HBM_BW, PEAK_BF16_FLOPS, PEAK_F32_FLOPS
from repro_torch.launch.mesh import make_production_mesh, make_shard_ctx
from repro_torch.launch.specs import (abstract_params, input_specs,
                                      variant_for_shape)
from repro_torch.launch.variants import VARIANTS, apply_variant
from repro_torch.models import ffn
from repro_torch.sharding.ctx import use_sharding
from repro_torch.sharding.rules import local_shape

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun"
NO_SPMD = "not measured: no SPMD partitioner in torch"
NO_XLA = "no XLA program: see flops_per_device (FlopCounterMode)"


def model_flops(cfg, shape: InputShape) -> float:
    """MODEL_FLOPS = 6·N_active·D tokens (training) / 2·N_active·D
    (inference)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch        # decode: one token a sequence


# ----------------------------------------------------------------- (a) plan
def _paired(tree, spec, path=()):
    """(dotted key, leaf, spec) over the tensor leaves of ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paired(v, spec[k], path + (k,))
    elif isinstance(tree, torch.Tensor):
        yield ".".join(path), tree, spec


def plan(cfg, shape: InputShape, mesh) -> dict:
    """The step's arguments on the meta device and each device's shards:
    ``leaves`` lists (argument key, local shape, dtype)."""
    ctx = make_shard_ctx(mesh)
    params = abstract_params(cfg)
    inputs = input_specs(cfg, shape)
    args: dict = {"params": params}
    if shape.kind == "train":
        _, optimizer = steps.make_train_step(cfg)
        args["opt"] = optimizer.init(params)
        sh = steps.make_shardings(cfg, shape, ctx, params,
                                  batch_abs=inputs["batch"])
        args["batch"] = inputs["batch"]
    elif shape.kind == "prefill":
        sh = steps.make_shardings(cfg, shape, ctx, params,
                                  batch_abs=inputs["batch"])
        args["batch"] = inputs["batch"]
    else:
        sh = steps.make_shardings(cfg, shape, ctx, params,
                                  cache_abs=inputs["cache"])
        args["tokens"] = inputs["tokens"]
        args["cache"] = inputs["cache"]
        sh["tokens"] = (None,)                 # replicated
    leaves = [(key, local_shape(x.shape, spec, mesh), x.dtype)
              for key, x, spec in _paired(args, sh)]
    nbytes = sum(math.prod(s) * dt.itemsize for _, s, dt in leaves)
    return {"params": params, "inputs": inputs, "leaves": leaves,
            "argument_bytes": nbytes}


# ---------------------------------------------------------------- (b) trace
# (arch, shape, variant, MoE dispatch groups) -> the trace's counts; the
# trace does not depend on the mesh otherwise
_TRACES: dict[tuple, dict] = {}


def trace(cfg, shape: InputShape, params, inputs) -> dict:
    """The step once on the meta tensors under ``FlopCounterMode``: the
    torch ops' count, plus B9's formula per meta call."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels import window_attention as wa
    counter = FlopCounterMode(display=False)
    wa.META_CALLS.clear()
    t0 = time.perf_counter()
    with counter:
        if shape.kind == "train":
            step, optimizer = steps.make_train_step(cfg)
            step(params, optimizer.init(params), inputs["batch"], 1e-4)
        elif shape.kind == "prefill":
            steps.make_prefill_step(cfg)(params, inputs["batch"])
        else:
            steps.make_serve_step(cfg)(params, inputs["tokens"],
                                       inputs["cache"])
    calls = list(wa.META_CALLS)
    wa.META_CALLS.clear()
    kernel = sum(wa.attention_ops(b, s, hq, d, w)
                 for b, s, hq, _, d, w in calls)
    torch_flops = int(counter.get_total_flops())
    return {"torch_flops": torch_flops, "kernel_flops": int(kernel),
            "b9_meta_calls": len(calls), "flops": torch_flops + int(kernel),
            "trace_s": time.perf_counter() - t0}


# ----------------------------------------------------- (c) on the card only
_MIN_BLOCK = 512                  # kMinBlockSize
_SMALL_SIZE = 1 << 20             # kSmallSize: the small pool's requests
_SPLIT_SLACK = 1 << 20            # a large block is split past 1 MiB


def allocator_block_bytes(nbytes: int) -> int:
    """The block PyTorch's CUDA caching allocator hands a request of
    ``nbytes`` (``round_size``): a multiple of 512 bytes, at least 512; 0
    for an empty tensor.  Blocks are split to this size in the small pool
    and under expandable segments; in the large pool of the default
    configuration a block left with at most 1 MiB over stays whole."""
    if nbytes == 0:
        return 0
    return max(_MIN_BLOCK, -(-nbytes // _MIN_BLOCK) * _MIN_BLOCK)


def _expandable_segments() -> bool:
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF", "") + "," + \
        os.environ.get("PYTORCH_ALLOC_CONF", "")
    return "expandable_segments:true" in conf.replace(" ", "").lower()


def allocation_check(leaves, dev: torch.device) -> dict:
    """Allocate one device's shards (each leaf at its local shape and dtype)
    on ``dev`` where they fit its free memory, read the allocator's
    growth, free them.  ``fits_one_h100`` False is a record, not a
    failure."""
    sizes = [math.prod(s) * dt.itemsize for _, s, dt in leaves]
    blocks = [allocator_block_bytes(n) for n in sizes]
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info(dev)
    rec = {"card_free_bytes": free, "card_total_bytes": total,
           "plan_block_bytes": sum(blocks),
           "expandable_segments": _expandable_segments()}
    # headroom for the allocator's segment rounding (2 MiB a large leaf)
    need = sum(blocks) + (2 << 20) * sum(n > _SMALL_SIZE for n in sizes)
    rec["fits_one_h100"] = need <= free
    if not rec["fits_one_h100"]:
        return rec
    stats0 = torch.cuda.memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    held = [torch.empty(s, dtype=dt, device=dev) for _, s, dt in leaves]
    torch.cuda.synchronize(dev)
    rec["alloc_s"] = time.perf_counter() - t0
    grew = torch.cuda.memory_allocated(dev) - base
    requested = torch.cuda.memory_stats(dev).get(
        "requested_bytes.all.current", 0) - \
        stats0.get("requested_bytes.all.current", 0)
    del held
    torch.cuda.empty_cache()
    slack = _SPLIT_SLACK * sum(b > _SMALL_SIZE for b in blocks)
    rec.update(allocated_growth_bytes=grew, requested_growth_bytes=requested,
               unsplit_bytes=grew - sum(blocks))
    if rec["expandable_segments"]:
        rec["alloc_ok"] = grew == sum(blocks) and requested == sum(sizes)
    else:
        rec["alloc_ok"] = (sum(blocks) <= grew <= sum(blocks) + slack
                           and requested == sum(sizes))
    return rec


# ------------------------------------------------------------------ run_one
def record_key(arch: str, shape_name: str, *, multi_pod: bool = False,
               variant: str = "baseline") -> str:
    key = f"{arch}__{shape_name}__{'pod2' if multi_pod else 'pod1'}"
    return key if variant == "baseline" else f"{key}__{variant}"


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            variant: str = "baseline", force: bool = False, device=None,
            results_dir: Path | None = None) -> dict:
    """Plan, trace and (on the card) allocate one pair; the record goes to
    ``results_dir/<key>.json`` and an existing one is returned unless
    ``force``.  A failure is recorded (``ok`` False, the traceback)."""
    from repro_torch import resolve_device
    results_dir = Path(results_dir) if results_dir is not None \
        else RESULTS_DIR
    key = record_key(arch, shape_name, multi_pod=multi_pod, variant=variant)
    out_path = results_dir / f"{key}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "pod2" if multi_pod else "pod1", "variant": variant,
           "kind": shape.kind, "ok": False}
    t0 = time.time()
    try:
        dev = resolve_device(device, who="dryrun")
        rec["device"] = torch.cuda.get_device_name(dev) \
            if dev.type == "cuda" else dev.type
        with apply_variant(variant):
            # the config inside the variant: some variants transform it
            cfg = variant_for_shape(get_config(arch), shape)
            rec.update(params=cfg.param_count(),
                       active_params=cfg.active_param_count(),
                       model_flops=model_flops(cfg, shape))
            mesh = make_production_mesh(multi_pod=multi_pod)
            with use_sharding(make_shard_ctx(mesh)) as ctx:
                p = plan(cfg, shape, mesh)
                rec["lower_s"] = round(time.time() - t0, 2)
                groups = ctx.dp_size if ffn.MOE_GROUPS == -1 else \
                    ffn.MOE_GROUPS
                tkey = (arch, shape_name, variant,
                        groups if cfg.moe is not None else None)
                if tkey not in _TRACES:
                    _TRACES[tkey] = trace(cfg, shape, p["params"],
                                          p["inputs"])
                tr = _TRACES[tkey]
        rec["compile_s"] = "not measured: torch compiles no program ahead"
        rec["xla_flops_raw"] = NO_XLA
        rec["xla_bytes_raw"] = NO_XLA
        rec["mem"] = {
            "argument_size_in_bytes": p["argument_bytes"],
            "output_size_in_bytes": "not measured: no compiled program",
            "temp_size_in_bytes": "not measured: no compiled program"}
        rec["arguments"] = len(p["leaves"])
        chips = mesh.size
        rec["chips"] = chips
        rec.update(torch_flops=tr["torch_flops"],
                   kernel_flops=tr["kernel_flops"],
                   b9_meta_calls=tr["b9_meta_calls"],
                   trace_s=tr["trace_s"])
        rec["flops_per_device"] = tr["flops"] / chips
        rec["bytes_per_device"] = p["argument_bytes"]
        rec["collectives"] = NO_SPMD
        rec["collective_bytes_per_device"] = NO_SPMD
        peak = PEAK_BF16_FLOPS if cfg.dtype == "bfloat16" else PEAK_F32_FLOPS
        rec["compute_term_s"] = rec["flops_per_device"] / peak
        rec["memory_term_s"] = rec["bytes_per_device"] / HBM_BW
        rec["collective_term_s"] = NO_SPMD
        terms = {"compute": rec["compute_term_s"],
                 "memory": rec["memory_term_s"]}
        rec["dominant"] = max(terms, key=terms.get)
        rec["useful_flop_ratio"] = rec["model_flops"] / max(tr["flops"], 1)
        if dev.type == "cuda":
            rec["alloc"] = allocation_check(p["leaves"], dev)
            rec["fits_one_h100"] = rec["alloc"]["fits_one_h100"]
            ok = rec["alloc"].get("alloc_ok", True)
        else:
            rec["fits_one_h100"] = "not measured (CPU)"
            ok = True
        rec["ok"] = bool(ok and tr["flops"] > 0)
        if not ok:
            rec["error"] = f"allocation differs from the plan: {rec['alloc']}"
    except Exception as e:  # recorded for triage, not hidden
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 2)
    results_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    status = "ok" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun] {key}: {status}  ({rec['total_s']}s)", flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which also allocates "
                         "each pair's shards; 'cpu' plans and traces only)")
    args = ap.parse_args(argv)
    if args.device in (None, "cuda") and not torch.cuda.is_initialized():
        # every block split to its size: the allocation check is exact
        os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                              "expandable_segments:True")
    if args.all:
        combos = [(a, s) for a in list_archs() for s in INPUT_SHAPES]
    elif args.arch and args.shape:
        combos = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")
    n_fail = 0
    for arch, shape in combos:
        rec = run_one(arch, shape, multi_pod=args.multi_pod,
                      variant=args.variant, force=args.force,
                      device=args.device)
        n_fail += 0 if rec["ok"] else 1
    print(f"[dryrun] done; {len(combos) - n_fail}/{len(combos)} ok")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
