"""The plan table: per-(N, P, m)-tier winners among each kernel's plans
(the port of ``repro.kernels.autotune``).

A plan that wins at one shape tier can lose at another.  Each kernel of
the port has a few named plans (``floyd_warshall.PLANS``,
``graph_fused.PLANS``, ``solver.ARGMAX_PLANS``, ``solver.SWAP_GAIN_PLANS``,
``aggregate.PLANS``, ``krum.PLANS``) and a heuristic that picks one per
shape.  This module

  1. enumerates, per kernel and shape, the plans that take the shape,
  2. holds each against the kernel's plain version, then times it on the
     card (CUDA events: a warm-up call, then the best of k loops of calls),
  3. persists the winners to the committed ``kernels/tuned_plans.json``,
     keyed ``"<kernel>|<shape tier>|cuda"``, each entry with the card's
     name and power limit.

``resolve()`` is the read path of every default-plan function
(``floyd_warshall_plan``, ``fused_adjacency_plan``, ``masked_argmax_plan``,
``swap_gain_plan``, ``memagg_plan``, ``krum_plan``): the tuned winner
where the table has one for the shape's tier AND that plan takes the
call's shape, the caller's heuristic otherwise — so an empty table
degrades to exactly the heuristic plans.  Tiers are pow2 ceilings
(``n=1500 -> "n2048"``), the reference's.  Each caller resolves once per
shape and keeps the answer in its per-shape dict, so a call's host path
does no table work.  The Q-free swap (B4) has no table key, as in the
reference.

Determinism (pinned by tests): candidate order is fixed, ``pick_best`` is
min-time with first-candidate tie-break, and the JSON is written with
sorted keys — the same timing table in, the same plans out, a
byte-identical file.  Only a run on the card writes the table:

    python -m repro_torch.kernels.autotune [--max-n 4096] [--out PATH]
"""
from __future__ import annotations

import functools
import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

TABLE_PATH = Path(__file__).with_name("tuned_plans.json")
PLATFORM = "cuda"
_RNG_SEED = 0


# ------------------------------------------------------------- tier / table
def _p2(v: int) -> int:
    """Power-of-two ceiling (>= 1)."""
    v = max(1, int(v))
    return 1 << (v - 1).bit_length()


def shape_tier(**dims) -> str:
    """Canonical tier string: pow2 ceiling per dim, keys sorted —
    ``shape_tier(n=1500) == "n2048"``, ``shape_tier(n=100, p=640) ==
    "n128,p1024"``."""
    return ",".join(f"{k}{_p2(v)}" for k, v in sorted(dims.items()))


def tier_range(tier_dim: int) -> tuple[int, int]:
    """The sizes a pow2 tier value covers: (tier/2 + 1, tier), and (1, 1)
    for the tier 1."""
    return (tier_dim // 2 + 1 if tier_dim > 1 else 1, tier_dim)


def table_key(kernel: str, tier: str, platform: str = PLATFORM) -> str:
    return f"{kernel}|{tier}|{platform}"


@functools.lru_cache(maxsize=None)
def _load(path_str: str) -> dict:
    p = Path(path_str)
    if not p.exists():
        return {}
    return json.loads(p.read_text())


def load_table(path=None) -> dict:
    return _load(str(path or TABLE_PATH))


def lookup(kernel: str, *, path=None, **dims) -> dict | None:
    """Tuned plan for (kernel, tier(dims)) on the card, or None."""
    entry = load_table(path).get(table_key(kernel, shape_tier(**dims)))
    return dict(entry["tiles"]) if entry else None


def resolve(kernel: str, defaults: dict, *, takes=None, path=None,
            **dims) -> dict:
    """The default-plan read path: the tuned winner where the table has one
    and ``takes(plan)`` says that plan takes the call's shape, the caller's
    heuristic ``defaults`` otherwise.  Only keys present in ``defaults`` are
    taken from the table (a row can never smuggle an unknown knob into a
    wrapper)."""
    out = dict(defaults)
    tuned = lookup(kernel, path=path, **dims)
    if tuned:
        cand = {k: v for k, v in tuned.items() if k in out}
        if takes is None or takes(cand.get("plan", out.get("plan"))):
            out.update(cand)
    return out


def pick_best(timed):
    """min time; ties keep the EARLIEST candidate (fixed enumeration order)
    so identical timing tables always produce identical winners."""
    best = None
    for plan, ms in timed:
        if best is None or ms < best[1]:
            best = (plan, ms)
    return best


# ----------------------------------------------------- per-kernel harnesses
# Each kernel registers its plans, which of them take a spec's shape, the
# inputs (setup), the kernel with a plan forced (run), its plain version
# (plain) and how the two must agree (check).  Everything is imported
# lazily: the kernel modules import this one.
def _fw_setup(dev, n):
    rng = np.random.default_rng(_RNG_SEED)
    h = (rng.random((n, n)) * 3.0).astype(np.float32)
    h = np.minimum(h, h.T)
    np.fill_diagonal(h, 0.0)
    return (torch.as_tensor(h, device=dev),)


FUSED_D = 16               # the fused adjacency specs' feature width


def call_dims(kernel: str, **dims) -> dict:
    """The full shape of a spec's call (the tier's dims, plus the fused
    adjacency's d and memagg's m that its inputs carry)."""
    if kernel == "fused_3dg":
        return {**dims, "d": FUSED_D}
    if kernel == "memory_aggregate":
        return {**dims, "m": max(8, dims["n"] // 8)}
    return dict(dims)


def _fused_setup(dev, n):
    rng = np.random.default_rng(_RNG_SEED)
    return (torch.as_tensor(
        rng.standard_normal((n, FUSED_D)).astype(np.float32), device=dev),)


def _greedy_setup(dev, n):
    rng = np.random.default_rng(_RNG_SEED)
    f32 = np.float32
    return (torch.as_tensor(rng.standard_normal(n).astype(f32), device=dev),
            torch.as_tensor(rng.standard_normal(n).astype(f32), device=dev),
            torch.as_tensor(rng.random(n) > 0.3, device=dev))


def _swap_setup(dev, m, n):
    rng = np.random.default_rng(_RNG_SEED)
    f32 = np.float32
    return (torch.as_tensor(rng.standard_normal((n, n)).astype(f32),
                            device=dev),
            torch.as_tensor(rng.permutation(n)[:m], device=dev),
            torch.as_tensor(rng.standard_normal(m).astype(f32), device=dev),
            torch.as_tensor(rng.standard_normal(n).astype(f32), device=dev))


def _agg_setup(dev, n, p):
    rng = np.random.default_rng(_RNG_SEED)
    m = call_dims("memory_aggregate", n=n, p=p)["m"]
    f32 = np.float32
    return (torch.as_tensor(rng.standard_normal((n, p)).astype(f32),
                            device=dev),
            torch.as_tensor(rng.standard_normal((m, p)).astype(f32),
                            device=dev),
            torch.as_tensor(rng.permutation(n)[:m], device=dev),
            torch.ones(m, dtype=torch.bool, device=dev),
            torch.as_tensor((rng.random(n).astype(f32)) / n, device=dev))


def _krum_setup(dev, m, p):
    rng = np.random.default_rng(_RNG_SEED)
    return (torch.as_tensor(rng.standard_normal((m, p)).astype(np.float32),
                            device=dev),)


def _fw():
    from repro_torch.kernels import floyd_warshall as fw
    return fw


def _gf():
    from repro_torch.kernels import graph_fused as gf
    return gf


def _sv():
    from repro_torch.kernels import solver as sv
    return sv


def _ag():
    from repro_torch.kernels import aggregate as ag
    return ag


def _kr():
    from repro_torch.kernels import krum as kr
    return kr


def _fused_want(u):
    """What every fused plan must give bitwise: the staged kernels' R (on
    the card), the plain version's [lo, hi]."""
    from repro_torch.kernels import pairwise_similarity as ps
    _, stats = _gf().fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    return ps.adjacency(ps.similarity(u), stats, eps=0.1, sigma2=0.01), stats


def _bitwise(got, want) -> bool:
    return all(torch.equal(a, b) for a, b in zip(got, want))


def _agg_close(got, want) -> bool:
    # memagg's plans sum in their own orders: f32 round-off of the plain
    # tensordot, the bound chip_smoke.py's memagg rows hold them to
    return torch.equal(got[0], want[0]) and torch.allclose(
        got[1], want[1], atol=1e-5, rtol=1e-5)


def _krum_close(got, want) -> bool:
    # a random-walk round-off bound for two length-P f32 sums taken in
    # different orders (tests/test_torch_gpu.py's krum bound)
    x = want[1]
    n2 = torch.sum(x.double() ** 2, dim=1)
    tol = 8.0 * np.sqrt(x.shape[1]) * 2.0 ** -24 * (n2[:, None] + n2[None, :])
    return bool(torch.all((got[0].double() - want[0].double()).abs() <= tol))


def fw_takes(plan: str, n: int) -> bool:
    fw = _fw()
    return plan in fw.PLANS and (plan != "single" or n <= fw.SINGLE_MOST)


def fused_takes(plan: str, n: int, d: int) -> bool:
    gf = _gf()
    return plan in gf.PLANS and plan in gf.fused_adjacency_plans(n, d)


def argmax_takes(plan: str, n: int) -> bool:
    sv = _sv()
    return plan in sv.ARGMAX_PLANS and (plan != "warp" or
                                        n <= sv.ARGMAX_WARP_MOST)


def swap_gain_takes(plan: str, m: int, n: int) -> bool:
    sv = _sv()
    return plan in sv.SWAP_GAIN_PLANS and (
        plan != "small" or m * n <= sv.SWAP_GAIN_SMALL_MOST)


def memagg_takes(plan: str, n: int, p: int, m: int = 1) -> bool:
    return plan in _ag().memagg_plans(n, p, m)


def krum_takes(plan: str, m: int, p: int) -> bool:
    return plan in _kr().PLANS and (plan != "small" or
                                    m * (m + 1) // 2 <= 1 << 26)


KERNELS = {
    "floyd_warshall": dict(
        plans=lambda: _fw().PLANS,
        takes=lambda q, n: fw_takes(q, n),
        setup=_fw_setup,
        run=lambda q, h: (_fw().floyd_warshall_cuda(h, plan=q),),
        plain=lambda h: (_fw().floyd_warshall_plain(h),),
        check=_bitwise),
    "fused_3dg": dict(
        plans=lambda: _gf().PLANS,
        takes=lambda q, n: fused_takes(q, n, FUSED_D),
        setup=_fused_setup,
        run=lambda q, u: _gf().fused_adjacency_cuda(u, eps=0.1, sigma2=0.01,
                                                    plan=q),
        plain=lambda u: _fused_want(u),
        check=_bitwise),
    "greedy_argmax": dict(
        plans=lambda: _sv().ARGMAX_PLANS,
        takes=lambda q, n: argmax_takes(q, n),
        setup=_greedy_setup,
        run=lambda q, d, r, mk: _sv().masked_argmax_cuda(d, r, mk, plan=q),
        plain=lambda d, r, mk: _sv().masked_argmax_plain(d, r, mk),
        check=_bitwise),
    "swap_gain": dict(
        plans=lambda: _sv().SWAP_GAIN_PLANS,
        takes=lambda q, m, n: swap_gain_takes(q, m, n),
        setup=_swap_setup,
        run=lambda q, *a: _sv().swap_gain_cuda(*a, plan=q),
        plain=lambda *a: _sv().swap_gain_plain(*a),
        check=_bitwise),
    "memory_aggregate": dict(
        plans=lambda: _ag().PLANS,
        takes=lambda q, n, p: memagg_takes(q, n, p),
        setup=_agg_setup,
        # on a copy of the panel: the kernel updates it in place
        run=lambda q, mem, *a: _ag().memory_aggregate_cuda(
            mem.clone(), *a, plan=q),
        plain=lambda mem, *a: _ag().memory_scatter_reduce_ref(
            mem.clone(), *a),
        check=_agg_close),
    "krum_pairwise": dict(
        plans=lambda: _kr().PLANS,
        takes=lambda q, m, p: krum_takes(q, m, p),
        setup=_krum_setup,
        run=lambda q, x: (_kr().krum_distances_cuda(x, plan=q),),
        plain=lambda x: (_kr().krum_pairwise_ref(x), x),
        check=_krum_close),
}


def heuristic(kernel: str, **dims) -> str:
    """The plan the kernel's own heuristic picks for a call's shape (the
    fused adjacency's dims are n and d)."""
    if kernel == "floyd_warshall":
        return _fw().floyd_warshall_heuristic(dims["n"])
    if kernel == "fused_3dg":
        return _gf().fused_adjacency_heuristic(dims["n"], dims["d"])
    if kernel == "greedy_argmax":
        return _sv().masked_argmax_heuristic(dims["n"])
    if kernel == "swap_gain":
        return _sv().swap_gain_heuristic(dims["m"], dims["n"])
    if kernel == "memory_aggregate":
        return _ag().memagg_heuristic(dims["n"], dims["p"], dims.get("m", 1))
    return _kr().krum_heuristic(dims["m"], dims["p"])


def default_plan(kernel: str, **dims) -> str:
    """The plan the kernel's wrapper takes with ``plan=None`` at a call's
    shape: its default-plan function, which reads the table."""
    if kernel == "floyd_warshall":
        return _fw().floyd_warshall_plan(dims["n"])
    if kernel == "fused_3dg":
        return _gf().fused_adjacency_plan(dims["n"], dims["d"])
    if kernel == "greedy_argmax":
        return _sv().masked_argmax_plan(dims["n"])
    if kernel == "swap_gain":
        return _sv().swap_gain_plan(dims["m"], dims["n"])
    if kernel == "memory_aggregate":
        return _ag().memagg_plan(dims["n"], dims["p"], dims.get("m", 1))
    return _kr().krum_plan(dims["m"], dims["p"])


def candidates(kernel: str, **dims) -> list[dict]:
    """The plans of ``kernel`` that take a spec's shape, in the kernel's
    own order, as table entries ``{"plan": name}``."""
    reg = KERNELS[kernel]
    return [{"plan": q} for q in reg["plans"]() if reg["takes"](q, **dims)]


def default_specs(max_n: int = 4096):
    """The tier sweep the committed table covers: the reference's specs
    (its ``default_specs``), with the (N, N) kernels up to ``max_n``."""
    specs = []
    for n in (128, 256, 512, 1024, 2048, 4096):
        if n <= max_n:
            specs.append(("floyd_warshall", {"n": n}))
            specs.append(("fused_3dg", {"n": n}))
    for n in (1024, 4096, 16384):
        specs.append(("greedy_argmax", {"n": n}))
    for m, n in ((64, 1024), (128, 4096), (512, 16384)):
        specs.append(("swap_gain", {"m": m, "n": n}))
    for n, p in ((256, 1024), (1024, 2048), (4096, 4096)):
        if n * p <= max_n * 4096:
            specs.append(("memory_aggregate", {"n": n, "p": p}))
    for m, p in ((128, 1024), (256, 4096)):
        if m * p <= max_n * 4096:
            specs.append(("krum_pairwise", {"m": m, "p": p}))
    return specs


# ------------------------------------------------------------------ driver
def cuda_ms(fn, *, reps: int = 10, k: int = 5) -> float:
    """ms per call on the card: one warm-up call, then the best of ``k``
    loops of ``reps`` calls, each loop between two CUDA events."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(k):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        best = min(best, start.elapsed_time(stop) / reps)
    return best


def card_info(device: torch.device) -> dict:
    """The card's name and power limit, as the entries record them."""
    if device.type != "cuda":
        return {"device": device.type, "power_limit": None}
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        limit = None
    return {"device": torch.cuda.get_device_name(device),
            "power_limit": limit or None}


def tune(specs=None, *, timer=None, device=None,
         base_table: dict | None = None, verbose: bool = True) -> dict:
    """Time every candidate plan per (kernel, tier) spec and return the
    merged table.  On the card each candidate is first held against the
    kernel's plain version (bitwise, or memagg's and krum's round-off
    bounds) and a candidate that disagrees raises.  ``timer`` is injectable
    (tests pass a stub, and run no kernel); the default is
    :func:`cuda_ms`.  ``device`` None means CUDA."""
    from repro_torch import resolve_device
    dev = resolve_device(device, who="autotune.tune")
    timer = timer or cuda_ms
    info = card_info(dev)
    table = dict(base_table if base_table is not None else load_table())
    for kernel, dims in (specs if specs is not None else default_specs()):
        reg = KERNELS[kernel]
        cands = candidates(kernel, **dims)
        inputs = reg["setup"](dev, **dims)
        want = reg["plain"](*inputs) if dev.type == "cuda" else None
        timed = []
        for cand in cands:
            fn = functools.partial(reg["run"], cand["plan"], *inputs)
            if want is not None and not reg["check"](fn(), want):
                raise AssertionError(f"autotune: {kernel} {dims} plan "
                                     f"{cand['plan']} disagrees with its "
                                     f"plain version")
            timed.append((cand, timer(fn)))
        if not timed:
            continue
        plan, ms = pick_best(timed)
        key = table_key(kernel, shape_tier(**dims))
        table[key] = {"tiles": plan, "ms": round(ms, 6), "mode": "compiled",
                      "spec": dict(dims), **info,
                      "candidates": [[c, round(v, 6)] for c, v in timed]}
        if verbose:
            print(f"{key}: {plan} ({ms:.4f} ms over {len(timed)} candidates: "
                  + ", ".join(f"{c['plan']} {v:.4f}" for c, v in timed) + ")",
                  flush=True)
    return table


def save_table(table: dict, path=None) -> Path:
    path = Path(path or TABLE_PATH)
    path.write_text(json.dumps(table, indent=2, sort_keys=True) + "\n")
    _load.cache_clear()
    return path


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--max-n", type=int, default=4096,
                    help="largest (N, N) tier to time")
    ap.add_argument("--out", type=Path, default=TABLE_PATH)
    args = ap.parse_args(argv)
    from repro_torch.kernels import _build
    _build.build()
    t0 = time.perf_counter()
    # a fresh table: the committed one holds card runs only
    table = tune(default_specs(args.max_n), base_table={})
    out = save_table(table, args.out)
    print(f"wrote {len(table)} entries -> {out} "
          f"({time.perf_counter() - t0:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
