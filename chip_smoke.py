#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):
  1. build    every CUDA kernel of the port from ``src/repro_torch/
              kernels/csrc`` (one nvcc per source, all at once; the seconds
              until each source's nvcc ended); prints the card's name and
              power limit.
  2. kernels  each kernel against its plain PyTorch version on the card at
              N in {30, 130, 1024, 4096} (swap panel m = ceil(0.1 N), and
              the engine's own M = 6 at N = 30 and M = 102 at N = 1024, the
              shapes phases 3 and 5 give it), under the stated tolerance;
              kernel, plain and (where one PyTorch call computes the same
              function) library times by CUDA events over a loop of calls
              (``ms``: a short call reads its host time), the kernel's and
              the library call's also by replaying a CUDA graph of calls
              (``device_ms``: device time only), beside the least time the
              card could take.
     The staged 3DG kernels (similarity, adjacency) at (N, d) in
              {30, 130, 1024, 4096} x 610 and the vision shapes (100, 10)
              (label distributions) and (100, 13946) (CNN updates), the
              adjacency also either side of its switch to 16-byte vectors,
              its grid rule held to the C one, and the fused adjacency at
              N = 1024 and 4096 with its in-place epilogue launch's own
              device time (torch.profiler); the similarity's serial plan
              beside its planned one at SIM_PLAN_SHAPES (bitwise the same
              V); the
              dense-Q swap at (m, N) = (ceil(0.1 N), N) and (10, 100); the
              graph routes: fused R == staged R and build_h's H ==
              cap(staged H), bitwise, at (30, 610) and (100, 10).
     The fused adjacency at every SIZES entry and at FUSED_EDGE_SHAPES:
              every plan that takes the shape (small, split, serial, big)
              with either epilogue (its own launch, or the tile pass's last
              block) held bitwise the staged kernels' R, lo/hi bitwise the
              plain version's, then each timed beside the plan the call
              takes.  The greedy argmax on both its plans (warp, block),
              with and without the taken set S, at every SIZES entry and at
              the warp plan's threshold ± 1, bitwise, then timed; beside
              them the host time of its two 0-dim outputs against one
              buffer viewed as both.
     The launch floor: an empty one-warp kernel's device_ms, the floor of
              every tiny kernel's row (a reading, not a gate).
     The Q-free swap at its small path's threshold ± 1 entry (the path
              each call took, and both paths timed), on an all-masked and
              an all-equal panel and after CUDA-graph replays with new
              inputs, bitwise; each swap row also gives its sector-aware
              floor beside the bound.
     The robust server update's two kernels likewise: memagg at (N, P, m)
              in {(30, 610, 6), (1024, 610, 102), (2000, 300, 700),
              (4096, 2048, 410)} and at its plans' crossovers
              (MEMAGG_EDGE_SHAPES), every plan (small, cluster) held
              and timed, the crossover printed beside the library call
              (``memagg/crossover``), krum at (m, P) in {(6, 610), (64, 512),
              (128, 2048), (256, 4096), (512, 16384)}, at its two plans'
              crossover at P = 610 (the last m of the small plan, ± 1), at
              (6, 31) and (1, 1), and at the small plan's longest rows, m =
              8 at P = 8192 and 8193, with the Krum selection compared too,
              the diagonal 0, bitwise call to call, and the plan each call
              took beside the other plan's device time (that plan held to
              the same checks).
  3. slice    the quickstart: Synthetic(0.5, 0.5), N = 30, logistic
              regression, LN(0.5) availability, 40 rounds of FedGS
              (alpha = 1, oracle 3DG built by the staged kernels) and of
              Uniform on the card; then FedGS again on the CPU with the
              card's H, the same init and index draws: the same clients
              every round, val_loss within 1e-4.  Launch counts are reset
              just before the card's FedGS run and read just after.
  4. robust   the quickstart under a 20% sign-flip attack (scale 5) against
              fedavg, median, trimmed_mean(0.25), multikrum(f=1, k=3) and
              memory(0.9), plus a benign memory run, 40 rounds each on the
              card, launch counts reset before and read after each run;
              the memory and multikrum runs again on the CPU with the
              card's H: the same sets and Krum rows every round, val_loss
              within 1e-4 (each gap printed beside that gate).  Prints
              each defense's final val_acc.
  5. vision   the CIFAR10 surrogate at full width: make_cifar_like(100,
              20000), small_cnn(8x8x3, width 16; P = 13946), LN(0.5), 30
              rounds of M = 10, E = 10, B = 32, lr 0.03 (examples/
              federated_vision.py).  (a) FedGS on the oracle 3DG on the
              card, twice (bitwise the same); (b) the same on the CPU with
              the card's H: the same set every round, val_loss within
              VISION_LOSS_BOUND, the CNN's forward and one local round
              within 1e-5, and the card run with cuDNN off beside it
              (printed); (c) fedgs_solve on each
              round's dense Q (greedy + dense-swap kernels): the engine's
              set every round; (d) FedGS on the dynamic 3DG (refresh every
              10 rounds: 4 staged builds), H rebuilt on the CPU from the
              card's embeddings under the graph contract; (e) Power-of-
              Choice and Uniform (best val_loss, count variance: findings);
              (f) Table 3 in miniature: best edge F1 of functional and
              update-cosine similarity against the oracle (printed);
              (g) SSPP's V through similarity="precomputed", card vs CPU.
              Launch counts are reset before each run and read after it.
  6. scale    5 rounds of FedGS on the card at N = 30 (M = 6) and at
              N = 1024 clients (M = 102), and FedGS + memory at N = 1024:
              graph build (staged, through the engine; and fused, through
              build_h, with its H bitwise the engine's), per-round solve,
              training and aggregation times, and one profiled round's
              device busy share, its top kernels and the port's own
              kernels' device time (memsets too).
  7. serve    the LM serving path, smollm-135m at full width (30 layers,
              d 576, 9/3 heads of 64, vocab 49152, bf16, random weights
              from a seed): (a) the window attention kernel against its
              plain version at (B, S, Hq/Hkv, D) = (8, 512, 9/3, 64) bf16
              full, (1, 8192, 9/3, 64) bf16 window 4096, (2, 384, 4/2, 32)
              window 100 and (1, 1000, 3/3, 128) full, each in f32 (the
              CUDA-core body) and bf16 (the tensor cores), with kernel,
              plain and scaled_dot_product_attention times;
              (b) repro_torch.launch.serve.main at batch 8, prompt 512,
              gen 32, greedy: exactly 30 launches of the kernel (one per
              layer, prefill only), then the same request warm, timed and
              profiled; (c) batch 2, prompt 128, gen 8 on the card, then
              the same weights on the CPU: prefill and teacher-forced
              decode logits within atol 5e-2, rtol 2e-2, greedy tokens
              equal wherever the card's top-2 margin exceeds the gap;
              (d) the sliding-window variant (window 4096): prefill of
              8,191 tokens + one decode step against the prefill of 8,192.
              (c) and (d) print their gaps beside the earlier readings.
  8. the ``{"kernels": [...]}`` line (times at the main path's shapes:
     N = 30, M = 6, P = 610; the similarity also at the vision phase's
     (100, 13946) update-cosine 3DG, with that call's launches; the dense
     swap at the vision solve's (m, N) = (10, 100); window attention at
     smollm's prefill).
The last line is ``{"ok": true, "device": {...}}``.  The script needs a CUDA
device and the repository's ``src/`` beside it; without either it exits
non-zero and prints no result.  Full output also goes to
``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and float32
# outside the tensor cores, both at the 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
SIZES = (30, 130, 1024, 4096)
# (N, sample_frac) of the engine runs in phases 3 and 5; the first is the
# main path.  The engine's M is max(1, round(frac * N)).
ENGINE_RUNS = ((30, 0.2), (1024, 0.1))
# memagg (N, P, m) and krum (m, P) shapes; the first of each is the main
# path's (the quickstart's panel, P = 610 logistic params)
MEMAGG_SHAPES = ((30, 610, 6), (1024, 610, 102), (2000, 300, 700),
                 (4096, 2048, 410))
# memagg around its plans' crossover at the main path's P (m = 10% of N),
# and slabs past one row map (8,192 rows) on both plans; each plan held and
# timed (memagg_crossover)
MEMAGG_EDGE_SHAPES = ((64, 610, 6), (65, 610, 7), (80, 610, 8),
                      (128, 610, 13), (256, 610, 26), (512, 610, 51),
                      (140000, 64, 100))
KRUM_SHAPES = ((6, 610), (64, 512), (128, 2048), (256, 4096), (512, 16384))
# krum at a P below 32 that is no multiple of 4 (one lane per column, 4-byte
# loads), one row of one column, and the small plan's longest rows and one
# column past them (csrc/krum.cu SMALL_MAX_P)
KRUM_EDGE_SHAPES = ((6, 31), (1, 1), (8, 8192), (8, 8193))
# the staged 3DG kernels' (N, d): the quickstart's local optima at every N,
# then the vision oracle's label distributions and the CNN's flat updates
STAGED_SHAPES = tuple((n, 610) for n in SIZES) + ((100, 10), (100, 13946))
# the adjacency kernel timed either side of its switch from single entries
# to 16-byte vectors (2^18 entries, N = 512)
ADJ_GRID_SIZES = (30, 367, 512, 513, 724, 1024, 4096)
# where the similarity's big plan (128x128 tiles) takes over on an H100 and
# the largest size above: each is timed beside the serial plan (32x32)
SIM_PLAN_SHAPES = ((2900, 300), (4096, 610))
# the fused adjacency's other shapes: the 32-tile edges, N = 100 at the
# quickstart's width, the vision oracle's label distributions and the
# CNN's flat updates (each plan and epilogue timed: where the small plan
# and the last block's epilogue stop paying is read from these rows)
FUSED_EDGE_SHAPES = ((31, 610), (32, 610), (33, 610), (63, 610), (64, 610),
                     (65, 610), (100, 610), (100, 10), (100, 13946))
# the dense-Q swap's (m, N); the last is the vision solve's (phase 5 (c))
SWAP_GAIN_SHAPES = tuple((math.ceil(0.1 * n), n) for n in SIZES) + ((10, 100),)
FEDGS_KERNELS = ("pairwise_similarity", "adjacency", "floyd_warshall",
                 "greedy_argmax", "swap_best_fused")
# phase 5: benchmarks/common.py's non-quick CIFAR surrogate and
# examples/federated_vision.py's run
VISION = {"n_clients": 100, "n_total": 20000, "width": 16, "rounds": 30,
          "params": 13946}
EPS_SWEEP = (0.0, 0.01, 0.05, 0.1, 0.5)     # benchmarks/table3_graph.py
# the vision run's val_loss bound card vs CPU.  Not the quickstart's 1e-4:
# the CNN's forward agrees to f32 round-off (1e-6) and one local round to
# 1e-7, but a max-pool or ReLU decision that flips on a one-ulp difference
# sends a step's gradient elsewhere, and from such a flip on (round 9 of
# this run) two float32 summation orders — card vs CPU, or cuDNN vs no
# cuDNN on the card — differ by up to a few 1e-3 per round
VISION_LOSS_BOUND = 1e-3
# robust phase: the robustness bench's attack (benchmarks/robustness_bench
# .py ATTACKS) and its f_krum / krum_multi formula at M = 6
SIGN_FLIP = {"frac": 0.2, "scale": 5.0}
KRUM_F = max(1, min(math.ceil(0.2 * 6) + 1, (6 - 3) // 2))
KRUM_MULTI = max(2, 6 // 2)
MAIN_N = ENGINE_RUNS[0][0]
NEG = -1e18
# phase 7: the LM serving path.  bf16 inputs run on the tensor cores in the
# library call, so their bound takes the bf16 tensor-core peak
PEAK_BF16_OPS_PER_S = 989e12
SERVE_ARCH = "smollm-135m"
# the window attention kernel's (B, S, Hq, Hkv, D, dtype, window): smollm's
# prefill in (b) (the kernels line's row), the long-context variant's
# window, a window that is not a multiple of the 64-row tile, an S that is
# not, the last two in f32 (the CUDA-core body) and in bf16 (the tensor
# cores, at a ragged S and at D = 128); window None is full causal
WA_SHAPES = ((8, 512, 9, 3, 64, "bfloat16", None),
             (1, 8192, 9, 3, 64, "bfloat16", 4096),
             (2, 384, 4, 2, 32, "float32", 100),
             (1, 1000, 3, 3, 128, "float32", None),
             (2, 384, 4, 2, 32, "bfloat16", 100),
             (1, 1000, 3, 3, 128, "bfloat16", None))
# the serve gaps (c) (card vs CPU, range over the steps) and (d) (prefill
# + decode vs prefill) as first measured on an H100 80GB HBM3 at 700 W,
# with the CUDA-core attention kernel; printed beside this run's
SERVE_GAPS_BEFORE = {"c": [0.034, 0.042], "d": 0.043}
SERVE_MAIN = {"batch": 8, "prompt": 512, "gen": 32}
SERVE_CHECK = {"batch": 2, "prompt": 128, "gen": 8}
LONG_S, LONG_WINDOW = 8192, 4096        # launch/specs.py's long variant
# prefill against decode, and card against CPU, in bf16: the reference's
# own bound (tests/test_arch_smoke.py)
LM_ATOL, LM_RTOL = 5e-2, 2e-2

# substrings of the port's kernel names (and of the memsets) in a profile
PORT_KERNEL_KEYS = ("swap_best", "masked_argmax", "swap_gain", "memagg",
                    "krum", "similarity", "adjacency", "fused_", "fw_",
                    "emset")

KERNEL_INFO = {
    "pairwise_similarity": (
        "src/repro_torch/kernels/csrc/pairwise_similarity.cu",
        "src/repro/kernels/pairwise_similarity.py:22"),
    # the same kernel at the vision phase's (100, 13946) update-cosine 3DG
    "pairwise_similarity/vision": (
        "src/repro_torch/kernels/csrc/pairwise_similarity.cu",
        "src/repro/kernels/pairwise_similarity.py:22"),
    "adjacency": ("src/repro_torch/kernels/csrc/pairwise_similarity.cu",
                  "src/repro/kernels/pairwise_similarity.py:51"),
    "fused_adjacency": ("src/repro_torch/kernels/csrc/graph_fused.cu",
                        "src/repro/kernels/graph_fused.py:42"),
    "floyd_warshall": ("src/repro_torch/kernels/csrc/floyd_warshall.cu",
                       "src/repro/kernels/floyd_warshall.py:50"),
    "greedy_argmax": ("src/repro_torch/kernels/csrc/solver.cu",
                      "src/repro/kernels/solver.py:83"),
    "swap_best_fused": ("src/repro_torch/kernels/csrc/solver.cu",
                        "src/repro/kernels/solver.py:191"),
    "swap_best": ("src/repro_torch/kernels/csrc/solver.cu",
                  "src/repro/kernels/solver.py:153"),
    "memagg": ("src/repro_torch/kernels/csrc/aggregate.cu",
               "src/repro/kernels/aggregate.py:61"),
    "krum": ("src/repro_torch/kernels/csrc/krum.cu",
             "src/repro/kernels/krum.py:36"),
    "window_attention": ("src/repro_torch/kernels/csrc/window_attention.cu",
                         "src/repro/kernels/window_attention.py:31"),
}

_log_lines: list[str] = []


def emit(obj) -> None:
    line = obj if isinstance(obj, str) else json.dumps(obj)
    print(line, flush=True)
    _log_lines.append(line)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, *, budget_s: float = 0.25, max_reps: int = 200) -> float:
    """Mean ms of ``fn`` over a run of launches, by CUDA events (warm)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    est = time.perf_counter() - t0
    reps = int(max(1, min(max_reps, budget_s / max(est, 1e-6))))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(torch, fn, *, reps: int = 20) -> float:
    """Mean ms of ``fn`` on the device: ``reps`` calls captured in a CUDA
    graph and replayed, so its kernels run back to back with no host time
    between them (warm).  cuda_ms, by contrast, times a call whose launch
    costs more host time than its kernels take at its host time."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def engine_m(n: int, frac: float) -> int:
    return max(1, int(round(frac * n)))


MAIN_M = engine_m(*ENGINE_RUNS[0])


def swap_panels(n: int) -> list[int]:
    """Panel rows the swap kernel is held at for N = n: ceil(0.1 N) and the
    engine's M wherever an engine run has this N."""
    return sorted({max(1, math.ceil(0.1 * n))} |
                  {engine_m(nn, f) for nn, f in ENGINE_RUNS if nn == n})


def bound(nbytes: float, ops: float,
          peak: float = PEAK_F32_OPS_PER_S) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def features(np, torch, n: int, seed: int, d: int = 610):
    """Rows shaped like the Synthetic dataset's local optima (N, 610)."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(0.0, np.sqrt(0.5), (n, 1))
    return torch.as_tensor(rng.normal(mu, 1.0, (n, d)), dtype=torch.float32)


# ------------------------------------------------------------ phase 2
def kernel_checks(np, torch, n: int, dev) -> dict:
    """Every kernel against its plain version at N = n.  Returns name -> row."""
    from repro_torch.core.graph_device import cap_and_normalize
    from repro_torch.kernels import floyd_warshall as fw
    from repro_torch.kernels import graph_fused as gf
    from repro_torch.kernels import solver as sv

    rows = {}
    d = 610
    u = features(np, torch, n, seed=n, d=d).to(dev)
    tiny = float(np.finfo(np.float32).tiny)

    # fused adjacency: lo/hi bitwise the plain version's, R bitwise the
    # staged kernels' R on every plan that takes N with either epilogue
    # (held before any is timed), and the same inf pattern and finite R
    # within rtol 1e-4 of the plain version
    r_k, s_k = gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)
    r_p, s_p = gf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
    plans = fused_same_on_every_plan(torch, u, s_p, f"N={n}")
    if not torch.equal(torch.isinf(r_k), torch.isinf(r_p)):
        raise AssertionError(f"fused_adjacency N={n}: inf pattern differs")
    fin = torch.isfinite(r_p)
    err = (r_k[fin] - r_p[fin]).abs()
    if not bool((err <= 1e-4 * r_p[fin].abs() + tiny).all()):
        raise AssertionError(f"fused_adjacency N={n}: R beyond rtol 1e-4")
    # V = U·Uᵀ is symmetric: N(N+1)/2 dot products of 2d operations each,
    # then the min-max, threshold and exp epilogue, ~5 per entry
    b, by = bound(4 * n * d + 4 * n * n + 8, n * (n + 1) * d + 5 * n * n)
    rows["fused_adjacency"] = dict(
        max_abs_err=float(err.max()) if err.numel() else 0.0,
        tolerance="lo/hi bitwise; R bitwise the staged kernels' R on every "
                  "plan; against the plain version inf pattern identical, "
                  "finite R rtol 1e-4",
        plan=gf.fused_adjacency_plan(n, d),
        epilogue=gf.fused_adjacency_epilogue(n),
        ms=cuda_ms(torch, lambda: gf.fused_adjacency_cuda(u, eps=0.1,
                                                          sigma2=0.01)),
        device_ms=device_ms(torch, lambda: gf.fused_adjacency_cuda(
            u, eps=0.1, sigma2=0.01)),
        plain_ms=cuda_ms(torch, lambda: gf.fused_adjacency_plain(
            u, eps=0.1, sigma2=0.01), max_reps=20),
        bound_ms=b, bound_by=by, library_ms=None,
        library="none: no single PyTorch call computes the thresholded "
                "min-max adjacency")
    rows.update(fused_plan_rows(torch, u, plans))

    # Floyd–Warshall on the plain R: bitwise in the plan it takes and in
    # every other plan that takes N (held before it is timed)
    h_p = fw.floyd_warshall_plain(r_p)
    others = fw_same_on_every_plan(torch, r_p, h_p, f"N={n}")
    b, by = bound(2 * 4 * n * n, 2 * n ** 3)
    rows["floyd_warshall"] = dict(
        max_abs_err=0.0, tolerance="bitwise", plan=fw.floyd_warshall_plan(n),
        ms=cuda_ms(torch, lambda: fw.floyd_warshall_cuda(r_p), budget_s=0.5,
                   max_reps=50),
        device_ms=device_ms(torch, lambda: fw.floyd_warshall_cuda(r_p),
                            reps=5),
        other_plans_device_ms={q: device_ms(
            torch, lambda: fw.floyd_warshall_cuda(r_p, plan=q), reps=5)
            for q in others},
        plain_ms=cuda_ms(torch, lambda: fw.floyd_warshall_plain(r_p),
                         budget_s=0.5, max_reps=20),
        bound_ms=b, bound_by=by, library_ms=None,
        library="none: PyTorch has no shortest-path call")

    # solver inputs from this graph: H, z, one greedy pass's r and S
    rng = np.random.default_rng(n + 1)
    h = cap_and_normalize(h_p)
    m = max(1, math.ceil(0.1 * n))
    z = torch.as_tensor(2.0 * (rng.integers(0, 5, n) - 2.0 - m / n) + 1.0,
                        dtype=torch.float32, device=dev)
    al = float(np.float32(1.0) / np.float32(n))
    avail = torch.as_tensor(rng.random(n) < 0.7, device=dev)
    diag = sv.q_diag(h, z, al)

    def selection(m: int):
        """A random S of m clients and its greedy accumulator r."""
        s_np = np.zeros(n, bool)
        s_np[rng.choice(n, m, replace=False)] = True
        s = torch.as_tensor(s_np, device=dev)
        sel = torch.nonzero(s).flatten()
        r = torch.zeros(n, dtype=torch.float32, device=dev)
        for k in sel:
            r = r + sv.q_row(h, z, al, k)
        return s, sel, r

    s, sel, r = selection(m)
    mask = avail & ~s
    # the greedy step hands the kernel A_t and S (taken): both forms, both
    # plans, and the all-masked lane, bitwise (held before any is timed)
    none = torch.zeros(n, dtype=torch.bool, device=dev)
    argmax_same_on_every_plan(torch, diag, r, [(mask, None), (avail, s),
                                               (none, None), (avail, avail)],
                              f"N={n}")
    ev, ei = sv.masked_argmax_cuda(diag, r, none)
    if float(ev) != float(np.float32(NEG)) or int(ei) != 0:
        raise AssertionError(f"greedy_argmax N={n}: all-masked gave ({ev}, {ei})")
    gain = torch.where(mask, diag + 2.0 * r, torch.full_like(r, NEG))
    b, by = bound(n * (4 + 4 + 1) + 12, 4 * n)
    b_taken, _ = bound(n * (4 + 4 + 1 + 1) + 12, 4 * n)
    rows["greedy_argmax"] = dict(
        max_abs_err=0.0, tolerance="bitwise (value and index)",
        plan=sv.masked_argmax_plan(n),
        ms=cuda_ms(torch, lambda: sv.masked_argmax_cuda(diag, r, mask)),
        device_ms=device_ms(torch, lambda: sv.masked_argmax_cuda(diag, r,
                                                                 mask)),
        plain_ms=cuda_ms(torch, lambda: sv.masked_argmax_plain(diag, r, mask)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.argmax(gain)),
        library_device_ms=device_ms(torch, lambda: torch.argmax(gain)),
        library="torch.argmax over the masked gain",
        # host time of the wrapper's two 0-dim outputs against one buffer
        # viewed as both (ms per call, host clock, 2,000 calls each)
        alloc_two_ms=host_ms(lambda: (
            torch.empty((), dtype=torch.float32, device=dev),
            torch.empty((), dtype=torch.int64, device=dev))),
        alloc_one_viewed_ms=host_ms(lambda: one_buffer(torch, dev)))
    # the main path's call: A_t and S read in the kernel
    rows["greedy_argmax/taken"] = dict(
        rows["greedy_argmax"],
        ms=cuda_ms(torch, lambda: sv.masked_argmax_cuda(diag, r, avail, s)),
        device_ms=device_ms(torch, lambda: sv.masked_argmax_cuda(
            diag, r, avail, s)),
        plain_ms=cuda_ms(torch, lambda: sv.masked_argmax_plain(diag, r,
                                                               avail, s)),
        bound_ms=b_taken)
    for q in sv.ARGMAX_PLANS:
        rows[f"greedy_argmax/plan={q}"] = dict(
            plan=q, ms=cuda_ms(torch, lambda: sv.masked_argmax_cuda(
                diag, r, mask, plan=q)),
            device_ms=device_ms(torch, lambda: sv.masked_argmax_cuda(
                diag, r, mask, plan=q)))

    for m in swap_panels(n):
        s, sel, r = selection(m)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        a = (-2.0 * r + diag)[sel]
        bb = torch.where(~s & avail, 2.0 * r + diag, torch.full_like(r, NEG))
        kargs = (h, z, al, sel, valid, a, bb)
        k3 = sv.swap_best_fused_cuda(*kargs)
        p3 = sv.swap_best_fused_plain(*kargs)
        if not all(torch.equal(x, y) for x, y in zip(k3, p3)) \
                or float(k3[0]) <= NEG / 2:
            raise AssertionError(f"swap_best_fused N={n} m={m}: {k3} != {p3}")
        b, by = bound(2 * 4 * m * n + 4 * n + 4 * m + 8 * m + m + 4 * m + 20,
                      10 * m * n)
        rows[f"swap_best_fused/m={m}"] = dict(
            max_abs_err=0.0, tolerance="bitwise (best, rank, j)", m=m,
            plan=sv.swap_best_fused_plan(m, n),
            sector_floor_ms=swap_sector_floor_ms(np, n, sel.cpu().numpy()),
            ms=cuda_ms(torch, lambda: sv.swap_best_fused_cuda(*kargs)),
            device_ms=device_ms(torch,
                                lambda: sv.swap_best_fused_cuda(*kargs)),
            plain_ms=cuda_ms(torch, lambda: sv.swap_best_fused_plain(*kargs)),
            bound_ms=b, bound_by=by, library_ms=None,
            library="none: no single PyTorch call rebuilds Q and arg-maxes it")
    return rows


def fused_same_on_every_plan(torch, u, want_stats, what: str) -> list[str]:
    """The fused adjacency on u in every plan that takes its (N, d), with
    either epilogue: lo/hi bitwise ``want_stats`` and R bitwise the staged
    kernels' R.  Returns those plans."""
    from repro_torch.kernels import graph_fused as gf
    from repro_torch.kernels import pairwise_similarity as ps

    v = ps.similarity_cuda(u)
    want = ps.adjacency_cuda(v, torch.stack([torch.min(v), torch.max(v)]),
                             eps=0.1, sigma2=0.01)
    plans = gf.fused_adjacency_plans(*u.shape)
    for q in [None, *plans]:
        for e in (None, *gf.EPILOGUES):
            r, stats = gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01,
                                               plan=q, epilogue=e)
            if not (torch.equal(stats, want_stats) and torch.equal(r, want)):
                raise AssertionError(f"fused_adjacency {what} ({q}, {e}): "
                                     "not bitwise the staged R")
    return plans


def fused_plan_rows(torch, u, plans) -> dict:
    """Each plan's and epilogue's time on u (the last block's epilogue only
    up to 2^20 entries of R: one block over more is not a plan)."""
    from repro_torch.kernels import graph_fused as gf

    n = u.shape[0]
    rows = {}
    for q in plans:
        for e in gf.EPILOGUES:
            if e == "last_block" and n * n > 1 << 20:
                continue

            def call(q=q, e=e):
                return gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01,
                                               plan=q, epilogue=e)
            rows[f"fused_adjacency/plan={q}/epilogue={e}"] = dict(
                plan=q, epilogue=e, ms=cuda_ms(torch, call),
                device_ms=device_ms(torch, call))
    return rows


def fused_edge_checks(np, torch, dev) -> dict:
    """The fused adjacency at FUSED_EDGE_SHAPES: every plan that takes the
    shape held bitwise (fused_same_on_every_plan), then timed with either
    epilogue.  Returns shape -> rows; the planned ones are named."""
    from repro_torch.kernels import graph_fused as gf

    out = {}
    for n, d in FUSED_EDGE_SHAPES:
        u = features(np, torch, n, seed=n + d, d=d).to(dev)
        _, s_p = gf.fused_adjacency_plain(u, eps=0.1, sigma2=0.01)
        plans = fused_same_on_every_plan(torch, u, s_p, f"{n, d}")
        out[f"fused_adjacency/{n}x{d}"] = dict(
            n=n, d=d, plan=gf.fused_adjacency_plan(n, d),
            epilogue=gf.fused_adjacency_epilogue(n),
            rows=fused_plan_rows(torch, u, plans))
    return out


def argmax_same_on_every_plan(torch, diag, r, masks, what: str) -> None:
    """The greedy argmax on (diag, r) with each (mask, taken) of ``masks``,
    in both plans and the planned one: bitwise the plain version."""
    from repro_torch.kernels import solver as sv

    for mask, taken in masks:
        want = sv.masked_argmax_plain(diag, r, mask, taken)
        for q in (None, *sv.ARGMAX_PLANS):
            got = sv.masked_argmax_cuda(diag, r, mask, taken, plan=q)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"greedy_argmax {what} ({q}): {got} != "
                                     f"{want}")


def argmax_edge_checks(np, torch, dev) -> dict:
    """The greedy argmax at its warp path's threshold T ± 1: both plans held
    bitwise (with and without a taken set, all-masked and all-equal), then
    timed.  Returns n -> rows."""
    from repro_torch.kernels import solver as sv

    t = sv.masked_argmax_warp_most()
    out = {}
    for n in (t - 1, t, t + 1):
        rng = np.random.default_rng(n)
        diag = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                               device=dev)
        r = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device=dev)
        mask = torch.as_tensor(rng.random(n) < 0.6, device=dev)
        taken = torch.as_tensor(rng.random(n) < 0.3, device=dev)
        ones = torch.ones(n, dtype=torch.float32, device=dev)
        argmax_same_on_every_plan(torch, diag, r, [
            (mask, None), (mask, taken), (mask, mask)], f"n={n}")
        argmax_same_on_every_plan(torch, ones, 0 * ones, [(mask, taken)],
                                  f"n={n} all-equal")
        out[f"greedy_argmax/n={n}"] = dict(
            n=n, plan=sv.masked_argmax_plan(n), threshold=t, rows={
                q: {"device_ms": device_ms(torch, lambda q=q: sv.masked_argmax_cuda(
                        diag, r, mask, taken, plan=q)),
                    "ms": cuda_ms(torch, lambda q=q: sv.masked_argmax_cuda(
                        diag, r, mask, taken, plan=q))}
                for q in sv.ARGMAX_PLANS})
    return out


def host_ms(fn, reps: int = 2000) -> float:
    """Mean host ms of fn over reps calls (host clock; fn enqueues no
    device work worth waiting for)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def one_buffer(torch, dev):
    """One 16-byte allocation viewed as a 0-dim int64 and a 0-dim float32."""
    buf = torch.empty(2, dtype=torch.int64, device=dev)
    return buf.view(torch.float32)[2], buf[0]


def fw_same_on_every_plan(torch, r, want, what: str) -> list[str]:
    """Floyd–Warshall on r in the plan it takes and in every other plan that
    takes its N, each bitwise ``want``.  Returns the other plans."""
    from repro_torch.kernels import floyd_warshall as fw

    n = r.shape[0]
    plan = fw.floyd_warshall_plan(n)
    others = [q for q in fw.PLANS if q != plan and
              (q != "single" or n <= fw.SINGLE_MOST)]
    for q in [None, *others]:
        if not torch.equal(fw.floyd_warshall_cuda(r, plan=q), want):
            raise AssertionError(f"floyd_warshall {what} ({q or plan} "
                                 "plan): not bitwise")
    return others


def fw_edge_checks(np, torch, dev) -> dict:
    """Floyd–Warshall on every plan that takes N, bitwise its plain version
    and then timed (``device_ms`` per plan): at the pivot blocks' edges (1,
    T − 1, T, T + 1, 2T + 1 for T = 32 and 64), at 238, 239 and the single
    plan's largest N and one past, at 2048 and 2560 (around the switch from
    T = 32 to 64), on directed adjacencies (40% inf, weights in [0, 10)),
    and on the N = 130 fixture on which the blocked order that reads the
    final pivot panels (the TPU kernel's) parts from the per-pivot order.
    Returns name -> row."""
    from repro_torch.kernels import floyd_warshall as fw

    def adjacency(n, seed):
        rng = np.random.default_rng(seed)
        r = (rng.random((n, n)) * 10).astype(np.float32)
        r[rng.random((n, n)) < 0.4] = np.inf
        np.fill_diagonal(r, 0)
        return torch.from_numpy(r).to(dev)

    rows = {}
    cases = [(n, n) for n in (1, 31, 32, 33, 63, 64, 65, 129, 238, 239,
                              fw.SINGLE_MOST, fw.SINGLE_MOST + 1, 2048,
                              2560)]
    for n, seed in cases + [(130, 0)]:
        r = adjacency(n, seed)
        plan = fw.floyd_warshall_plan(n)
        others = fw_same_on_every_plan(torch, r, fw.floyd_warshall_plain(r),
                                       f"N={n} seed={seed}")
        rows[f"floyd_warshall/n={n}/seed={seed}"] = dict(
            plan=plan, tolerance="bitwise", plans_device_ms={
                q: device_ms(torch, lambda: fw.floyd_warshall_cuda(
                    r, plan=q), reps=5) for q in [plan, *others]})
    return rows


def swap_sector_floor_ms(np, n: int, sel) -> float:
    """The Q-free swap's least time when every byte of H it reads comes in
    32-byte sectors: the distinct sectors of the rows H[sel, :] and of the
    columns H[:, sel] (a sparse sel puts each column value in a sector of
    its own), plus the bound's other bytes, over the HBM rate.  The bound
    (8·m·N + 4·N + 17·m bytes) counts only the values."""
    sel = np.unique(sel.astype(np.int64))
    m = len(sel)
    starts = sel * n * 4 // 32
    ends = ((sel + 1) * n * 4 - 1) // 32
    rows = np.concatenate([np.arange(a, e + 1) for a, e in zip(starts, ends)])
    cols = ((np.arange(n)[:, None] * n + sel[None, :]) * 4 // 32).ravel()
    sectors = len(np.union1d(rows, cols))
    return (32 * sectors + 4 * n + 17 * m + 20) / PEAK_BYTES_PER_S * 1e3


def swap_fused_edge_checks(np, torch, dev) -> dict:
    """The Q-free swap at its small path's threshold ± 1 entry, each timed
    on both paths, and on an all-masked panel (no column to swap in:
    (-1e18, 0, 0)), an all-equal panel (the lowest flat index wins: rank 0,
    column 0) and after a CUDA graph's replays with new inputs: bitwise
    against its plain version everywhere.  Returns name -> row."""
    from repro_torch.kernels import solver as sv

    last = next(t for t in range(1, 1 << 16)
                if sv.swap_best_fused_plan(1, t + 1) != "small")

    def inputs(m, n, seed):
        rng = np.random.default_rng(seed)
        h = rng.random((n, n)).astype(np.float32)
        h = torch.as_tensor(0.5 * (h + h.T), device=dev)
        h[:, min(3, n - 1)] = float("nan")
        z = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device=dev)
        sel = torch.as_tensor(np.sort(rng.choice(n, m, replace=False)),
                              device=dev)
        r = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device=dev)
        free = torch.as_tensor(rng.random(n) < 0.7, device=dev)
        free[sel] = False
        b = torch.where(free, 2.0 * r, torch.full_like(r, NEG))
        return [h, z, float(np.float32(1.0) / np.float32(n)), sel,
                torch.ones(m, dtype=torch.bool, device=dev), (-2.0 * r)[sel], b]

    def same(args, **kw):
        k = sv.swap_best_fused_cuda(*args, **kw)
        p = sv.swap_best_fused_plain(*args)
        if not all(torch.equal(x, y) for x, y in zip(k, p)):
            raise AssertionError(f"swap_best_fused {kw}: {k} != {p}")
        return k

    rows = {}
    # (m, N) with m·N = last − 1, last, last + 1
    rows_at = next(d for d in (4, 3, 2, 1) if last % d == 0)
    for m, n in ((1, last - 1), (rows_at, last // rows_at), (1, last + 1)):
        args = inputs(m, n, m * n)
        same(args)
        row = dict(m=m, n=n, entries=m * n, plan=sv.swap_best_fused_plan(m, n),
                   tolerance="bitwise (best, rank, j)",
                   device_ms=device_ms(torch,
                                       lambda: sv.swap_best_fused_cuda(*args)))
        for path in sv.SWAP_FUSED_PLANS:
            same(args, plan=path)
            row[f"{path}_device_ms"] = device_ms(
                torch, lambda: sv.swap_best_fused_cuda(*args, plan=path))
        rows[f"swap_best_fused/m={m}/n={n}"] = row
    # the quickstart's panel and the large one, on each path where it fits
    for m, n in ((MAIN_M, MAIN_N), (410, 4096)):
        masked = inputs(m, n, 7)
        masked[6] = torch.full((n,), NEG, device=dev)
        equal = inputs(m, n, 8)
        equal[0] = torch.full((n, n), 0.25, device=dev)
        equal[1] = torch.zeros(n, device=dev)
        equal[5] = torch.full((m,), 1.5, device=dev)
        equal[6] = torch.full((n,), -0.5, device=dev)
        for path in sv.SWAP_FUSED_PLANS:
            if path == "small" and m * n > last:
                continue
            k = same(masked, plan=path)
            if (float(k[0]), int(k[1]), int(k[2])) != (float(np.float32(NEG)),
                                                       0, 0):
                raise AssertionError(f"swap_best_fused all-masked: {k}")
            k = same(equal, plan=path)
            if (int(k[1]), int(k[2])) != (0, 0):
                raise AssertionError(f"swap_best_fused all-equal: {k}")
        # captured once, replayed on new inputs copied into the same buffers
        static = inputs(m, n, 9)
        sv.swap_best_fused_cuda(*static)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sv.swap_best_fused_cuda(*static)
        for seed in (10, 11, 12):
            for dst, src in zip(static, inputs(m, n, seed)):
                if isinstance(dst, torch.Tensor):
                    dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            want = sv.swap_best_fused_plain(*static)
            if not all(torch.equal(x, y) for x, y in zip(out, want)):
                raise AssertionError(f"swap_best_fused {m, n}: graph replay "
                                     f"{out} != {want}")
        rows[f"swap_best_fused/m={m}/n={n}/cases"] = dict(
            all_masked=True, all_equal=True, graph_replays=3)
    return rows


def launch_floor_ms(torch) -> float:
    """An empty one-warp kernel's device time, replayed from a CUDA graph
    as device_ms replays every kernel: the floor of a tiny kernel's row."""
    import ctypes

    from repro_torch.kernels._build import library
    fn = library("solver").empty_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int
    return device_ms(torch, lambda: fn(torch.cuda.current_stream().cuda_stream))


def r_close(torch, got, want, *, atol: float) -> float:
    """R or H against its reference: the same inf pattern, finite entries
    within rtol 1e-4 (``atol`` below the normal float32 range).  Returns the
    largest absolute error; raises beyond the bound."""
    if not torch.equal(torch.isinf(got), torch.isinf(want)):
        raise AssertionError("inf pattern differs")
    fin = torch.isfinite(want)
    err = (got[fin] - want[fin]).abs()
    if not bool((err <= 1e-4 * want[fin].abs() + atol).all()):
        raise AssertionError(f"beyond rtol 1e-4 (max abs err {err.max()})")
    return float(err.max()) if err.numel() else 0.0


def staged_kernel_checks(np, torch, dev) -> dict:
    """The staged similarity and adjacency kernels against their plain
    versions at every STAGED_SHAPES entry.  Returns name/shape -> row."""
    from repro_torch.kernels import pairwise_similarity as ps

    rows = {}
    tiny = float(np.finfo(np.float32).tiny)
    for n, d in STAGED_SHAPES:
        u = features(np, torch, n, seed=n + d, d=d).to(dev)
        v = ps.similarity_cuda(u)
        if not torch.equal(v, ps.similarity_plain(u)):
            raise AssertionError(f"similarity {n, d}: V not bitwise")
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        lib_ms = cuda_ms(torch, lambda: torch.matmul(u, u.T))
        lib_dev_ms = device_ms(torch, lambda: torch.matmul(u, u.T))
        torch.backends.cuda.matmul.allow_tf32 = prev
        # V is symmetric: N(N+1)/2 dot products of 2d operations each
        b, by = bound(4 * n * d + 4 * n * n, n * (n + 1) * d)
        rows[f"pairwise_similarity/{n}x{d}"] = dict(
            n=n, d=d, max_abs_err=0.0, tolerance="V bitwise",
            plan=ps.similarity_plan(n, d),
            ms=cuda_ms(torch, lambda: ps.similarity_cuda(u)),
            device_ms=device_ms(torch, lambda: ps.similarity_cuda(u)),
            plain_ms=cuda_ms(torch, lambda: ps.similarity_plain(u),
                             max_reps=20),
            bound_ms=b, bound_by=by, library_ms=lib_ms,
            library_device_ms=lib_dev_ms,
            library="torch.matmul(u, u.T), TF32 off")

        stats = torch.stack([torch.min(v), torch.max(v)])
        r_k = ps.adjacency_cuda(v, stats, eps=0.1, sigma2=0.01)
        r_p = ps.adjacency_plain(v, stats, eps=0.1, sigma2=0.01)
        err = r_close(torch, r_k, r_p, atol=tiny)
        if not torch.equal(torch.diagonal(r_k), torch.zeros_like(r_k[0])):
            raise AssertionError(f"adjacency {n, d}: diagonal not 0")
        # read V and lo/hi, write R; subtract, divide, compare, divide, exp
        b, by = bound(8 * n * n + 8, 5 * n * n)
        rows[f"adjacency/{n}x{d}"] = dict(
            n=n, d=d, max_abs_err=err, grid=ps.adjacency_grid(n),
            tolerance="inf pattern identical, finite R rtol 1e-4",
            ms=cuda_ms(torch, lambda: ps.adjacency_cuda(v, stats, eps=0.1,
                                                        sigma2=0.01)),
            device_ms=device_ms(torch, lambda: ps.adjacency_cuda(
                v, stats, eps=0.1, sigma2=0.01)),
            plain_ms=cuda_ms(torch, lambda: ps.adjacency_plain(
                v, stats, eps=0.1, sigma2=0.01)),
            bound_ms=b, bound_by=by, library_ms=None,
            library="none: no single PyTorch call computes the thresholded "
                    "min-max adjacency")
    rows.update(fused_epilogue_rows(np, torch, dev))
    for n, d in SIM_PLAN_SHAPES:
        u = features(np, torch, n, seed=n + d, d=d).to(dev)
        if not torch.equal(ps.similarity_serial_cuda(u),
                           ps.similarity_cuda(u)):
            raise AssertionError(f"similarity {n, d}: serial plan differs")
        rows[f"similarity_plans/{n}x{d}"] = dict(
            n=n, d=d, plan=ps.similarity_plan(n, d),
            ms=cuda_ms(torch, lambda: ps.similarity_cuda(u)),
            device_ms=device_ms(torch, lambda: ps.similarity_cuda(u)),
            serial_ms=cuda_ms(torch, lambda: ps.similarity_serial_cuda(u)),
            serial_device_ms=device_ms(
                torch, lambda: ps.similarity_serial_cuda(u)))
    return rows


def fused_epilogue_rows(np, torch, dev) -> dict:
    """The adjacency kernel as planned at ADJ_GRID_SIZES (both sides of
    the switch from single entries to 16-byte vectors), timed; then the
    fused adjacency at (N, 610) for N = 1024 and 4096, where a launch of
    the staged adjacency kernel turns V into R in place: the call's
    device_ms (CUDA-graph replay) and, from torch.profiler over ten calls,
    that launch's mean device time.  Also holds the Python mirror of the
    kernel's grid (adjacency_grid) to the C function."""
    import ctypes

    from repro_torch.kernels import graph_fused as gf
    from repro_torch.kernels import pairwise_similarity as ps
    from repro_torch.kernels._build import library

    fn = library("pairwise_similarity").adjacency_grid_code
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    for n in (*range(0, 70), 100, 130, 512, 513, 1024, 4096, 8191, 8192,
              46340):
        c = divmod(fn(n), 8)[::-1]
        if c != ps.adjacency_grid(n):
            raise AssertionError(f"adjacency grid at N={n}: C {c}, "
                                 f"Python {ps.adjacency_grid(n)}")
    rows = {}
    for n in ADJ_GRID_SIZES:
        u = features(np, torch, n, seed=n + 1, d=610).to(dev)
        v = ps.similarity_cuda(u)
        stats = torch.stack([torch.min(v), torch.max(v)])
        rows[f"adjacency_grid/{n}"] = dict(
            n=n, grid=ps.adjacency_grid(n),
            device_ms=device_ms(torch, lambda: ps.adjacency_cuda(
                v, stats, eps=0.1, sigma2=0.01)))
    for n in (1024, 4096):
        u = features(np, torch, n, seed=n, d=610).to(dev)

        def call():
            return gf.fused_adjacency_cuda(u, eps=0.1, sigma2=0.01)
        if gf.fused_adjacency_epilogue(n) != "launch":
            raise AssertionError(f"fused N={n}: epilogue not a launch")
        call()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        epi = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and
               "adjacency_kernel" in e.key]
        rows[f"fused_adjacency/{n}x610/epilogue=launch"] = dict(
            n=n, d=610, plan=gf.fused_adjacency_plan(n, 610),
            ms=cuda_ms(torch, call), device_ms=device_ms(torch, call),
            epilogue_device_ms=(sum(e.self_device_time_total for e in epi) /
                                max(1, sum(e.count for e in epi)) / 1e3
                                if epi else None),
            epilogue_bound_ms=bound(8 * n * n + 8, 5 * n * n)[0])
    return rows


def swap_gain_checks(np, torch, dev) -> dict:
    """The dense-Q best swap against its plain version at every
    SWAP_GAIN_SHAPES entry, on Q = sym(alpha/N H - diag(z)) with one
    NaN-poisoned column.  Returns name/shape -> row."""
    from repro_torch.kernels import solver as sv

    rows = {}
    for m, n in SWAP_GAIN_SHAPES:
        rng = np.random.default_rng(m * n)
        h = rng.random((n, n)).astype(np.float32)
        h = 0.5 * (h + h.T)
        np.fill_diagonal(h, 0.0)
        z = 2.0 * (rng.integers(0, 5, n) - 2.0 - m / n) + 1.0
        al = np.float32(1.0) / np.float32(n)
        q = al * h - np.diag(z).astype(np.float32)
        q = torch.as_tensor(0.5 * (q + q.T), device=dev)
        q[:, 3] = float("nan")
        s_np = np.zeros(n, bool)
        s_np[rng.choice(n, m, replace=False)] = True
        s = torch.as_tensor(s_np, device=dev)
        sel = torch.nonzero(s).flatten()
        r = q[sel].sum(0)
        diag = torch.diagonal(q)
        avail = torch.as_tensor(rng.random(n) < 0.7, device=dev)
        a = (-2.0 * r + diag)[sel]
        bb = torch.where(~s & avail, 2.0 * r + diag, torch.full_like(r, NEG))
        args = (q, sel, a, bb)
        k3 = swap_gain_same(torch, args)
        if float(k3[0]) <= NEG / 2 or int(k3[2]) == 3:
            raise AssertionError(f"swap_best {m, n}: {k3}")
        # the other path, where it takes the panel, held before it is timed
        plan = sv.swap_gain_plan(m, n)
        other = next(q for q in sv.SWAP_GAIN_PLANS if q != plan)
        if other == "small" and m * n > sv.SWAP_GAIN_SMALL_MOST:
            other = None
        else:
            swap_gain_same(torch, args, plan=other)
        # read the m selected rows of Q, a, b and sel; write three scalars;
        # add, multiply, subtract and a NaN test per panel entry
        b, by = bound(4 * m * n + 4 * m + 4 * n + 8 * m + 20, 4 * m * n)
        rows[f"swap_best/m={m}/n={n}"] = dict(
            n=n, m=m, max_abs_err=0.0, tolerance="bitwise (best, rank, j)",
            plan=plan,
            ms=cuda_ms(torch, lambda: sv.swap_gain_cuda(*args)),
            device_ms=device_ms(torch, lambda: sv.swap_gain_cuda(*args)),
            other_plan=other, other_plan_device_ms=None if other is None
            else device_ms(torch, lambda: sv.swap_gain_cuda(*args,
                                                            plan=other)),
            plain_ms=cuda_ms(torch, lambda: sv.swap_gain_plain(*args)),
            bound_ms=b, bound_by=by, library_ms=None,
            library="none: no single PyTorch call arg-maxes the swap gain "
                    "over Q's selected rows")
    return rows


def swap_gain_same(torch, args, **kw):
    """The dense swap kernel against its plain version: bitwise (best,
    rank, j), or raise.  Returns the kernel's result."""
    from repro_torch.kernels import solver as sv

    k = sv.swap_gain_cuda(*args, **kw)
    p = sv.swap_gain_plain(*args)
    if not all(torch.equal(x, y) for x, y in zip(k, p)):
        raise AssertionError(f"swap_best {kw}: {k} != {p}")
    return k


def swap_gain_edge_checks(np, torch, dev) -> dict:
    """The dense swap at its small path's threshold ± 1 entry, each timed
    on both paths, and on an all-masked panel ((-1e18, 0, 0)), an all-equal
    panel (rank 0, column 0) and after a CUDA graph's replays with new
    inputs, on each path the panel fits: bitwise against its plain version
    everywhere.  Returns name -> row."""
    from repro_torch.kernels import solver as sv

    last = next(t for t in range(1, 1 << 16)
                if sv.swap_gain_plan(1, t + 1) != "small")

    def inputs(m, n, seed):
        rng = np.random.default_rng(seed)
        h = rng.random((n, n)).astype(np.float32)
        q = torch.as_tensor(0.5 * (h + h.T), device=dev)
        q[:, min(3, n - 1)] = float("nan")
        sel = torch.as_tensor(np.sort(rng.choice(n, m, replace=False)),
                              device=dev)
        r = torch.as_tensor(rng.normal(size=n), dtype=torch.float32,
                            device=dev)
        free = torch.as_tensor(rng.random(n) < 0.7, device=dev)
        free[sel] = False
        return [q, sel, (-2.0 * r)[sel],
                torch.where(free, 2.0 * r, torch.full_like(r, NEG))]

    rows = {}
    rows_at = next(d for d in (4, 3, 2, 1) if last % d == 0)
    for m, n in ((1, last - 1), (rows_at, last // rows_at), (1, last + 1)):
        args = inputs(m, n, m * n)
        swap_gain_same(torch, args)
        row = dict(m=m, n=n, entries=m * n, plan=sv.swap_gain_plan(m, n),
                   tolerance="bitwise (best, rank, j)",
                   device_ms=device_ms(torch,
                                       lambda: sv.swap_gain_cuda(*args)))
        for path in sv.SWAP_GAIN_PLANS:
            swap_gain_same(torch, args, plan=path)
            row[f"{path}_device_ms"] = device_ms(
                torch, lambda: sv.swap_gain_cuda(*args, plan=path))
        rows[f"swap_best/m={m}/n={n}"] = row
    for m, n in (SWAP_GAIN_SHAPES[-1], (410, 4096)):
        masked = inputs(m, n, 7)
        masked[3] = torch.full((n,), NEG, device=dev)
        equal = inputs(m, n, 8)
        equal[0] = torch.full((n, n), 0.25, device=dev)
        equal[2] = torch.full((m,), 1.5, device=dev)
        equal[3] = torch.full((n,), -0.5, device=dev)
        for path in sv.SWAP_GAIN_PLANS:
            if path == "small" and m * n > sv.SWAP_GAIN_SMALL_MOST:
                continue
            k = swap_gain_same(torch, masked, plan=path)
            if (float(k[0]), int(k[1]), int(k[2])) != (float(np.float32(NEG)),
                                                       0, 0):
                raise AssertionError(f"swap_best all-masked: {k}")
            k = swap_gain_same(torch, equal, plan=path)
            if (int(k[1]), int(k[2])) != (0, 0):
                raise AssertionError(f"swap_best all-equal: {k}")
        static = inputs(m, n, 9)
        sv.swap_gain_cuda(*static)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = sv.swap_gain_cuda(*static)
        for seed in (10, 11, 12):
            for dst, src in zip(static, inputs(m, n, seed)):
                dst.copy_(src)
            graph.replay()
            torch.cuda.synchronize()
            want = sv.swap_gain_plain(*static)
            if not all(torch.equal(x, y) for x, y in zip(out, want)):
                raise AssertionError(f"swap_best {m, n}: graph replay "
                                     f"{out} != {want}")
        rows[f"swap_best/m={m}/n={n}/cases"] = dict(
            all_masked=True, all_equal=True, graph_replays=3)
    return rows


def graph_route_checks(np, torch, dev) -> dict:
    """On the card: the fused route's R is bitwise the staged route's, and
    build_h's H is bitwise cap(staged H), for every feature similarity at
    the quickstart's (30, 610) and the vision oracle's (100, 10)."""
    from repro_torch.core import graph_device as gd
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.data.vision import make_cifar_like
    from repro_torch.kernels import ops

    feats = {
        "quickstart": make_synthetic(n_clients=30, alpha=0.5, beta=0.5,
                                     seed=0).opt_params,
        "vision": make_cifar_like(n_clients=VISION["n_clients"],
                                  n_total=VISION["n_total"],
                                  seed=0).label_dist}
    out = {}
    for name, f in feats.items():
        u = torch.as_tensor(f, dtype=torch.float32, device=dev)
        for sim in ("dot", "cosine", "functional"):
            cfg = gd.GraphConfig(similarity=sim)
            vn, r_staged, h_staged = gd.build_3dg(u, cfg)
            r_fused, _ = ops.build_3dg_fused(
                gd._features(u, cfg), eps=cfg.eps, sigma2=cfg.sigma2,
                clamp=sim == "functional")
            if vn is None or not torch.equal(r_staged, r_fused):
                raise AssertionError(f"{name}/{sim}: fused R != staged R")
            if not torch.equal(gd.build_h(u, cfg),
                               gd.cap_and_normalize(h_staged)):
                raise AssertionError(f"{name}/{sim}: build_h H != staged H")
            out[f"{name}/{sim}"] = {
                "shape": list(u.shape), "r_bitwise": True,
                "h_bitwise": True,
                "edges": int(torch.isfinite(r_staged).sum()) - len(u)}
    return out


def robust_kernel_checks(np, torch, dev) -> dict:
    """memagg and krum against their plain versions at every listed shape,
    krum also at its plans' crossover and at KRUM_EDGE_SHAPES.  Returns
    name/shape -> row."""
    from repro_torch.kernels import aggregate as ag
    from repro_torch.kernels import krum as kr

    rows = {}
    for n, p, m in MEMAGG_SHAPES + MEMAGG_EDGE_SHAPES:
        rng = np.random.default_rng(n + p + m)
        mem = torch.as_tensor(rng.normal(size=(n, p)), dtype=torch.float32,
                              device=dev)
        upd = torch.as_tensor(rng.normal(size=(m, p)), dtype=torch.float32,
                              device=dev)
        sel = torch.as_tensor(np.sort(rng.choice(n, m, replace=False)),
                              device=dev)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        w = torch.as_tensor(rng.random(n), dtype=torch.float32, device=dev)
        w = w / w.sum()
        pm, pr = ag.memory_scatter_reduce_ref(mem.clone(), upd, sel, valid, w)
        # every plan that takes the shape, held before any is timed
        plans, err = ag.memagg_plans(n, p, m), None
        for q in plans:
            km, kr1 = ag.memory_aggregate_cuda(mem.clone(), upd, sel, valid,
                                               w, plan=q)
            _, kr2 = ag.memory_aggregate_cuda(mem.clone(), upd, sel, valid,
                                              w, plan=q)
            if not torch.equal(km, pm):
                raise AssertionError(f"memagg {n, p, m} {q}: panel not "
                                     "bitwise")
            if not torch.equal(kr1, kr2):
                raise AssertionError(f"memagg {n, p, m} {q}: red not "
                                     "repeatable")
            e = (kr1 - pr).abs()
            if not bool((e <= 1e-5 + 1e-5 * pr.abs()).all()):
                raise AssertionError(f"memagg {n, p, m} {q}: red beyond "
                                     f"1e-5 ({float(e.max())})")
            if q == ag.memagg_plan(n, p, m):
                err = e
        work = mem.clone()
        per_plan = {}
        for q in plans:
            def call(q=q):
                return ag.memory_aggregate_cuda(work, upd, sel, valid, w,
                                                plan=q)
            per_plan[q] = dict(ms=cuda_ms(torch, call),
                               device_ms=device_ms(torch, call))
            rows[f"memagg/{n}x{p}/m={m}/plan={q}"] = dict(
                n=n, p=p, m=m, plan=q, **per_plan[q])
        if (n, p, m) not in MEMAGG_SHAPES:
            continue
        # read upd, the N - m untouched rows and w; write the m new rows
        # and red; read sel (int64) and valid (bool)
        b, by = bound(4 * (m * p + n * p + n + p) + 9 * m, 2 * n * p)

        def library():
            work.index_copy_(0, sel, upd)
            return torch.mv(work.T, w)
        rows[f"memagg/{n}x{p}/m={m}"] = dict(
            n=n, p=p, m=m, max_abs_err=float(err.max()),
            tolerance="panel bitwise, red atol = rtol = 1e-5, red bitwise "
                      "launch to launch, on every plan",
            plan=ag.memagg_plan(n, p, m),
            slab=ag.memagg_slab(n, p, ag.memagg_plan(n, p, m)),
            ms=cuda_ms(torch, lambda: ag.memory_aggregate_cuda(
                work, upd, sel, valid, w)),
            device_ms=device_ms(torch, lambda: ag.memory_aggregate_cuda(
                work, upd, sel, valid, w)),
            plans=per_plan,
            plain_ms=cuda_ms(torch, lambda: ag.memory_scatter_reduce_ref(
                work, upd, sel, valid, w)),
            bound_ms=b, bound_by=by, library_ms=cuda_ms(torch, library),
            library_device_ms=device_ms(torch, library),
            library="two calls: index_copy_ of the rows + torch.mv")
    rows["memagg/crossover"] = memagg_crossover(rows)

    rng = np.random.default_rng(0)            # the bench's recipe, in order
    for m, p in KRUM_SHAPES:
        x = torch.as_tensor(rng.normal(size=(m, p)).astype(np.float32),
                            device=dev)
        valid = torch.as_tensor(rng.random(m) < 0.95, device=dev)
        rows[f"krum/m={m}/p={p}"] = krum_row(np, torch, x, valid)
    # the plans' crossover at the main path's P (the last m the small plan
    # takes, and one either side), and a P below 32 that is no multiple of 4
    edge = next(m for m in range(1, 4096)
                if kr.krum_plan(m + 1, KRUM_SHAPES[0][1]) != "small")
    rng = np.random.default_rng(1)
    for m, p in ((edge - 1, KRUM_SHAPES[0][1]), (edge, KRUM_SHAPES[0][1]),
                 (edge + 1, KRUM_SHAPES[0][1])) + KRUM_EDGE_SHAPES:
        x = torch.as_tensor(rng.normal(size=(m, p)).astype(np.float32),
                            device=dev)
        valid = torch.ones(m, dtype=torch.bool, device=dev)
        rows[f"krum/m={m}/p={p}"] = krum_row(np, torch, x, valid)
    return rows


def memagg_crossover(rows: dict) -> dict:
    """The memagg plans' device_ms at every MEMAGG_SHAPES and
    MEMAGG_EDGE_SHAPES entry, beside the library call's where the row has
    one, and the largest N at P = 610 at which the small plan is no slower
    than the cluster plan (the plan function's ``SMALL_ROWS``)."""
    from repro_torch.kernels import aggregate as ag

    by_shape, small_wins = {}, []
    for n, p, m in sorted(MEMAGG_SHAPES + MEMAGG_EDGE_SHAPES):
        t = {q: rows[f"memagg/{n}x{p}/m={m}/plan={q}"]["device_ms"]
             for q in ag.memagg_plans(n, p, m)}
        lib = rows.get(f"memagg/{n}x{p}/m={m}", {})
        if "library_device_ms" in lib:
            t["library_ms"] = lib["library_ms"]
            t["library_device_ms"] = lib["library_device_ms"]
        by_shape[f"{n}x{p}"] = t
        if p == 610 and t["small"] <= t["cluster"]:
            small_wins.append(n)
    return {"device_ms": by_shape, "small_rows": ag.SMALL_ROWS,
            "small_no_slower_up_to_n_at_p610": max(small_wins, default=None)}


def krum_row(np, torch, x, valid) -> dict:
    """krum at one shape against its plain version, in the plan it takes
    and in the other one: exactly symmetric, a zero diagonal, within its
    bound, bitwise call to call; the selection card = CPU.  Timed in both
    plans."""
    from repro_torch.fed.aggregator_device import krum_select
    from repro_torch.kernels import krum as kr

    m, p = x.shape
    dp = kr.krum_pairwise_ref(x)
    n2 = torch.sum(x.double() ** 2, dim=1)
    scale = n2[:, None] + n2[None, :]
    # f32 round-off of two length-P sums in different orders
    tol = 8.0 * math.sqrt(p) * 2.0 ** -24 * scale
    plan = kr.krum_plan(m, p)
    other = next(q for q in kr.PLANS if q != plan)
    errs = {}
    for forced in (None, other):
        what = f"krum {m, p} ({forced or plan} plan)"
        dk = kr.krum_distances_cuda(x, plan=forced)
        if not torch.equal(dk, dk.T):
            raise AssertionError(f"{what}: panel not symmetric")
        if not torch.equal(torch.diagonal(dk), torch.zeros_like(dk[0])):
            raise AssertionError(f"{what}: diagonal not 0")
        if not torch.equal(kr.krum_distances_cuda(x, plan=forced), dk):
            raise AssertionError(f"{what}: not bitwise call to call")
        e = (dk.double() - dp.double()).abs()
        if not bool((e <= tol).all()):
            raise AssertionError(f"{what}: panel beyond its bound "
                                 f"({float((e / tol).max())} of it)")
        errs[forced] = e
    err = errs[None]
    f = max(1, m // 5)
    ck, _ = krum_select(x, valid, f, 3)
    cp, _ = krum_select(x.cpu(), valid.cpu(), f, 3)
    if not torch.equal(ck.cpu(), cp):
        raise AssertionError(f"krum {m, p}: selection differs")
    b, by = bound(4 * (m * p + m * m), m * (m + 1) * p)
    return dict(
        m=m, p=p, plan=plan, max_abs_err=float(err.max()),
        max_err_over_scale=float((err / scale).max()),
        tolerance="|dD| <= 8 sqrt(P) 2^-24 (|x_i|^2 + |x_j|^2); "
                  "exactly symmetric, zero diagonal, bitwise call to "
                  "call; selection bitwise",
        selection_bitwise=True, chosen=int(ck.sum()),
        ms=cuda_ms(torch, lambda: kr.krum_distances_cuda(x)),
        device_ms=device_ms(torch, lambda: kr.krum_distances_cuda(x)),
        other_plan=other, other_plan_max_abs_err=float(errs[other].max()),
        other_plan_device_ms=device_ms(
            torch, lambda: kr.krum_distances_cuda(x, plan=other)),
        plain_ms=cuda_ms(torch, lambda: kr.krum_pairwise_ref(x)),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(x, x).square()),
        library_device_ms=device_ms(
            torch, lambda: torch.cdist(x, x).square()),
        library="torch.cdist(x, x).square()")


# --------------------------------------------------------- phases 3, 4, 5
def quickstart_cfg(FLConfig, rounds=40):
    return FLConfig(rounds=rounds, sample_frac=0.2, local_steps=10,
                    batch_size=10, lr=0.1, eval_every=4, seed=0)


def slice_run(np, torch, dev) -> tuple[dict, dict]:
    from repro_torch.core.availability import make_mode
    from repro_torch.core.fairness import count_variance, gini
    from repro_torch.core.sampler import FedGSSampler, UniformSampler
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import logistic_regression
    from repro_torch.kernels import ops

    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)

    def mode():
        return make_mode("LN", n_clients=ds.n_clients, beta=0.5, seed=99)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                    mode(), quickstart_cfg(FLConfig), device=dev)
    card.install_oracle_graph(ds.opt_params)
    h_card = card.run()
    torch.cuda.synchronize()
    fedgs_s = time.perf_counter() - t0
    launches = ops.launches()
    if card.m != MAIN_M:
        raise AssertionError(f"quickstart M = {card.m}, expected {MAIN_M}")
    if not all(launches[k] > 0 for k in FEDGS_KERNELS):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")

    uni = FLEngine(ds, logistic_regression(), UniformSampler(), mode(),
                   quickstart_cfg(FLConfig), device=dev)
    h_uni = uni.run()
    for nm, hh in (("fedgs", h_card), ("uniform", h_uni)):
        if not (np.all(np.isfinite(hh.val_loss)) and len(hh.val_loss) == 11):
            raise AssertionError(f"{nm}: val_loss {hh.val_loss}")

    cpu = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                   mode(), quickstart_cfg(FLConfig), device="cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    h_cpu = cpu.run()
    same = [a == b for a, b in zip(h_card.all_sampled, h_cpu.all_sampled)]
    if len(same) != 40 or not all(same):
        raise AssertionError(f"card and CPU sets differ in rounds "
                             f"{[t for t, ok in enumerate(same) if not ok]}")
    dloss = float(np.max(np.abs(np.subtract(h_card.val_loss, h_cpu.val_loss))))
    if dloss > 1e-4:
        raise AssertionError(f"val_loss card vs CPU differs by {dloss}")

    # the card's 3DG against the plain build on the CPU
    from repro_torch.core.graph import build_3dg
    _, r_cpu, _ = build_3dg(ds.opt_params, device="cpu")
    r_card = card.install_oracle_graph(ds.opt_params)
    if not np.array_equal(np.isinf(r_card), np.isinf(r_cpu)):
        raise AssertionError("card R and CPU R: inf pattern differs")
    fin = np.isfinite(r_cpu)
    r_rel = float(np.max(np.abs(r_card[fin] - r_cpu[fin]) /
                         np.maximum(np.abs(r_cpu[fin]), 1e-38)))

    info = {"phase": "slice", "n": 30, "m": card.m, "rounds": 40,
            "fedgs_card_s": fedgs_s,
            "fedgs_best_loss": h_card.best_loss,
            "uniform_best_loss": h_uni.best_loss,
            "fedgs_count_var": count_variance(card.counts),
            "uniform_count_var": count_variance(uni.counts),
            "fedgs_gini": gini(card.counts), "uniform_gini": gini(uni.counts),
            "sets_identical_card_vs_cpu": True,
            "val_loss_max_diff_card_vs_cpu": dloss,
            "r_max_rel_card_vs_cpu": r_rel, "launches": launches}
    return info, launches


def robust_run(np, torch, dev) -> tuple[dict, dict]:
    """The quickstart under sign-flip against each defense on the card, and
    the memory and multikrum runs again on the CPU.  Returns (info, the
    launch counts of the memory and multikrum runs)."""
    from repro_torch.core.availability import make_mode
    from repro_torch.core.sampler import FedGSSampler
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.aggregator_device import make_aggregator_process
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.faults_device import make_fault_process
    from repro_torch.fed.models import logistic_regression
    from repro_torch.kernels import ops

    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    defenses = {
        "fedavg": lambda: make_aggregator_process("fedavg"),
        "median": lambda: make_aggregator_process("median"),
        "trimmed_mean": lambda: make_aggregator_process("trimmed_mean",
                                                        beta_trim=0.25),
        "multikrum": lambda: make_aggregator_process(
            "multikrum", krum_f=KRUM_F, krum_multi=KRUM_MULTI),
        "memory": lambda: make_aggregator_process("memory", gamma=0.9),
    }
    runs = [(d, "sign_flip") for d in defenses] + [("memory", "none")]

    def engine(defense, attack, device):
        fault = make_fault_process(attack, ds.n_clients, **(
            SIGN_FLIP if attack == "sign_flip" else {}))
        return FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                        make_mode("LN", n_clients=ds.n_clients, beta=0.5,
                                  seed=99),
                        quickstart_cfg(FLConfig), device=device,
                        aggregator=defenses[defense](), fault=fault)

    out, hists, cards, seconds = {}, {}, {}, {}
    for defense, attack in runs:
        key = f"{defense}/{attack}"
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = engine(defense, attack, dev)
        eng.install_oracle_graph(ds.opt_params)
        hist = eng.run()
        torch.cuda.synchronize()
        seconds[key] = time.perf_counter() - t0
        out[key] = ops.launches()
        if not (np.all(np.isfinite(hist.val_loss)) and len(hist.val_loss) == 11):
            raise AssertionError(f"{key}: val_loss {hist.val_loss}")
        if not all(out[key][k] > 0 for k in FEDGS_KERNELS):
            raise AssertionError(f"{key}: a FedGS kernel never ran: {out[key]}")
        want = {"memagg": 40 if defense == "memory" else 0,
                "krum": 40 if defense == "multikrum" else 0}
        if any(out[key][k] != v for k, v in want.items()):
            raise AssertionError(f"{key}: launches {out[key]}, want {want}")
        hists[key], cards[key] = hist, eng

    cpu_check = {}
    for key in ("memory/sign_flip", "multikrum/sign_flip"):
        defense, attack = key.split("/")
        cpu = engine(defense, attack, "cpu")
        cpu.install_graph_from_H(cards[key].sampler._h.cpu())
        hc, hp = hists[key], cpu.run()
        bad = [t for t, (a, b) in enumerate(zip(hc.all_sampled,
                                                hp.all_sampled)) if a != b]
        if len(hp.all_sampled) != 40 or bad:
            raise AssertionError(f"{key}: card and CPU sets differ in {bad}")
        if hc.chosen != hp.chosen or \
                len(hc.chosen) != (40 if defense == "multikrum" else 0):
            raise AssertionError(f"{key}: Krum rows differ card vs CPU")
        dloss = float(np.max(np.abs(np.subtract(hc.val_loss, hp.val_loss))))
        if dloss > 1e-4:
            raise AssertionError(f"{key}: val_loss card vs CPU {dloss}")
        cpu_check[key] = {"sets_identical": True,
                          "krum_rounds_compared": len(hc.chosen),
                          "val_loss_max_diff": dloss,
                          "val_loss_gate": 1e-4}
    acc = {k: h.val_acc[-1] for k, h in hists.items()}
    info = {"phase": "robust", "n": 30, "m": 6, "rounds": 40,
            "attack": {"sign_flip": SIGN_FLIP},
            "krum": {"f": KRUM_F, "multi": KRUM_MULTI},
            "final_val_acc": acc,
            "best_val_loss": {k: h.best_loss for k, h in hists.items()},
            "card_s": seconds, "launches": out, "card_vs_cpu": cpu_check,
            "finding_multikrum_beats_fedavg":
                acc["multikrum/sign_flip"] > acc["fedavg/sign_flip"],
            "finding_trimmed_mean_beats_fedavg":
                acc["trimmed_mean/sign_flip"] > acc["fedavg/sign_flip"]}
    return info, {"memagg": out["memory/sign_flip"]["memagg"],
                  "krum": out["multikrum/sign_flip"]["krum"]}


def vision_cfg(FLConfig):
    return FLConfig(rounds=VISION["rounds"], sample_frac=0.1, local_steps=10,
                    batch_size=32, lr=0.03, eval_every=5, seed=0)


def table3_probe(np, ds, n_probe: int = 128, seed: int = 0):
    """benchmarks/table3_graph.py's probe: Gaussian noise with the
    validation set's mean and covariance (paper §3.2)."""
    rng = np.random.default_rng(seed)
    xv = ds.x_val.reshape(len(ds.x_val), -1)
    cov = np.cov(xv.T) + 1e-4 * np.eye(xv.shape[1])
    z = rng.multivariate_normal(xv.mean(0), cov, n_probe).astype(np.float32)
    return z.reshape(n_probe, *ds.x_val.shape[1:])


def vision_run(np, torch, dev) -> tuple[dict, dict]:
    """Phase 5 (see the module docstring).  Returns (info, the launch
    counts of run (c))."""
    from repro_torch.core import graph as G
    from repro_torch.core import graph_device as gd
    from repro_torch.core.availability import host_draw, make_mode
    from repro_torch.core.fairness import count_variance
    from repro_torch.core.sampler import (FedGSSampler, PowerOfChoiceSampler,
                                          UniformSampler)
    from repro_torch.core.sampler_device import balance_z, fedgs_solve
    from repro_torch.core.sspp import secure_similarity_matrix
    from repro_torch.data.vision import make_cifar_like
    from repro_torch.fed.client import (default_batch_indices,
                                        make_local_trainer)
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import small_cnn
    from repro_torch.kernels import ops

    tiny = float(np.finfo(np.float32).tiny)
    n, rounds = VISION["n_clients"], VISION["rounds"]
    ds = make_cifar_like(n_clients=n, n_total=VISION["n_total"], seed=0)
    model = small_cnn(shape=(8, 8, 3), width=VISION["width"])
    n_params = sum(v.numel() for v in model.init(torch.Generator()).values())
    if n_params != VISION["params"]:
        raise AssertionError(f"small_cnn has {n_params} params")

    def mode():
        return make_mode("LN", n_clients=n, beta=0.5, seed=99)

    def engine(sampler, device):
        return FLEngine(ds, model, sampler, mode(), vision_cfg(FLConfig),
                        device=device)

    def checked(hist, name):
        if not (np.all(np.isfinite(hist.val_loss)) and len(hist.val_loss) == 7
                and len(hist.all_sampled) == rounds):
            raise AssertionError(f"vision {name}: {hist.val_loss}")
        return hist

    info, launches, seconds = {"phase": "vision", "n": n, "p": n_params,
                               "rounds": rounds}, {}, {}

    # (a) FedGS on the oracle 3DG, on the card
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = engine(FedGSSampler(alpha=1.0), dev)
    r_true = card.install_oracle_graph()
    h_a = checked(card.run(), "a")
    torch.cuda.synchronize()
    seconds["a_fedgs_card"] = time.perf_counter() - t0
    launches["a"] = ops.launches()
    if not all(launches["a"][k] > 0 for k in FEDGS_KERNELS) or \
            launches["a"]["fused_adjacency"]:
        raise AssertionError(f"vision (a): launches {launches['a']}")
    if card.m != 10 or torch.backends.cudnn.allow_tf32 or \
            not torch.backends.cudnn.deterministic:
        raise AssertionError(f"vision (a): M = {card.m}, cuDNN TF32 "
                             f"{torch.backends.cudnn.allow_tf32}, "
                             f"deterministic "
                             f"{torch.backends.cudnn.deterministic}")
    again = engine(FedGSSampler(alpha=1.0), dev)
    again.install_oracle_graph()
    h_again = again.run()
    if h_again.val_loss != h_a.val_loss or \
            h_again.all_sampled != h_a.all_sampled:
        raise AssertionError("vision (a): a second card run differs")

    # (b) the same on the CPU with the card's H, the same init and draws
    t0 = time.perf_counter()
    cpu = engine(FedGSSampler(alpha=1.0), "cpu")
    cpu.install_graph_from_H(card.sampler._h.cpu())
    h_b = checked(cpu.run(), "b")
    seconds["b_fedgs_cpu"] = time.perf_counter() - t0
    bad = [t for t in range(rounds)
           if h_a.all_sampled[t] != h_b.all_sampled[t]]
    if bad:
        raise AssertionError(f"vision (b): card and CPU sets differ in {bad}")
    gaps = np.abs(np.subtract(h_a.val_loss, h_b.val_loss))
    if float(gaps.max()) > VISION_LOSS_BOUND:
        raise AssertionError(f"vision (b): val_loss card vs CPU {gaps}")
    # the CNN itself, card vs CPU, from the run's init: the forward on the
    # validation split and round 0's local training (TF32 would show as
    # ~1e-3 here); then the card run once more with cuDNN off (PyTorch's
    # native convolution), whose gap to (a) is a third float32 order's
    trainer = make_local_trainer(model, local_steps=10, batch_size=32)
    params0 = model.init(torch.Generator().manual_seed(0))
    sel0 = np.asarray(h_a.all_sampled[0])
    idx0 = default_batch_indices(0, 0, ds.sizes[sel0], 10, 32)

    def on(device):
        p = {k: v.to(device) for k, v in params0.items()}
        with torch.no_grad():
            logits = model.logits(p, torch.as_tensor(ds.x_val, device=device))
        local = trainer(p, torch.as_tensor(ds.x[sel0], device=device),
                        torch.as_tensor(ds.y[sel0], dtype=torch.int64,
                                        device=device), 0.03, idx0.to(device))
        return logits.cpu(), {k: v.detach().cpu() for k, v in local.items()}
    (lc, pc), (lp, pp) = on(dev), on("cpu")
    cnn_err = {"forward": float((lc - lp).abs().max()),
               "one_local_round": max(float((pc[k] - pp[k]).abs().max())
                                      for k in pc)}
    if max(cnn_err.values()) > 1e-5:
        raise AssertionError(f"vision (b): the CNN card vs CPU {cnn_err}")
    torch.backends.cudnn.enabled = False
    try:
        native = engine(FedGSSampler(alpha=1.0), dev)
        native.install_graph_from_H(card.sampler._h)
        h_native = checked(native.run(), "b, cuDNN off")
    finally:
        torch.backends.cudnn.enabled = True
    gaps_native = np.abs(np.subtract(h_native.val_loss, h_a.val_loss))

    # (c) fedgs_solve on each round's dense Q = sym(alpha/N H - diag(z))
    h = card.sampler._h
    al = float(np.float32(1.0) / np.float32(n))
    counts = np.zeros(n)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(rounds):
        avail = host_draw(card.mode, t, card.cfg.avail_seed)
        z = balance_z(torch.as_tensor(counts, dtype=torch.float32,
                                      device=dev), card.m)
        q = al * h - torch.diag(z)
        q = 0.5 * (q + q.T)
        s = fedgs_solve(q, torch.as_tensor(avail, device=dev),
                        m=min(card.m, int(avail.sum())), max_sweeps=64)
        sel = np.flatnonzero(s.cpu().numpy())
        if sel.tolist() != h_a.all_sampled[t]:
            raise AssertionError(f"vision (c): round {t} {sel} != "
                                 f"{h_a.all_sampled[t]}")
        counts[sel] += 1
    torch.cuda.synchronize()
    seconds["c_dense_solves"] = time.perf_counter() - t0
    launches["c"] = ops.launches()
    if launches["c"]["swap_best"] == 0 or launches["c"]["greedy_argmax"] == 0:
        raise AssertionError(f"vision (c): launches {launches['c']}")

    # (d) FedGS on the dynamic 3DG
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dyn = engine(FedGSSampler(alpha=1.0), dev)
    dyn.install_dynamic_graph(refresh_every=10)
    h_d = checked(dyn.run(), "d")
    torch.cuda.synchronize()
    seconds["d_dynamic_card"] = time.perf_counter() - t0
    launches["d"] = ops.launches()
    builds = 1 + rounds // 10
    if any(launches["d"][k] != builds for k in
           ("pairwise_similarity", "adjacency", "floyd_warshall")):
        raise AssertionError(f"vision (d): launches {launches['d']}")
    cfg = gd.GraphConfig(similarity="functional")
    _, r_c, hd_c = gd.build_3dg(dyn._emb, cfg)
    _, r_p, hd_p = gd.build_3dg(dyn._emb.cpu(), cfg)
    if not torch.equal(dyn.sampler._h, gd.cap_and_normalize(hd_c)):
        raise AssertionError("vision (d): the sampler's H is not the last "
                             "rebuild's")
    dyn_err = {"r": r_close(torch, r_c.cpu(), r_p, atol=tiny),
               "h": r_close(torch, hd_c.cpu(), hd_p, atol=n * tiny),
               "edges": int(torch.isfinite(r_c).sum()) - n}

    # (e) Power-of-Choice and Uniform
    findings = {"fedgs": {"best_val_loss": h_a.best_loss,
                          "count_var": count_variance(card.counts)},
                "fedgs_dynamic": {"best_val_loss": h_d.best_loss,
                                  "count_var": count_variance(dyn.counts)}}
    for name, sampler in (("poc", PowerOfChoiceSampler()),
                          ("uniform", UniformSampler())):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = engine(sampler, dev)
        hist = checked(eng.run(), name)
        torch.cuda.synchronize()
        seconds[f"e_{name}_card"] = time.perf_counter() - t0
        findings[name] = {"best_val_loss": hist.best_loss,
                          "count_var": count_variance(eng.counts)}

    # (f) Table 3 in miniature: one local round of every client from a
    # fresh model, then the 3DG from its outputs and from its updates
    ops.reset_launches()
    params0 = {k: v.to(dev) for k, v in params0.items()}
    stacked = trainer(params0, card._x, card._y, 0.03, default_batch_indices(
        0, 0, ds.sizes, 10, 32).to(dev))
    emb = G.probe_embeddings(model.embed, stacked, torch.as_tensor(
        table3_probe(np, ds), device=dev))
    keys = sorted(params0)
    upd = torch.cat([(stacked[k] - params0[k]).reshape(n, -1) for k in keys],
                    dim=1)
    table3, f_launches = {}, {}
    for name, source, feats in (
            ("functional", G.functional_similarity, emb.cpu().numpy()),
            ("update_cosine", G.update_cosine_similarity, upd.cpu().numpy())):
        before = ops.launches()["pairwise_similarity"]
        v_pred = source(feats, device=dev)
        f_launches[name] = ops.launches()["pairwise_similarity"] - before
        best = {"f1": -1.0}
        for eps in EPS_SWEEP:
            r_pred = G.similarity_to_adjacency(G.normalize_01(v_pred,
                                                              device=dev),
                                               eps=eps, device=dev)
            p, rc, f1 = G.edge_f1(r_pred, r_true)
            if f1 > best["f1"]:
                best = {"eps": eps, "precision": p, "recall": rc, "f1": f1}
        table3[name] = best
    table3["launches"] = ops.launches()
    table3["similarity_launches"] = f_launches
    if upd.shape != (n, n_params) or \
            table3["launches"]["pairwise_similarity"] != 2 or \
            f_launches["update_cosine"] != 1:
        raise AssertionError(f"vision (f): {tuple(upd.shape)}, "
                             f"{table3['launches']}, {f_launches}")
    launches["f_update_cosine"] = f_launches["update_cosine"]

    # (g) SSPP's V through similarity="precomputed", card vs CPU
    v = secure_similarity_matrix(ds.label_dist, seed=0)
    ops.reset_launches()
    got = G.build_3dg(v, sim_kind="precomputed", device=dev)
    launches["g"] = ops.launches()
    want = G.build_3dg(v, sim_kind="precomputed", device="cpu")
    t = [torch.as_tensor(x) for x in got + want]
    sspp = {"vn_max_abs_err": float((t[0] - t[3]).abs().max()),
            "r": r_close(torch, t[1], t[4], atol=tiny),
            "h": r_close(torch, t[2], t[5], atol=n * tiny),
            "launches": launches["g"]}
    if launches["g"]["adjacency"] != 1 or launches["g"]["pairwise_similarity"]:
        raise AssertionError(f"vision (g): launches {launches['g']}")

    info.update({
        "sets_identical_card_vs_cpu": True,
        "card_run_repeats_bitwise": True,
        "val_loss_max_diff_card_vs_cpu": float(gaps.max()),
        "val_loss_diff_card_vs_cpu_per_eval": gaps.tolist(),
        "cnn_max_abs_err_card_vs_cpu": cnn_err,
        "val_loss_diff_cudnn_off_vs_on_per_eval": gaps_native.tolist(),
        "dense_solve_sets_identical": True,
        "dynamic_cpu_rebuild_max_abs_err": dyn_err,
        "samplers": findings, "table3": table3, "sspp": sspp,
        "seconds": seconds, "launches": launches,
        "finding_fedgs_count_var_below_uniform":
            findings["fedgs"]["count_var"] < findings["uniform"]["count_var"]})
    return info, {**launches["c"],
                  "pairwise_similarity/vision": launches["f_update_cosine"]}


def profiled_device_ms(torch, fn) -> dict:
    """``fn`` once under torch.profiler (warm): the device time of all its
    device-side events (kernels, memsets, copies), of Floyd–Warshall's
    kernels alone and of the adjacency kernel (the staged build's, or the
    fused build's in-place epilogue launch), in ms."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return {"all": sum(e.self_device_time_total for e in on_dev) / 1e3,
            "floyd_warshall": sum(e.self_device_time_total for e in on_dev
                                  if "fw_" in e.key) / 1e3,
            "adjacency": sum(e.self_device_time_total for e in on_dev
                             if "adjacency_kernel" in e.key) / 1e3}


def scale_run(np, torch, dev, *, n_clients: int, frac: float,
              rounds: int = 5, aggregator: str = "fedavg") -> dict:
    """FedGS on the card with the solve, the training and the aggregation
    timed per round (a sync around each), then one more round (with its
    eval) under torch.profiler for the device's busy share."""
    from repro_torch.core.availability import make_mode
    from repro_torch.core.graph_device import GraphConfig, build_h
    from repro_torch.core.sampler import FedGSSampler
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.aggregator_device import make_aggregator_process
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.models import logistic_regression
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    ds = make_synthetic(n_clients=n_clients, alpha=0.5, beta=0.5, seed=0)
    data_s = time.perf_counter() - t0
    sampler = FedGSSampler(alpha=1.0)

    def engine(n_rounds):
        cfg = FLConfig(rounds=n_rounds, sample_frac=frac, local_steps=10,
                       batch_size=10, lr=0.1, eval_every=1, seed=0)
        return FLEngine(ds, logistic_regression(), sampler,
                        make_mode("LN", n_clients=ds.n_clients, beta=0.5,
                                  seed=99), cfg, device=dev,
                        aggregator=make_aggregator_process(aggregator))

    eng = engine(rounds)
    if eng.m != engine_m(n_clients, frac):
        raise AssertionError(f"N={n_clients}: M = {eng.m}, expected "
                             f"{engine_m(n_clients, frac)}")
    times = {"solve": [], "train": [], "aggregate": []}

    def timed(fn, key):
        def wrapped(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            times[key].append((time.perf_counter() - t) * 1e3)
            return out
        return wrapped

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.install_oracle_graph(ds.opt_params)
    torch.cuda.synchronize()
    graph_ms = (time.perf_counter() - t0) * 1e3
    # the fused route (build_h) on the same features: its H must be the
    # engine's bit for bit; the fused kernel's launches are read here
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    h_fused = build_h(torch.as_tensor(ds.opt_params, dtype=torch.float32,
                                      device=dev), GraphConfig())
    torch.cuda.synchronize()
    fused_ms = (time.perf_counter() - t0) * 1e3
    fused_launches = ops.launches()
    if not torch.equal(h_fused, sampler._h) or \
            fused_launches["fused_adjacency"] != 1:
        raise AssertionError(f"N={n_clients}: build_h H differs from the "
                             f"engine's, or launches {fused_launches}")
    # each build again under the profiler: the device time of its kernels,
    # memsets and copies, and Floyd–Warshall's share of it
    builds_dev = {
        "staged": profiled_device_ms(
            torch, lambda: eng.install_oracle_graph(ds.opt_params)),
        "fused": profiled_device_ms(torch, lambda: build_h(torch.as_tensor(
            ds.opt_params, dtype=torch.float32, device=dev), GraphConfig()))}
    sample = sampler.sample
    sampler.sample = timed(sample, "solve")
    eng._trainer = timed(eng._trainer, "train")
    eng._server.apply = timed(eng._server.apply, "aggregate")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = eng.run()
    run_s = time.perf_counter() - t0
    sampler.sample = sample
    if not (np.all(np.isfinite(hist.val_loss)) and
            all(len(s) == eng.m for s in hist.all_sampled)):
        raise AssertionError(f"scale run: {hist.val_loss}, "
                             f"{[len(s) for s in hist.all_sampled]}")

    one = engine(1)
    one.run()                                   # warm
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        one.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): an operator's
    # row repeats the device time of the kernels it launched
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in on_dev)
    top = sorted(((e.key, e.self_device_time_total, e.count) for e in on_dev),
                 key=lambda x: -x[1])[:6]
    # the port's own kernels in that round, and the memsets
    port = {e.key[:60]: [e.self_device_time_total / 1e3, e.count]
            for e in on_dev if any(t in e.key for t in PORT_KERNEL_KEYS)}
    return {"phase": "scale", "n": n_clients, "m": eng.m, "rounds": rounds,
            "aggregator": aggregator,
            "x_bytes": int(ds.x.nbytes), "data_gen_s": data_s,
            "graph_build_ms": graph_ms, "fused_graph_build_ms": fused_ms,
            "graph_build_device_ms": builds_dev["staged"],
            "fused_graph_build_device_ms": builds_dev["fused"],
            "fused_launches": fused_launches["fused_adjacency"],
            "solve_ms_per_round": times["solve"],
            "train_ms_per_round": times["train"],
            "aggregate_ms_per_round": times["aggregate"], "run_s": run_s,
            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
            "val_loss": hist.val_loss,
            "profiled_round_wall_ms": wall_ms,
            "profiled_round_device_ms": dev_us / 1e3 if dev_us else None,
            "device_busy_share": dev_us / 1e3 / wall_ms if dev_us else None,
            "top_device_ms": [[k, t / 1e3, c] for k, t, c in top],
            "port_device_ms": port}

# ------------------------------------------------------------ phase 7
def visible_pairs(s: int, window: int) -> int:
    """Σ_i min(i + 1, window) over i < s: the (query, key) pairs one head
    of one sequence attends to."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_kernel_checks(np, torch, dev) -> dict:
    """The window attention kernel against its plain version at WA_SHAPES:
    f32 within 1e-5 absolute, bf16 within one bf16 ulp of the plain output
    (2⁻⁷·|o| + 1e-6).  Times by CUDA events: the kernel, the plain
    version, and scaled_dot_product_attention on (B, H, S, D) with the KV
    heads repeated (is_causal for full attention, a boolean band mask for
    a window).  Returns shape -> row."""
    import torch.nn.functional as F
    from repro_torch.kernels import window_attention as wa

    rows = {}
    for b, s, hq, hkv, d, dt, window in WA_SHAPES:
        dtype = getattr(torch, dt)
        w = s if window is None else window
        rng = np.random.default_rng(s + d)
        q, k, v = (torch.as_tensor(rng.normal(size=(b, s, h, d)),
                                   dtype=torch.float32).to(dtype).to(dev)
                   for h in (hq, hkv, hkv))
        got = wa.window_attention_cuda(q, k, v, window=w)
        want = wa.window_attention_plain(q, k, v, window=w)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        if dtype == torch.float32:
            gate = torch.full_like(err, 1e-5)
            tol = "f32: max |Δ| <= 1e-5"
        else:
            gate = 2.0 ** -7 * want.float().abs() + 1e-6
            tol = "bf16: |Δ| <= 2^-7 |o_plain| + 1e-6 (one bf16 ulp)"
        ok = bool((err <= gate).all())
        if not ok:
            raise AssertionError(f"window_attention {b, s, hq, hkv, d, dt, w}"
                                 f": beyond {tol} ({float(err.max())})")
        rep = hq // hkv
        qh = q.transpose(1, 2).contiguous()
        kh = k.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        vh = v.repeat_interleave(rep, 2).transpose(1, 2).contiguous()
        if window is None:
            def library():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      is_causal=True)
        else:
            pos = torch.arange(s, device=dev)
            band = (pos[None, :] <= pos[:, None]) & \
                (pos[None, :] > pos[:, None] - w)

            def library():
                return F.scaled_dot_product_attention(qh, kh, vh,
                                                      attn_mask=band)
        lib_err = float((library().transpose(1, 2).float() -
                         want.float()).abs().max())
        elt = q.element_size()
        pairs = b * hq * visible_pairs(s, w)
        bnd, by = bound(elt * (2 * b * s * hq * d + 2 * b * s * hkv * d),
                        4 * d * pairs, PEAK_BF16_OPS_PER_S
                        if dtype == torch.bfloat16 else PEAK_F32_OPS_PER_S)
        rows[f"window_attention/{b}x{s}x{hq}/{hkv}x{d}/{dt}/w={w}"] = dict(
            shape=[b, s, hq, hkv, d], dtype=dt, window=w,
            body="tensor cores" if dtype == torch.bfloat16 and d <= 128
            else "CUDA cores",
            visible_pairs=pairs, max_abs_err=float(err.max()), tolerance=tol,
            max_err_over_gate=float((err / gate).max()),
            ms=cuda_ms(torch, lambda: wa.window_attention_cuda(
                q, k, v, window=w)),
            device_ms=device_ms(torch, lambda: wa.window_attention_cuda(
                q, k, v, window=w)),
            plain_ms=cuda_ms(torch, lambda: wa.window_attention_plain(
                q, k, v, window=w), max_reps=20),
            bound_ms=bnd, bound_by=by, library_ms=cuda_ms(torch, library),
            library_device_ms=device_ms(torch, library),
            library="F.scaled_dot_product_attention, KV heads repeated, " +
                    ("is_causal=True" if window is None else
                     "boolean band mask"),
            library_max_abs_err=lib_err)
    return rows


def _gated_agreement(torch, card, cpu):
    """Greedy tokens card vs CPU per row of logits: where the card's top-2
    margin exceeds the row's largest |Δlogit| the argmax must agree.
    Returns (agreeing rows, rows, gated rows)."""
    top2 = card.float().topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    gap = (card.float() - cpu.float()).abs().max(dim=-1).values
    same = card.argmax(-1) == cpu.argmax(-1)
    gated = margin > gap
    if not bool(same[gated].all()):
        raise AssertionError(f"serve (c): greedy tokens differ where the "
                             f"margin {margin.tolist()} exceeds the gap "
                             f"{gap.tolist()}")
    return int(same.sum()), same.numel(), int(gated.sum())


def _lm_close(torch, got, want, what: str) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs()
    if not bool((err <= LM_ATOL + LM_RTOL * want.float().cpu().abs()).all()):
        raise AssertionError(f"serve {what}: logits beyond atol {LM_ATOL}, "
                             f"rtol {LM_RTOL} ({float(err.max())})")
    return float(err.max())


def serve_run(np, torch, dev) -> tuple[dict, int]:
    """Phase 7: (b) serve smollm-135m through ``launch.serve.main`` with the
    launch counts reset before and read after (30 window-attention
    launches, one per layer, none in decode), then a warm repeat timed and
    profiled; (c) a second request card vs CPU with the same weights,
    prefill and teacher-forced decode; (d) the long-context variant's
    prefill of 8,191 tokens + one decode step against the prefill of
    8,192.  Returns (info, (b)'s launches of the kernel)."""
    import contextlib
    import dataclasses
    import io
    import re
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    t_phase = time.perf_counter()
    cfg = get_config(SERVE_ARCH)
    info = {"phase": "serve", "arch": SERVE_ARCH, "dtype": cfg.dtype,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
            "vocab": cfg.padded_vocab}
    # (b) the user's entry point
    argv = ["--arch", SERVE_ARCH, "--batch", str(SERVE_MAIN["batch"]),
            "--prompt-len", str(SERVE_MAIN["prompt"]), "--gen",
            str(SERVE_MAIN["gen"]), "--seed", "0"]
    out = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv)
    main_s = time.perf_counter() - t0
    launched = ops.launches()
    printed = out.getvalue().splitlines()
    for line in printed:
        emit(line)
    others = {k: n for k, n in launched.items()
              if n and k != "window_attention"}
    if launched["window_attention"] != cfg.n_layers or others:
        raise AssertionError(f"serve (b): launches {launched}, expected "
                             f"{cfg.n_layers} of window_attention only")
    if gen.shape != (SERVE_MAIN["batch"], SERVE_MAIN["gen"]) or \
            gen.min() < 0 or gen.max() >= cfg.padded_vocab:
        raise AssertionError(f"serve (b): tokens {gen.shape}, range "
                             f"[{gen.min()}, {gen.max()}]")
    m = re.match(r"prefill: ([0-9.]+)s  decode: ([0-9.]+)s \(([0-9.]+) "
                 r"tok/s\)", printed[1])
    info["b"] = {"argv": argv, "launches": launched["window_attention"],
                 "main_s": main_s, "printed_prefill_s": float(m.group(1)),
                 "printed_decode_s": float(m.group(2)),
                 "printed_tok_per_s": float(m.group(3)),
                 "first_sequence": gen[0][:16].tolist()}

    # the same request warm: generate() twice on the same weights, the
    # second timed; then one prefill and 4 decode steps profiled
    params = lm.init_params(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_MAIN["batch"], SERVE_MAIN["prompt"])),
        device=dev)
    serve.generate(params, cfg, tokens, gen=SERVE_MAIN["gen"])
    torch.cuda.reset_peak_memory_stats()
    warm, t = serve.generate(params, cfg, tokens, gen=SERVE_MAIN["gen"])
    if not np.array_equal(warm.cpu().numpy(), gen):
        raise AssertionError("serve (b): the warm repeat's tokens differ "
                             "from main's")
    n_tok = SERVE_MAIN["batch"] * SERVE_MAIN["gen"]
    info["b"].update({
        "warm_prefill_ms": t["prefill_s"] * 1e3,
        "warm_decode_ms_per_step": t["decode_s"] * 1e3 /
        (SERVE_MAIN["gen"] - 1),
        "warm_tok_per_s": n_tok / t["decode_s"],
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated())})
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for what, steps in (("prefill", 0), ("decode", 4)):
        logits, cache = lm.prefill(params, cfg, {"tokens": tokens},
                                   max_len=SERVE_MAIN["prompt"] + steps + 1)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            if steps == 0:
                lm.prefill(params, cfg, {"tokens": tokens})
            for _ in range(steps):
                logits, cache = lm.decode_step(params, cfg,
                                               logits.argmax(-1), cache)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        on_dev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(e.self_device_time_total for e in on_dev)
        top = sorted(((e.key, e.self_device_time_total, e.count)
                      for e in on_dev), key=lambda x: -x[1])[:8]
        info["b"][f"profiled_{what}"] = {
            "decode_steps": steps, "wall_ms": wall_ms,
            "device_ms": dev_us / 1e3 if dev_us else None,
            "device_busy_share": dev_us / 1e3 / wall_ms if dev_us else None,
            "kernel_launches": sum(e.count for e in on_dev),
            "top_device_ms": [[k[:90], us / 1e3, c] for k, us, c in top]}

    # (c) a second request on the card, then the same weights on the CPU
    params_cpu = lm.init_params(cfg, seed=1, device="cpu")
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (SERVE_CHECK["batch"], SERVE_CHECK["prompt"])))
    n_gen = SERVE_CHECK["gen"]
    served, _ = serve.generate(params, cfg, toks.to(dev), gen=n_gen)
    logits, cache = lm.prefill(params, cfg, {"tokens": toks.to(dev)},
                               max_len=SERVE_CHECK["prompt"] + n_gen)
    card_logits, card_toks = [logits], [logits.argmax(-1)]
    for _ in range(n_gen - 1):
        logits, cache = lm.decode_step(params, cfg, card_toks[-1], cache)
        card_logits.append(logits)
        card_toks.append(logits.argmax(-1))
    card_toks = torch.stack(card_toks, 1)
    if not torch.equal(card_toks, served):
        raise AssertionError("serve (c): generate() and the step loop differ")
    def teacher_forced(params, cfg, toks, forced):
        """Prefill ``toks``, then decode ``forced`` (B, n_gen) in turn: the
        logits of every step."""
        logits, cache = lm.prefill(params, cfg, {"tokens": toks},
                                   max_len=toks.shape[1] + n_gen)
        out = [logits]
        for i in range(1, n_gen):
            logits, cache = lm.decode_step(params, cfg, forced[:, i - 1],
                                           cache)
            out.append(logits)
        return out

    cpu_logits = teacher_forced(params_cpu, cfg, toks, card_toks.cpu())
    errs, agree = [], []
    for i, (card, cpu) in enumerate(zip(card_logits, cpu_logits)):
        errs.append(_lm_close(torch, card, cpu, f"(c) step {i}"))
        agree.append(_gated_agreement(torch, card.cpu(), cpu))
    # findings, not gated: each side against an f32 run of the same
    # weights on the CPU, and the card with cuBLAS's reduced-precision
    # bf16 reduction off
    truth = teacher_forced({k: v.float() for k, v in params_cpu.items()},
                           dataclasses.replace(cfg, dtype="float32"), toks,
                           card_toks.cpu())
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        exact = teacher_forced(params, cfg, toks.to(dev), card_toks)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            flag

    def gaps(a, b):
        return [float((x.float().cpu() - y.float().cpu()).abs().max())
                for x, y in zip(a, b)]
    info["c"] = {"request": SERVE_CHECK, "max_abs_err_per_step": errs,
                 "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}",
                 "greedy_agree": sum(a[0] for a in agree),
                 "greedy_total": sum(a[1] for a in agree),
                 "greedy_gated": sum(a[2] for a in agree),
                 "card_tokens": card_toks.cpu().tolist(),
                 "max_abs_logit": float(truth[0].abs().max()),
                 "card_vs_f32": gaps(card_logits, truth),
                 "cpu_vs_f32": gaps(cpu_logits, truth),
                 "card_no_reduced_reduction_vs_cpu": gaps(exact, cpu_logits),
                 "card_no_reduced_reduction_vs_f32": gaps(exact, truth),
                 "max_abs_err_range_before": SERVE_GAPS_BEFORE["c"]}

    # (d) past the window on the card: prefill S − 1, decode the last token
    cfg_w = dataclasses.replace(cfg, attention="sliding_window",
                                window=LONG_WINDOW)
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (1, LONG_S)), device=dev)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full, _ = lm.prefill(params, cfg_w, {"tokens": toks})
    torch.cuda.synchronize()
    long_prefill_ms = (time.perf_counter() - t0) * 1e3
    _, cache = lm.prefill(params, cfg_w, {"tokens": toks[:, :-1]},
                          max_len=LONG_S)
    step, _ = lm.decode_step(params, cfg_w, toks[:, -1], cache)
    launched_d = ops.launches()["window_attention"]
    # finding, not gated: both against the f32 prefill of the same weights
    truth, _ = lm.prefill({k: v.float() for k, v in params.items()},
                          dataclasses.replace(cfg_w, dtype="float32"),
                          {"tokens": toks})
    info["d"] = {"s": LONG_S, "window": LONG_WINDOW,
                 "max_abs_err": _lm_close(torch, step, full, "(d)"),
                 "prefill_vs_f32": float((full.float() - truth).abs().max()),
                 "decode_vs_f32": float((step.float() - truth).abs().max()),
                 "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}",
                 "max_abs_err_before": SERVE_GAPS_BEFORE["d"],
                 "prefill_ms": long_prefill_ms, "launches": launched_d}
    if info["d"]["launches"] != 2 * cfg.n_layers:
        raise AssertionError(f"serve (d): {info['d']['launches']} launches")
    info["seconds"] = time.perf_counter() - t_phase
    return info, launched["window_attention"]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on the "
              "GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = smi_line()
    emit(smi)
    t0 = time.perf_counter()
    built = _build.build(verbose=True)
    build_s = time.perf_counter() - t0
    OUT.mkdir(exist_ok=True)
    (OUT / "ptxas.txt").write_text("\n".join(f"== {k}\n{v['log']}"
                                             for k, v in built.items()))
    emit({"phase": "build", "seconds": build_s, "sources": sorted(built),
          "seconds_per_source": {k: v["seconds"] for k, v in built.items()},
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0)})

    per_n = {}
    for n in SIZES:
        rows = kernel_checks(np, torch, n, dev)
        per_n[n] = rows
        emit({"phase": "kernels", "n": n, "card": smi, "rows": rows})
    emit({"phase": "kernels", "card": smi, "launch_floor": {
        "kernel": "empty, one warp (csrc/solver.cu empty_launch)",
        "device_ms": launch_floor_ms(torch)}})
    emit({"phase": "kernels", "swap_best_fused_edges": True, "card": smi,
          "rows": swap_fused_edge_checks(np, torch, dev)})
    emit({"phase": "kernels", "swap_best_edges": True, "card": smi,
          "rows": swap_gain_edge_checks(np, torch, dev)})
    emit({"phase": "kernels", "floyd_warshall_edges": True, "card": smi,
          "rows": fw_edge_checks(np, torch, dev)})
    emit({"phase": "kernels", "fused_adjacency_edges": True, "card": smi,
          "rows": fused_edge_checks(np, torch, dev)})
    emit({"phase": "kernels", "greedy_argmax_threshold": True, "card": smi,
          "rows": argmax_edge_checks(np, torch, dev)})
    staged_rows = {**staged_kernel_checks(np, torch, dev),
                   **swap_gain_checks(np, torch, dev)}
    emit({"phase": "kernels", "staged": True, "card": smi,
          "rows": staged_rows})
    emit({"phase": "graph_routes", "card": smi,
          "checks": graph_route_checks(np, torch, dev)})
    robust_rows = robust_kernel_checks(np, torch, dev)
    emit({"phase": "kernels", "robust": True, "card": smi,
          "rows": robust_rows})

    info, launches = slice_run(np, torch, dev)
    emit(info)
    info, robust_launches = robust_run(np, torch, dev)
    emit(info)
    info, vision_launches = vision_run(np, torch, dev)
    emit(info)
    for n, frac in ENGINE_RUNS:
        info = scale_run(np, torch, dev, n_clients=n, frac=frac)
        emit(info)
    launches = {**launches, **robust_launches,
                "fused_adjacency": info["fused_launches"],
                "swap_best": vision_launches["swap_best"],
                "pairwise_similarity/vision":
                    vision_launches["pairwise_similarity/vision"]}
    emit(scale_run(np, torch, dev, n_clients=ENGINE_RUNS[1][0],
                   frac=ENGINE_RUNS[1][1], aggregator="memory"))
    t0 = time.perf_counter()
    attn_rows = attention_kernel_checks(np, torch, dev)
    emit({"phase": "kernels", "attention": True, "card": smi,
          "seconds": time.perf_counter() - t0, "rows": attn_rows})
    info, launches["window_attention"] = serve_run(np, torch, dev)
    emit(info)
    main_rows = {
        "pairwise_similarity": staged_rows[
            "pairwise_similarity/{}x{}".format(*STAGED_SHAPES[0])],
        "pairwise_similarity/vision": staged_rows[
            "pairwise_similarity/{}x{}".format(*STAGED_SHAPES[-1])],
        "adjacency": staged_rows["adjacency/{}x{}".format(*STAGED_SHAPES[0])],
        # the greedy step's call: A_t and S read in the kernel
        "greedy_argmax": per_n[MAIN_N]["greedy_argmax/taken"],
        "swap_best": staged_rows[
            "swap_best/m={}/n={}".format(*SWAP_GAIN_SHAPES[-1])],
        "memagg": robust_rows["memagg/{}x{}/m={}".format(*MEMAGG_SHAPES[0])],
        "krum": robust_rows["krum/m={}/p={}".format(*KRUM_SHAPES[0])],
        "window_attention": next(iter(attn_rows.values()))}

    kernels = []
    if any(launches[name] <= 0 for name in KERNEL_INFO):
        raise AssertionError(f"a ported kernel never ran: {launches}")
    for name, (source, replaces) in KERNEL_INFO.items():
        row = main_rows.get(name) or per_n[MAIN_N][
            f"{name}/m={MAIN_M}" if name == "swap_best_fused" else name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "device_ms": row["device_ms"],
                        "library_device_ms": row.get("library_device_ms"),
                        "plan": row.get("plan") or row.get("body") or
                        "only",
                        **{k: row[k] for k in ("n", "d", "m", "p", "shape",
                                               "dtype", "window")
                           if k in row},
                        **({} if "n" in row or "shape" in row
                           else {"n": MAIN_N}),
                        "parity": "pass"})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    (OUT / "chip_smoke.jsonl").write_text("\n".join(_log_lines) + "\n")
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
