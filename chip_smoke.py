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
     The cell axis: the batched FedGS solve's two kernels (greedy_cells,
              swap_cells) at (B, m, N) = (56, 10, 100), the benchmark's
              sweep, and (7, 6, 30), the scan phase's FedGS batch, held
              launch by launch through a whole solve against their plain
              versions on the same inputs (s bitwise, r within 1e-6
              relative), then timed over the solve's own launches, with
              the bytes those launches request as the bound.
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
  8. scan     the batched sweep engine (``fed/scan_engine.ScanEngine``)
              at the quickstart's width: N = 30, P = 610, M = 6, E = 10, B
              = 10, 20 rounds (cut from 40 for time), max_sweeps 64.  (a)
              the seven Table-1 modes
              x FedGS alpha = 1 on host masks as one ``run_batch``, each
              cell against FLEngine on the card with the same masks, init
              and batch indices: the same sets and counts every round,
              val_loss within 1e-4, B3/B4 launches exactly 7 x the slice
              phase's FLEngine run's a round.  (b) eight cells on the device
              processes (LN table, Gilbert–Elliott, cluster, drift,
              deadline; the four samplers; FedAvg, memory, multi-Krum; one
              20% sign-flip cell), every draw made on the host from a seed:
              the batch equals each cell's own run on the card (sets,
              val_loss within 1e-5) and the CPU batch (sets and Krum rows
              over the 20 rounds; val_loss within 1e-4 round by round,
              each card round replayed on the CPU from the card's state:
              free-running, some cells amplify round-off to ~1e-3, as a
              one-ulp change of their init does on the CPU alone, both
              printed), memagg and krum launched exactly once a round per
              memory / Krum cell.  The same cells on the port's own device
              draws: wall ms per round, host syncs (torch's sync debug
              mode), launches per round and one profiled batch round.
              (c) two FedGS cells on the dynamic 3DG (rebuilt every 5
              rounds): B1 = B2 = 2 x (1 + 4); replayed on the CPU from the
              card's state, the same sets every round and each rebuilt H
              within rtol 1e-4 (the round where free-running sets part,
              printed).  Batch and one-by-one seconds printed.
  9. runtime  checkpoints, the stream, telemetry and the service at the
              scan phase's width.  (a) the scan phase's 8 mixed cells on
              the engine's own device draws, 20 rounds checkpointed every
              10: the default run (pipelined, the carry handle consumed),
              async_pipeline=False, donate_carry=False and telemetry on,
              each bitwise the default in every history field and every
              checkpoint array; a fresh engine resumed from the round-10
              file, bitwise the unbroken run, launching B3 = 3 x 6 x 10
              and B3/B4/B6/B7 exactly as the unbroken run's last segment
              (counted at the inline stream's yields); the pipelined
              run's host syncs (torch's sync debug mode plus the main
              thread's snapshot waits) at most one per segment and the
              final read.  (b) FLEngine: the slice phase's FedGS run and
              the robust phase's memory/sign_flip run, a head of 20
              rounds saved at round 20, a resumed tail bitwise the
              unbroken 40 rounds (sets, val_loss, final params), B3 =
              120, B4 = 1,280 (and memagg 20) in the tail.  (c) SimService:
              4 FedGS cells, drain(segment=10) streams 8 updates whose
              histories are bitwise run_batch's; metrics_text() parses as
              Prometheus text.  (d) telemetry card vs CPU over 10 rounds on
              host draws, each card round replayed on the CPU from the
              card's state: avail_rate, n_selected and staleness_hist
              exact, the float metrics within rtol 1e-4.  Prints the
              writer's write_ms / blocked_ms / queue high-watermark, the
              inline and pipelined walls and the checkpoint's bytes.
 10. plans    the committed plan table (``kernels/tuned_plans.json``, card
              entries only): each entry's wrapper call with plan=None
              agrees with its plain version and its default-plan function
              returns the table's winner; at both edges of each entry's
              tier the default plan is the winner where the winner takes
              the shape, else the heuristic; one small spec per kernel
              tuned afresh into a temp file (each candidate held against
              its plain version first; the committed file unchanged); the
              winners printed beside the heuristic plans, ms per
              candidate.
 11. fedsim   ``launch.fedsim.run`` at N = 4096 (M = 416, the reference's
              cohort padded to the dp width; E = B = 10,
              n_max 512, 32 sweeps, memory aggregator): the round, server
              pipeline and aggregator programs, each once cold and once
              measured; B1 = B2 = 1, B3 = 416, B4 = 32 and B6 = 1 launches
              per measured call; the pipeline's set bitwise
              ``fedgs_select``'s on the same H built outside the twin;
              each program's memory and device ms; B1, B2, B3, B4 and B6
              at the programs' shapes, each call's device ms (a CUDA graph
              of calls) beside its bound.
 12. mesh     the (cells, silo) mesh on ``torch.distributed``, on the
              scan phase's 8 mixed cells (host draws), 10 rounds: (a) a
              one-rank NCCL world, mesh (1, 1), bitwise the unmeshed run;
              (b) two ranks sharing the card over gloo (CUDA tensors
              staged through the host): (2, 1) gather, (1, 2) gather and
              (1, 2) psum, sets, pad masks, counts and Krum rows bitwise
              the single-device run, val_loss within 1e-5, every rank the
              same whole batch; B3/B4/B6/B7 launches summed over the
              (2, 1) ranks, and on each (1, 2) rank, equal to the
              single-device run's; (c) the (2, 1) run's checkpoint (saved
              every round) resumed with no mesh: the checkpointed rounds
              bitwise the unbroken (2, 1) run's, the resumed round's
              decisions bitwise and its val_loss within 1e-5 (CUDA's
              batched products are not batch-invariant).
 13. examples the five example twins on the card, as users run them:
              the quickstart's FedGS and uniform sets equal the slice
              phase's runs round for round; the availability scenarios'
              five cells, run as one batch, equal their own runs; the
              vision twin (3 rounds, 20 clients) and serve_llm (batch 4,
              8 tokens) exit cleanly; train_federated_lm (its reduced
              defaults, 2 rounds) has ``launch.train.main``'s sets and
              counts.  Their printouts go to ``chiprun_out/examples/``.
 14. train    federated LM training, ``launch.train.main`` as users run
              it: (a) smollm-135m at full width (bf16, P = 134,515,008),
              16 clients, M = 4, E = B = 4, S = 64, FedGS under SLN, the
              memory aggregator over the (16, P) panel (more than 2^31
              entries), 5 rounds: every parameter finite; each round's
              set equal to the plain ``fedgs_select`` on the CPU from the
              card's H, counts and mask; launches B5a = B5b = B2 = 1,
              B3 = min(M, |A_t|) and B4 = 64 a round, B6 = 1 a round,
              B9 = 0; memagg's first call against its plain version on
              the same panel (panel bitwise, red within 1e-5); s a
              round, ms a local step, tokens/s, the server update's ms,
              peak memory, one more round profiled (busy share); memagg
              at (16, P, 4) timed beside its bound.  (b) Krum under a 25%
              sign-flip, 3 rounds: each round's rows bitwise the plain
              selection's on the CPU from the same stacked updates; B7 at
              (4, P) timed beside its bound.  (c) one local step at full
              width, card vs CPU from the same weights and batch: f32
              loss within 1e-5 and the gradient's norm of difference
              within 1e-4 relative, bf16 printed; the AdamW update's gap
              printed.  (d) the reduced f32 config, 5 rounds, memory and
              Krum (sign-flip), card vs CPU on the same host batch rows:
              sets, counts and Krum rows bitwise; val_loss within 1e-4
              each round from the card's state (the round replayed on the
              CPU from the card's params and server state), the
              free-running gap printed.  (e) granite-moe-1b-a400m at full
              width: ``serve.main`` (24 B9 launches, 8 decode steps) and
              its logits card vs CPU within atol 5e-2, rtol 2e-2; one
              train step (remat, AdamW with bf16 moments) finite, and
              again, bit for bit.
 16. families  (runs after 14) the SSM, hybrid, VLM and audio families at
              full width, bf16, random weights drawn on the card from a
              seed: mamba2-780m (arXiv:2405.21060), hymba-1.5b
              (arXiv:2411.13676), llava-next-mistral-7b (hf:llava-hf/
              llava-v1.6-mistral-7b-hf; 2,880 image tokens) and
              seamless-m4t-large-v2 (arXiv:2308.11596; 1,024 frames).
              (a) ``serve.main`` at batch 8, prompt 64, gen 32 (``--draw
              device``): B9 launches per prefill 0, 32, 32 and 24 and no
              other kernel; every logit of the same request finite and
              the step loop's tokens serve.main's; a warm repeat timed
              (prefill ms, decode tok/s), peak memory, one prefill
              profiled (busy share).  (b) card vs CPU from the same
              weights, batch 2, a 32-token prompt, 8 decode steps fed the
              card's tokens (seamless over 64 frames): the free-running
              logits within atol 5e-2, rtol 2e-2, or where bf16 round-off
              carries them past it, every layer (the encoder's first) and
              step from the card's state through the ``tap`` seam; llava
              layer by layer from the card's state on layers 0, 15 and 31
              (2,912 positions, 8 steps), only those layers' weights on
              the host.  (c) llava, batch 1, a prefill of exactly one
              window (2,880 image + 1,216 text positions), then 16 decode
              steps with ``lm.RING_CACHE`` on a ring of 4,096 slots and on
              a grown cache: from the grown run's state every layer and
              step within the serve gates, the ring slots bitwise, the
              ring attention in f32 within 1e-5; free-running, greedy
              tokens equal wherever the top-2 margin exceeds the gap;
              then the window active, ``serve.generate`` over 4,928
              positions (2,880 image + 2,048 text): B9 = 32.  (d)
              hymba padded to 48/6 heads (``embed_params_padded``):
              prefill logits within the serve gates of the unpadded run's,
              B9 = 32 at 48/6.  (e) B9 against its plain version at
              FAMILY_WA_SHAPES (the bf16 tensor-core body and the f32
              CUDA-core body), each timed beside its bound and
              scaled_dot_product_attention.  (f) one remat value-and-grad
              at 4 x 64 tokens, full width, for mamba2 and hymba: finite
              and bitwise twice; the reduced f32 config of all four card
              vs CPU: loss within 1e-5, the gradient's norm of difference
              within 1e-4 relative.  One JSON line a part.
 17. dryrun   (runs after 16) the LM stack's scale-out.  (a) the dry-run
              (``launch/dryrun.py``) through its CLI in one process with
              expandable segments, 10 archs x 4 shapes x {pod1, pod2}: each
              pair planned on the production mesh, its step traced on meta
              tensors, and, where the plan fits the card's free memory,
              one device's argument shards allocated: every record ok, the
              allocator's requested bytes equal to the plan and its
              allocated bytes to the plan's 512-byte blocks; per pair the
              arguments in GB per device, fits, flops per device, dominant
              term and seconds.  (b) smollm-135m at full width in f32, one
              SGD train step at lr 1 under the baseline and under each
              variant of VARIANT_RUNS (batches and references there): loss
              and gradients within each variant's stated bound; each
              step's ms (CUDA events) beside its reference's.  (c)
              granite-moe-1b-a400m's prefill at 8 x 64 under moe_grouped
              on the pod1 context (16 groups of 32 tokens): logits finite,
              24 B9 launches; in f32 at 2 layers, card vs CPU from the
              card's state, the card's expert choices forced and the
              CPU's own held where its margin is clear.  (d) fedsim at N =
              4096 on pod2 (``--multi-pod``, dp 32) with phase 11's gates
              (M = 416), beside pod1's record.
 15. the ``{"kernels": [...]}`` line (times at the main path's shapes:
     N = 30, M = 6, P = 610; the similarity also at the vision phase's
     (100, 13946) update-cosine 3DG, with that call's launches; the dense
     swap at the vision solve's (m, N) = (10, 100); window attention at
     smollm's prefill, and (``window_attention/<family>``) at phase 16's
     bf16 shapes, each with the B9 launches of the run that prefills at
     that shape; the cell axis's two kernels at the benchmark's (56, 10,
     100); ``scan_launches``: the scan phase's gated runs;
     ``train_launches``: the train phase's (a) and (b); every count a
     kernel's own: the per-step B3 and B4 rows leave out the cell axis's
     launches, which ``ops.launches()`` counts under their names too).
The last line is ``{"ok": true, "device": {...}}``.  The script needs a CUDA
device and the repository's ``src/`` beside it; without either it exits
non-zero and prints no result.  Full output also goes to
``chiprun_out/chip_smoke.jsonl``.
"""
from __future__ import annotations

import json
import math
import os
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
# phase 8: the batched sweep engine at the quickstart's width (FedGSSampler's
# max_sweeps; the dynamic 3DG rebuilt every 5 rounds)
SCAN = {"rounds": 20, "max_sweeps": 64, "graph_refresh_every": 5}
# the slice phase's FLEngine rounds (the scan phase's launch gates scale
# its per-round counts)
SLICE_ROUNDS = 40
# phase 9: the runtime layer on the scan phase's cells: checkpoints every 10
# rounds (a fresh engine resumes from round 30), FLEngine's head of 20
# rounds, the service's 4 FedGS cells, telemetry card vs CPU over 10 rounds
RUNTIME = {"ckpt_every": 10, "fl_head": 20, "svc_cells": 4, "tel_rounds": 10}
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
    # the cell axis: a greedy step, or a sweep, of every FedGS cell of a
    # batch in one launch, with the step's glue inside
    "greedy_cells": ("src/repro_torch/kernels/csrc/solver.cu",
                     "src/repro/kernels/solver.py:83"),
    "swap_cells": ("src/repro_torch/kernels/csrc/solver.cu",
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


def own_launches(counts: dict, name: str) -> int:
    """A kernel's own launches in an ``ops.launches()`` count, which counts
    the cell axis's launches under the per-step kernels' names too."""
    from repro_torch.kernels.ops import STANDS_FOR
    return counts.get(name, 0) - sum(counts.get(c, 0) for c, per_step in
                                     STANDS_FOR.items() if per_step == name)


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


# the cell axis's (B, m, N, max_sweeps): the benchmark's sweep (56 cells, M
# = 10 of N = 100, 32 sweeps) and the scan phase's FedGS batch (7 cells)
CELLS_SHAPES = ((56, 10, 100, 32), (7, 6, 30, SCAN["max_sweeps"]))


def cells_bytes(n: int, m: int, before, after, avail, *, greedy: bool,
                first: bool = False) -> int:
    """Bytes one cell-axis launch's loads and stores request, summed over
    the cells, from each cell's state before and after it (numpy s (B, N)
    bool; avail (B, N)), as csrc/solver.cu's two kernels issue them.
    greedy: diag (H_kk, z_k), avail and, after the first step, r and s for
    every lane; then, where the cell adds a client, row and column k of H,
    and r's read-add-write (the first step writes r and s whole).  sweep:
    s, diag and avail for every lane, r where the lane is free; z and r of
    the m rows; the m x N panel's two H terms; and where the cell swaps,
    rows and columns i and j of H and r's read-add-write."""
    total = 0
    for c in range(before.shape[0]):
        sel = int(before[c].sum())
        moved = bool((before[c] != after[c]).any())
        if greedy:
            if first:
                total += 9 * n + 8 + (13 * n if moved else 5 * n)
            else:
                total += 14 * n + 8 + (16 * n + 1 if moved else 8 * n)
        else:
            free = int((avail[c] & ~before[c]).sum())
            total += 10 * n - sel + 4 * free + 8 * min(m, sel) \
                + 8 * m * n + 4 + (24 * n + 10 if moved else 0)
    return total


def cells_kernel_checks(np, torch, dev) -> dict:
    """The cell axis's two kernels against their plain versions on the same
    card inputs at CELLS_SHAPES, launch by launch through a whole solve
    (m greedy steps, then max_sweeps sweeps): s bitwise and r within 1e-6
    relative after every launch.  Then each is timed over the solve's own
    launches: the m greedy steps (the first writes the state whole, so the
    sequence repeats as is) and the sweeps from the greedy state (restored
    before each sequence; the restore's own time, taken alone, comes off).
    ``ms`` by CUDA events around the host loop, ``device_ms`` from a CUDA
    graph of the sequence, ``plain_ms`` the plain versions', all per
    launch; ``bound_ms`` from the bytes the launches request
    (:func:`cells_bytes`) over the sequence, per launch.  Returns name ->
    row."""
    from repro_torch.core import sampler_device as sd
    from repro_torch.kernels import solver as sv

    rows = {}
    for b, m, n, sweeps in CELLS_SHAPES:
        what = f"b={b}/m={m}/n={n}"
        rng = np.random.default_rng(b * 1000 + n)
        hh = rng.random((b, n, n)).astype(np.float32)
        h = torch.as_tensor(0.5 * (hh + hh.transpose(0, 2, 1)), device=dev)
        counts = torch.as_tensor(rng.integers(0, 6, (b, n)),
                                 dtype=torch.float32, device=dev)
        avail = torch.as_tensor(rng.random((b, n)) < 0.7, device=dev)
        avail[0] = False
        avail[0, :m // 2] = True                 # a cell with |A_t| < m
        args = (h, sd.balance_z(counts, m),
                sd.alpha_scales([(0.5, 1.0, 1.3)[i % 3] for i in range(b)],
                                n, dev), avail)
        av = avail.cpu().numpy()
        sk = torch.empty((b, n), dtype=torch.bool, device=dev)
        rk = torch.empty((b, n), dtype=torch.float32, device=dev)
        sp, rp = torch.empty_like(sk), torch.empty_like(rk)
        err = 0.0
        nbytes = {"greedy": 0, "sweep": 0}
        swaps = 0

        def step(kernel, plain, kind, **kw):
            nonlocal err, swaps
            before = sp.cpu().numpy().copy()
            kernel(*args, sk, rk, **kw)
            plain(*args, sp, rp, **kw)
            if not torch.equal(sk, sp):
                raise AssertionError(f"{kind}_cells {what}: s differs from "
                                     f"the plain version's")
            gap = (rk - rp).abs()
            if not bool((gap <= 1e-6 * rp.abs()).all()):
                raise AssertionError(f"{kind}_cells {what}: r beyond 1e-6 "
                                     f"relative of the plain version's")
            err = max(err, float(gap.max()))
            after = sp.cpu().numpy().copy()
            first = kw.get("first", False)
            if first:
                before = np.zeros_like(after)
            nbytes[kind] += cells_bytes(n, m, before, after, av,
                                        greedy=kind == "greedy", first=first)
            if kind == "sweep":
                swaps += int((before != after).any(1).sum())

        for t in range(m):
            step(sv.greedy_cells_cuda, sv.greedy_cells_plain, "greedy",
                 first=t == 0)
        s_g, r_g = sk.clone(), rk.clone()
        for _ in range(sweeps):
            step(sv.swap_cells_cuda, sv.swap_cells_plain, "sweep", m=m)
        got = sd.fedgs_select_cells(h, counts, avail, [(0.5, 1.0, 1.3)[
            i % 3] for i in range(b)], m=m, max_sweeps=sweeps)
        if not torch.equal(got, sk):
            raise AssertionError(f"cells {what}: fedgs_select_cells' sets "
                                 f"are not the launch-by-launch run's")

        def greedy(fn, s, r):
            for t in range(m):
                fn(*args, s, r, first=t == 0)

        def restore():
            sk.copy_(s_g)
            rk.copy_(r_g)

        def sweep(fn, s, r):
            s.copy_(s_g)
            r.copy_(r_g)
            for _ in range(sweeps):
                fn(*args, s, r, m=m)

        restore_ms = cuda_ms(torch, restore)
        restore_dev = device_ms(torch, restore)
        for kind, seq, kernel, plain, launches, less, less_dev in (
                ("greedy", greedy, sv.greedy_cells_cuda,
                 sv.greedy_cells_plain, m, 0.0, 0.0),
                ("sweep", sweep, sv.swap_cells_cuda, sv.swap_cells_plain,
                 sweeps, restore_ms, restore_dev)):
            ops = b * (11 * n if kind == "greedy" else 10 * m * n + 5 * n)
            bnd, by = bound(nbytes[kind] / launches, ops)
            name = "greedy_cells" if kind == "greedy" else "swap_cells"
            rows[f"{name}/{what}"] = dict(
                shape=[b, m, n], max_sweeps=sweeps, max_abs_err=err,
                tolerance="s bitwise, r within 1e-6 relative, after every "
                          "launch of a whole solve",
                bytes_per_launch=nbytes[kind] / launches,
                swaps=swaps if kind == "sweep" else None,
                ms=(cuda_ms(torch, lambda: seq(kernel, sk, rk)) - less)
                / launches,
                device_ms=(device_ms(torch, lambda: seq(kernel, sk, rk))
                           - less_dev) / launches,
                plain_ms=(cuda_ms(torch, lambda: seq(plain, sp, rp),
                                  max_reps=20) - less) / launches,
                bound_ms=bnd, bound_by=by, library_ms=None,
                library="none: no single PyTorch call does a greedy step "
                        "or a sweep of the solve")
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
        _, on_dev = profiled(torch, lambda: [call() for _ in range(10)],
                             host=False)
        epi = [e for e in on_dev if "adjacency_kernel" in e.key]
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


def slice_run(np, torch, dev, kept: dict,
              sets: dict) -> tuple[dict, dict]:
    """The quickstart (see the module docstring).  Keeps its unbroken
    FedGS run in ``kept["fedgs"]`` as (history, final params, a factory of
    the same engine) for the runtime phase, and its FedGS and uniform sets
    in ``sets`` for the examples phase."""
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

    def fedgs_engine():
        eng = FLEngine(ds, logistic_regression(), FedGSSampler(alpha=1.0),
                       mode(), quickstart_cfg(FLConfig), device=dev)
        eng.install_oracle_graph(ds.opt_params)
        return eng

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = fedgs_engine()
    h_card = card.run()
    torch.cuda.synchronize()
    fedgs_s = time.perf_counter() - t0
    launches = ops.launches()
    kept["fedgs"] = (h_card, card.params, fedgs_engine)
    if card.m != MAIN_M:
        raise AssertionError(f"quickstart M = {card.m}, expected {MAIN_M}")
    if not all(launches[k] > 0 for k in FEDGS_KERNELS):
        raise AssertionError(f"a kernel of the main path never ran: {launches}")

    uni = FLEngine(ds, logistic_regression(), UniformSampler(), mode(),
                   quickstart_cfg(FLConfig), device=dev)
    h_uni = uni.run()
    sets["fedgs"], sets["uniform"] = h_card.all_sampled, h_uni.all_sampled
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


def robust_run(np, torch, dev, kept: dict) -> tuple[dict, dict]:
    """The quickstart under sign-flip against each defense on the card, and
    the memory and multikrum runs again on the CPU.  Returns (info, the
    launch counts of the memory and multikrum runs); keeps the
    memory/sign_flip run in ``kept`` as ``slice_run`` does."""
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

    def memory_engine():
        eng = engine("memory", "sign_flip", dev)
        eng.install_oracle_graph(ds.opt_params)
        return eng
    kept["memory/sign_flip"] = (hists["memory/sign_flip"],
                                cards["memory/sign_flip"].params,
                                memory_engine)
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


def profiled(torch, fn, *, host: bool = True, top: int = 8):
    """``fn`` once under torch.profiler.  Returns (its wall ms and, of its
    device-side events (kernels, memsets, copies; an operator's row
    repeats the device time of the kernels it launched), the total ms,
    the busy share, the count and the ``top`` longest as [name, ms, count];
    the events).  ``host=False`` records device activity only, for a run
    whose host events would cost more than the run."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.insert(0, torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in on_dev) / 1e3
    ranked = sorted(on_dev, key=lambda e: -e.self_device_time_total)[:top]
    return {"wall_ms": wall, "device_ms": dev_ms or None,
            "device_busy_share": dev_ms / wall if dev_ms else None,
            "kernel_launches": sum(e.count for e in on_dev),
            "top_device_ms": [[e.key[:90], e.self_device_time_total / 1e3,
                               e.count] for e in ranked]}, on_dev


def profiled_device_ms(torch, fn) -> dict:
    """``fn`` once under torch.profiler (warm): the device time of all its
    device-side events (kernels, memsets, copies), of Floyd–Warshall's
    kernels alone and of the adjacency kernel (the staged build's, or the
    fused build's in-place epilogue launch), in ms."""
    _, on_dev = profiled(torch, fn)
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
    prof, on_dev = profiled(torch, one.run, top=6)
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
            "profiled_round_wall_ms": prof["wall_ms"],
            "profiled_round_device_ms": prof["device_ms"],
            "device_busy_share": prof["device_busy_share"],
            "top_device_ms": prof["top_device_ms"],
            "port_device_ms": port}

# ------------------------------------------------------------ phase 8
def scan_mixed(ds, rounds: int) -> list:
    """The scan phase's eight mixed cells, as (availability process,
    sampler, (aggregator, its knobs), fault): the five availability
    families, the four samplers, FedAvg, memory and multi-Krum, one 20%
    sign-flip cell."""
    from repro_torch.core import availability_device as avd
    from repro_torch.core.availability import make_mode
    n = ds.n_clients
    krum = dict(krum_f=KRUM_F, krum_multi=KRUM_MULTI)
    ln = make_mode("LN", n_clients=n, beta=0.5, seed=99).process()
    return [
        (ln, "fedgs", ("fedavg", {}), None),
        (avd.GilbertElliott(n, mean_on=8, mean_off=4), "uniform",
         ("memory", {"gamma": 0.9}), None),
        (avd.make_process("CLUSTER", n_clients=n), "md", ("fedavg", {}),
         None),
        (avd.make_process("DRIFT", n_clients=n, data_sizes=ds.sizes,
                          rounds=rounds), "poc", ("multikrum", krum), None),
        (avd.DeadlineProcess(n, deadline=1.2), "fedgs",
         ("memory", {"gamma": 0.9}), None),
        (ln, "fedgs", ("multikrum", krum), "sign_flip"),
        (avd.GilbertElliott(n, mean_on=8, mean_off=4), "poc",
         ("fedavg", {}), None),
        (avd.make_process("DRIFT", n_clients=n, data_sizes=ds.sizes,
                          rounds=rounds), "md", ("fedavg", {}), None)]


def scan_mixed_cells(e, mixed: list, h, *, seams: bool = True) -> list:
    """``mixed``'s cells on engine ``e``: every draw made on the host from
    a seed (``host_draws``) with ``seams``, else the engine's own device
    draws."""
    from repro_torch.core.sampler_device import make_sampler_process
    from repro_torch.fed.aggregator_device import make_aggregator_process
    from repro_torch.fed.faults_device import make_fault_process
    out = []
    for i, (proc, samp, (agg, kw), fault) in enumerate(mixed):
        fp = make_fault_process(fault, e.n, **SIGN_FLIP) if fault else None
        out.append(e.cell(
            seed=i, process=proc, avail_seed=60 + i, h=h,
            sampler_process=make_sampler_process(samp),
            aggregator_process=make_aggregator_process(agg, **kw),
            fault_process=fp, **(e.host_draws(i, proc) if seams else {})))
    return out


def scan_run(np, torch, dev, one_run: dict) -> tuple[dict, dict]:
    """The batched sweep engine at the quickstart's width (see the module
    docstring).  ``one_run`` is the slice phase's FLEngine launch counts.
    Returns (info, the phase's launch counts summed over its gated runs)."""
    import warnings
    from repro_torch.core.availability import ALL_MODES, make_mode
    from repro_torch.core.sampler import FedGSSampler
    from repro_torch.core.sampler_device import make_sampler_process
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.aggregator_device import make_aggregator_process
    from repro_torch.fed.engine import FLConfig, FLEngine
    from repro_torch.fed.faults_device import make_fault_process
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.runtime import CarryHandle
    from repro_torch.fed.scan_engine import (ScanConfig, ScanEngine,
                                             oracle_h, precompute_masks)
    from repro_torch.kernels import ops

    t_phase = time.perf_counter()
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    n, m, rounds, sweeps = ds.n_clients, MAIN_M, SCAN["rounds"], \
        SCAN["max_sweeps"]
    model = logistic_regression()

    def cfg(**kw):
        return ScanConfig(rounds=rounds, m=m, local_steps=10, batch_size=10,
                          lr=0.1, eval_every=4, max_sweeps=sweeps, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def counted(fn):
        ops.reset_launches()
        out, sec = timed(fn)
        return out, sec, ops.launches()

    def key_indices(seed):
        """Batch indices keyed by (seed, t, client): the padded scan and
        FLEngine (|S_t| rows) draw the same rows for the same client."""
        def draw(t, sel, sizes):
            return np.stack([np.floor(np.random.default_rng(
                [seed, t, int(k)]).random((10, 10)) * max(int(nk), 1))
                .astype(np.int64) for k, nk in zip(sel, sizes)])
        return draw

    info = {"phase": "scan", "n": n, "m": m, "p": 610, "rounds": rounds,
            "max_sweeps": sweeps}
    totals: dict = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    h = oracle_h(ds.opt_params, device=dev)
    params0 = {k: v.numpy() for k, v in
               model.init(torch.Generator().manual_seed(0)).items()}

    # (a) the seven Table-1 modes x FedGS alpha = 1 on host masks, one
    # batch, each cell against FLEngine on the card
    modes = [make_mode(name, n_clients=n, data_sizes=ds.sizes,
                       label_sets=ds.label_sets(), num_labels=ds.num_classes,
                       seed=99) for name in ALL_MODES]
    eng = ScanEngine(ds, model, cfg(), use_masks=True, device=dev)
    cells = [eng.cell(seed=0, masks=precompute_masks(mo, rounds, 1234 + i),
                      alpha=1.0, h=h, init_params=params0,
                      batch_indices=key_indices(i))
             for i, mo in enumerate(modes)]
    batch, sec_a, la = counted(lambda: eng.run_batch(cells))
    add(la)
    # the seven FedGS cells solve together: one cell's launches a round
    want = {k: one_run[k] * rounds // SLICE_ROUNDS
            for k in ("greedy_argmax", "swap_best_fused")}
    if one_run["greedy_argmax"] != SLICE_ROUNDS * m or \
            one_run["swap_best_fused"] != SLICE_ROUNDS * sweeps or \
            any(la[k] != v for k, v in want.items()):
        raise AssertionError(f"scan (a): launches {la}, want {want} "
                             f"(the slice phase's FLEngine run {one_run} "
                             f"a round, for the batch's one solve)")
    gaps, fl_launches, one_s = [], [], 0.0
    for i, (mo, hist) in enumerate(zip(modes, batch)):
        fl = FLEngine(ds, model, FedGSSampler(alpha=1.0, device=dev), mo,
                      FLConfig(rounds=rounds, sample_frac=0.2,
                               local_steps=10, batch_size=10, lr=0.1,
                               eval_every=4, seed=0, avail_seed=1234 + i),
                      device=dev, init_params=params0,
                      batch_indices=key_indices(i))
        fl.install_graph_from_H(h)
        fh, _, lf = counted(fl.run)
        fl_launches.append({k: lf[k] for k in want})
        bad = [t for t in range(rounds)
               if hist.sampled(t).tolist() != fh.all_sampled[t]]
        if bad or not np.array_equal(hist.counts, fl.counts):
            raise AssertionError(f"scan (a) {ALL_MODES[i]}: sets differ "
                                 f"from FLEngine in rounds {bad}")
        if hist.rounds.tolist() != fh.rounds:
            raise AssertionError(f"scan (a): eval rounds {hist.rounds}")
        gap = float(np.max(np.abs(hist.val_loss[fh.rounds] - fh.val_loss)))
        if gap > 1e-4:
            raise AssertionError(f"scan (a) {ALL_MODES[i]}: val_loss vs "
                                 f"FLEngine {gap}")
        gaps.append(gap)
        one_s += timed(lambda c=cells[i]: eng.run(c))[1]
    info["a_mask_sweep"] = {
        "modes": list(ALL_MODES), "sets_identical_vs_flengine": True,
        "val_loss_max_gap_vs_flengine": dict(zip(ALL_MODES, gaps)),
        "val_loss_gate": 1e-4, "batch_s": sec_a, "one_by_one_s": one_s,
        "launches": la, "flengine_launches": fl_launches,
        "min_available": {nm: int(precompute_masks(
            mo, rounds, 1234 + i).sum(1).min())
            for i, (nm, mo) in enumerate(zip(ALL_MODES, modes))}}

    # (b) eight cells on the device processes: the five families, the four
    # samplers, FedAvg, memory and Krum, one sign-flip cell
    mixed = scan_mixed(ds, rounds)

    def mixed_cells(e, seams=True):
        return scan_mixed_cells(e, mixed, h, seams=seams)

    card = ScanEngine(ds, model, cfg(), device=dev)
    cells = mixed_cells(card)
    batch, sec_b, lb = counted(lambda: card.run_batch(cells))
    add(lb)
    # the FedGS cells solve together: m greedy and `sweeps` swap launches
    # a round for all of them
    n_fedgs = sum(samp == "fedgs" for _, samp, _, _ in mixed)
    want = {"memagg": 2 * rounds, "krum": 2 * rounds,
            "greedy_argmax": min(n_fedgs, 1) * rounds * m,
            "swap_best_fused": min(n_fedgs, 1) * rounds * sweeps}
    if any(lb[k] != v for k, v in want.items()):
        raise AssertionError(f"scan (b): launches {lb}, want {want}")
    one_s, solo_gap = 0.0, 0.0
    for i, (c, hist) in enumerate(zip(cells, batch)):
        one, sec = timed(lambda c=c: card.run(c))
        one_s += sec
        if not np.array_equal(one.sel, hist.sel):
            raise AssertionError(f"scan (b) cell {i}: batch and own run "
                                 f"select differently")
        solo_gap = max(solo_gap, float(np.nanmax(np.abs(
            one.val_loss - hist.val_loss))))
    if solo_gap > 1e-5:
        raise AssertionError(f"scan (b): val_loss batch vs own runs "
                             f"{solo_gap}")
    cpu = ScanEngine(ds, model, cfg(), device="cpu")
    cpu_cells = mixed_cells(cpu)
    on_cpu, sec_cpu = timed(lambda: cpu.run_batch(cpu_cells))
    free_gap = []
    for i, (a, b) in enumerate(zip(batch, on_cpu)):
        same_chosen = (a.chosen is None) == (b.chosen is None) and (
            a.chosen is None or np.array_equal(a.chosen, b.chosen))
        if not (np.array_equal(a.sel, b.sel) and same_chosen):
            raise AssertionError(f"scan (b) cell {i}: card and CPU differ "
                                 f"(sets or Krum rows)")
        free_gap.append(float(np.nanmax(np.abs(a.val_loss - b.val_loss))))
    # val_loss card vs CPU round by round: each round of the card run
    # replayed on the CPU from the card's own state.  Over 40 free-running
    # rounds some of these trajectories amplify float32 round-off ~10^3x
    # (a one-ulp change of the init alone moves them ~1e-3 on the CPU,
    # printed below), which says nothing of the card's arithmetic.
    def to(x, d):
        if isinstance(x, torch.Tensor):
            return x.to(d, copy=True)
        if isinstance(x, dict):
            return {k: to(v, d) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v, d) for v in x]
        return x
    carry, step_gap = card.init_carry(cells), np.zeros(len(cells))
    for t in range(rounds):
        start = CarryHandle(to(carry.tree, "cpu"))
        carry, tc = card.run_segment(cells, carry, t, 1)
        _, tp = cpu.run_segment(cpu_cells, start, t, 1)
        if not torch.equal(tc["sel"].cpu(), tp["sel"]):
            raise AssertionError(f"scan (b) round {t}: card and CPU select "
                                 f"differently from the same state")
        step_gap = np.fmax(step_gap, np.abs(
            tc["val_loss"][:, 0].cpu().numpy() - tp["val_loss"][:, 0].numpy()))
    if float(np.nanmax(step_gap)) > 1e-4:
        raise AssertionError(f"scan (b): val_loss card vs CPU from the "
                             f"same state {step_gap}")
    # each cell's own conditioning: the CPU batch again with every init
    # one float32 ulp up
    bumped = []
    for i, (proc, samp, (agg, kw), fault) in enumerate(mixed):
        c = cpu_cells[i]
        p1 = {k: np.nextafter(v.numpy(), np.inf).astype(np.float32)
              for k, v in c["params0"].items()}
        fp = make_fault_process(fault, n, **SIGN_FLIP) if fault else None
        bumped.append(cpu.cell(
            seed=i, process=proc, avail_seed=60 + i, h=h,
            sampler_process=make_sampler_process(samp),
            aggregator_process=make_aggregator_process(agg, **kw),
            fault_process=fp, init_params=p1, **cpu.host_draws(i, proc)))
    ulp = [float(np.nanmax(np.abs(a.val_loss - b.val_loss)))
           for a, b in zip(on_cpu, cpu.run_batch(bumped))]
    info["b_mixed"] = {
        "cells": [[p.family, smp, agg, f or "none"]
                  for p, smp, (agg, _), f in mixed],
        "sets_identical_batch_vs_own_runs": True,
        "val_loss_max_gap_batch_vs_own_runs": solo_gap,
        "val_loss_gate_own_runs": 1e-5,
        "sets_and_krum_rows_identical_card_vs_cpu": True,
        "val_loss_gap_card_vs_cpu_per_round": step_gap.tolist(),
        "val_loss_gate_cpu_per_round": 1e-4,
        "val_loss_gap_card_vs_cpu_free_running": free_gap,
        "val_loss_gap_cpu_one_ulp_init": ulp,
        "krum_rounds_compared": 2 * rounds,
        "batch_s": sec_b, "one_by_one_s": one_s, "cpu_batch_s": sec_cpu,
        "launches": lb,
        "final_val_acc": [float(x.val_acc[-1]) for x in batch]}

    # the same eight cells on the port's own (device) draws: wall time per
    # round, host syncs (torch's sync debug mode), launches per round, and
    # one profiled batch round
    own = mixed_cells(card, seams=False)
    card.run_batch(own)                                  # warm
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ops.reset_launches()
            hists, sec_own = timed(lambda: card.run_batch(own))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    lo = ops.launches()
    carry, _ = card.run_segment(own, card.init_carry(own), 0, 1)
    prof, _ = profiled(torch, lambda: card.run_segment(own, carry, 1, 1))
    if not all(np.isfinite(x.val_loss[x.rounds]).all() for x in hists):
        raise AssertionError("scan (b) own draws: a val_loss is not finite")
    info["b_own_draws"] = {
        "batch_s": sec_own, "wall_ms_per_round": sec_own * 1e3 / rounds,
        "host_syncs": syncs, "host_syncs_per_round": syncs / rounds,
        "port_launches_per_round": {k: v / rounds for k, v in lo.items()
                                    if v},
        "profiled_round_wall_ms": prof["wall_ms"],
        "profiled_round_device_ms": prof["device_ms"],
        "device_busy_share": prof["device_busy_share"],
        "device_launches_per_round": prof["kernel_launches"],
        "top_device_ms": prof["top_device_ms"]}

    # (c) the dynamic 3DG: two FedGS cells, rebuilt every 5 rounds
    every = SCAN["graph_refresh_every"]
    masks = precompute_masks(make_mode("LN", n_clients=n, beta=0.5,
                                       seed=99), rounds, 1234)
    engines, dyn_cells = {}, {}
    for key, d in (("card", dev), ("cpu", "cpu")):
        engines[key] = e = ScanEngine(
            ds, model, cfg(graph_refresh_every=every), use_masks=True,
            device=d)
        dyn_cells[key] = [e.cell(seed=s, masks=masks, alpha=1.0,
                                 **e.host_draws(s)) for s in (0, 1)]
    free, sec, lc = counted(lambda: engines["card"].run_batch(
        dyn_cells["card"]))
    add(lc)
    builds = 2 * (1 + rounds // every)
    if any(lc[k] != builds for k in ("fused_adjacency", "floyd_warshall")):
        raise AssertionError(f"scan (c): launches {lc}, want {builds} "
                             f"fused adjacency and Floyd–Warshall")
    # round by round from the card's state: the CPU selects the card's
    # sets, and its rebuilt H (from the card's embeddings) is the card's
    # under the graph contract.  Free-running, a FedGS near-tie decided by
    # H's round-off may part the two runs (printed).
    card, cpu = engines["card"], engines["cpu"]
    carry, h_rel = card.init_carry(dyn_cells["card"]), 0.0
    for t in range(rounds):
        start = CarryHandle(to(carry.tree, "cpu"))
        carry, tc = card.run_segment(dyn_cells["card"], carry, t, 1)
        nxt, tp = cpu.run_segment(dyn_cells["cpu"], start, t, 1)
        if not torch.equal(tc["sel"].cpu(), tp["sel"]):
            raise AssertionError(f"scan (c) round {t}: card and CPU select "
                                 f"differently from the same state")
        if (t + 1) % every:
            continue
        for hc, hp in zip(carry.tree["h"], nxt.tree["h"]):
            hc, hp = hc.cpu().numpy(), hp.numpy()
            if not np.array_equal(hc == hc.max(), hp == hp.max()):
                raise AssertionError(f"scan (c) round {t}: H's "
                                     f"disconnected pairs differ")
            rel = float(np.max(np.abs(hc - hp) / np.maximum(np.abs(hp),
                                                             1e-7)))
            if rel > 1e-4:
                raise AssertionError(f"scan (c) round {t}: H card vs CPU "
                                     f"{rel}")
            h_rel = max(h_rel, rel)
    on_cpu = cpu.run_batch(dyn_cells["cpu"])
    info["c_dynamic"] = {
        "refresh_every": every, "batch_s": sec, "launches": lc,
        "builds_gated": builds,
        "sets_identical_card_vs_cpu_per_round": True,
        "h_max_rel_card_vs_cpu_per_rebuild": h_rel, "h_gate_rel": 1e-4,
        "free_running_first_round_sets_part": [
            int(np.flatnonzero((a.sel != b.sel).any(1))[0])
            if not np.array_equal(a.sel, b.sel) else None
            for a, b in zip(free, on_cpu)]}
    info["seconds"] = time.perf_counter() - t_phase
    return info, totals


# ------------------------------------------------------------ phase 9
def _hist_diff(np, a, b) -> list[str]:
    """The ScanHistory fields in which a and b are not bitwise equal."""
    bad = [f for f in ("sel", "valid", "counts", "val_loss", "val_acc",
                       "count_var", "gini")
           if not np.array_equal(getattr(a, f), getattr(b, f),
                                 equal_nan=True)]
    if (a.chosen is None) != (b.chosen is None) or (
            a.chosen is not None and not np.array_equal(a.chosen, b.chosen)):
        bad.append("chosen")
    return bad


def _npz_diff(np, a: str, b: str) -> list[str]:
    """The keys of two npz files whose arrays are not bitwise equal
    (["keys"] when the key sets differ)."""
    with np.load(a, allow_pickle=False) as za, \
            np.load(b, allow_pickle=False) as zb:
        if sorted(za.files) != sorted(zb.files):
            return ["keys"]
        return [k for k in za.files
                if za[k].dtype != zb[k].dtype or za[k].shape != zb[k].shape
                or za[k].tobytes() != zb[k].tobytes()]


_PROM_LINE = (r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
              r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})? '
              r'([-+]?[0-9.]+([eE][-+]?[0-9]+)?|NaN|[+-]Inf)$')


def parse_prometheus(text: str) -> dict:
    """{metric: [values]} of a Prometheus text exposition; raises on a line
    that is not HELP, TYPE (counter or gauge) or a sample of a typed
    metric."""
    import re
    out, typed = {}, set()
    for ln in text.splitlines():
        if ln.startswith("# HELP "):
            continue
        if ln.startswith("# TYPE "):
            _, _, name, kind = ln.split(" ", 3)
            if kind not in ("counter", "gauge"):
                raise AssertionError(f"prometheus: {ln!r}")
            typed.add(name)
            continue
        name = re.split(r"[{ ]", ln, maxsplit=1)[0]
        if not re.match(_PROM_LINE, ln) or name not in typed:
            raise AssertionError(f"prometheus: {ln!r}")
        out.setdefault(name, []).append(float(ln.rsplit(" ", 1)[1]))
    return out


def runtime_run(np, torch, dev, kept: dict) -> dict:
    """The runtime layer at the quickstart's width (see the module
    docstring).  ``kept``: the slice and robust phases' unbroken FLEngine
    runs, which (b) resumes."""
    import shutil
    import threading
    import warnings
    from repro_torch.core.sampler_device import make_sampler_process
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed import runtime as rt
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine, oracle_h
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import SimService

    t_phase = time.perf_counter()
    work = OUT / "runtime"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    n, m, rounds = ds.n_clients, MAIN_M, SCAN["rounds"]
    every, sweeps = RUNTIME["ckpt_every"], SCAN["max_sweeps"]
    model = logistic_regression()
    h = oracle_h(ds.opt_params, device=dev)
    mixed = scan_mixed(ds, rounds)
    n_fedgs = sum(samp == "fedgs" for _, samp, _, _ in mixed)
    per_round = ("greedy_argmax", "swap_best_fused", "memagg", "krum")

    def cfg(**kw):
        return ScanConfig(rounds=rounds, m=m, local_steps=10, batch_size=10,
                          lr=0.1, eval_every=4, max_sweeps=sweeps, **kw)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    info = {"phase": "runtime", "card": smi_line(), "n": n, "m": m,
            "p": 610, "rounds": rounds, "ckpt_every": every}

    # (a) the 8 mixed cells on the engine's own device draws, checkpointed
    # every 10 rounds: the default (pipelined, handle consumed), inline,
    # on a clone, telemetry on.  Each engine builds its plan first (the
    # cells' tables go to the card: set-up, and host syncs).  The inline
    # stream's launch counts at each yield give each segment's launches;
    # the default run counts the host syncs torch flags and the snapshot
    # waits of the main thread
    runs, ck, seg_counts, waits = {}, {}, [], {"main": 0}
    orig_wait = rt.HostSnapshot.wait

    def counting_wait(self):
        if threading.current_thread() is threading.main_thread():
            waits["main"] += 1
        return orig_wait(self)

    for name, kw in (("default", {}), ("inline", {"async_pipeline": False}),
                     ("no_donate", {"donate_carry": False}),
                     ("telemetry", {"telemetry": True})):
        eng = ScanEngine(ds, model, cfg(**kw), device=dev)
        cells = scan_mixed_cells(eng, mixed, h, seams=False)
        eng.init_carry(cells)
        ck[name] = str(work / name)
        if name == "inline":
            def counting_stream(*a, _stream=eng.run_batch_stream, **k):
                for item in _stream(*a, **k):
                    seg_counts.append(ops.launches())
                    yield item
            eng.run_batch_stream = counting_stream
        ops.reset_launches()
        if name == "default":
            torch.cuda.set_sync_debug_mode("warn")
            rt.HostSnapshot.wait = counting_wait
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                hists, sec = timed(lambda: eng.run_batch(
                    cells, ckpt_path=ck[name], ckpt_every=every))
        finally:
            torch.cuda.set_sync_debug_mode(0)
            rt.HostSnapshot.wait = orig_wait
        runs[name] = {"hists": hists, "seconds": sec,
                      "launches": ops.launches(),
                      "stats": eng.runtime_stats(),
                      "flagged_syncs": sum("synchroniz" in str(w.message)
                                           for w in caught)}
    want = runs["default"]["hists"]
    if not all(np.isfinite(x.val_loss[x.rounds]).all() for x in want):
        raise AssertionError("runtime (a): a val_loss is not finite")
    for name in ("inline", "no_donate", "telemetry"):
        bad = {i: d for i, (a, b) in enumerate(zip(runs[name]["hists"],
                                                    want))
               if (d := _hist_diff(np, a, b))}
        if bad:
            raise AssertionError(f"runtime (a) {name}: history fields "
                                 f"differ from the default run {bad}")
        diff = _npz_diff(np, ck[name] + ".npz", ck["default"] + ".npz")
        if diff:
            raise AssertionError(f"runtime (a) {name}: checkpoint arrays "
                                 f"differ from the default run {diff[:8]}")
    tel = [x.telemetry for x in runs["telemetry"]["hists"]]
    if any(t is None or not all(np.isfinite(v).all() for v in t.values())
           for t in tel):
        raise AssertionError("runtime (a): telemetry missing or not finite")
    with np.load(ck["default"] + ".npz") as z:
        ck_round = int(z["round"])
    if ck_round != rounds - every or len(seg_counts) != rounds // every:
        raise AssertionError(f"runtime (a): checkpoint round {ck_round}, "
                             f"{len(seg_counts)} segments")
    last = {k: seg_counts[-1][k] - seg_counts[-2][k] for k in per_round}
    # a fresh engine resumes from the round-30 file
    shutil.copy(ck["default"] + ".npz", str(work / "resume.npz"))
    eng = ScanEngine(ds, model, cfg(), device=dev)
    cells = scan_mixed_cells(eng, mixed, h, seams=False)
    eng.init_carry(cells)
    ops.reset_launches()
    res, sec_res = timed(lambda: eng.run_batch(
        cells, ckpt_path=str(work / "resume"), ckpt_every=every,
        resume=True))
    tail = ops.launches()
    bad = {i: d for i, (a, b) in enumerate(zip(res, want))
           if (d := _hist_diff(np, a, b))}
    if bad:
        raise AssertionError(f"runtime (a) resume: history fields differ "
                             f"from the unbroken run {bad}")
    if tail["greedy_argmax"] != min(n_fedgs, 1) * m * every or \
            any(tail[k] != last[k] for k in per_round):
        raise AssertionError(f"runtime (a) resume: tail launches "
                             f"{ {k: tail[k] for k in per_round} }, the "
                             f"unbroken run's last segment {last}")
    d = runs["default"]
    host_waits = d["flagged_syncs"] + waits["main"]
    segments = rounds // every
    if host_waits > segments + 1:
        raise AssertionError(f"runtime (a): {host_waits} host syncs in the "
                             f"pipelined run, more than one per segment "
                             f"and the final read ({segments + 1}): a sync "
                             f"inside a round")
    writer = d["stats"]["checkpoint_writer"]
    info["a_resume"] = {
        "cells": [[p.family, smp, agg, f or "none"]
                  for p, smp, (agg, _), f in mixed],
        "draws": "the engine's own (device)",
        "checkpoint_round": ck_round,
        "resume_bitwise_unbroken": True,
        "inline_bitwise_default": True, "no_donate_bitwise_default": True,
        "telemetry_bitwise_default_history_and_checkpoint": True,
        "tail_launches": {k: tail[k] for k in per_round},
        "unbroken_last_segment_launches": last,
        "greedy_argmax_tail_gate": min(n_fedgs, 1) * m * every,
        "seconds": {k: v["seconds"] for k, v in runs.items()},
        "resume_tail_s": sec_res,
        "wall_s_inline_vs_pipelined": [runs["inline"]["seconds"],
                                       d["seconds"]],
        "checkpoint_bytes": os.path.getsize(ck["default"] + ".npz"),
        "writer": {k: writer[k] for k in ("write_ms", "blocked_ms",
                                          "queue_high_watermark",
                                          "submitted", "completed")},
        "host_syncs": {"flagged_by_torch": d["flagged_syncs"],
                       "snapshot_waits_main_thread": waits["main"],
                       "segments": segments,
                       "checkpoint_boundaries": segments - 1,
                       "per_segment": host_waits / segments,
                       "gate": "<= one per segment + the final read"},
        "telemetry_keys": sorted(tel[0]),
        "compiles": d["stats"]["compiles"],
        "compile_ms": d["stats"]["compile_ms"]}

    # (b) FLEngine: the slice phase's FedGS run and the robust phase's
    # memory run, a head of 20 rounds saved at round 20, a resumed tail
    head_rounds = RUNTIME["fl_head"]
    info["b_flengine"] = {}
    for key, (h_full, p_full, make) in kept.items():
        path = str(work / ("fl_" + key.replace("/", "_")))
        head = make()
        head.cfg.rounds = head_rounds
        head.run(ckpt_path=path, ckpt_every=head_rounds)
        eng = make()
        ops.reset_launches()
        h_tail, sec = timed(lambda e=eng, p=path: e.run(ckpt_path=p,
                                                       resume=True))
        lt = ops.launches()
        tail_rounds = len(h_full.all_sampled) - head_rounds
        want_l = {"greedy_argmax": tail_rounds * m,
                  "swap_best_fused": tail_rounds * sweeps,
                  "memagg": tail_rounds if key.startswith("memory") else 0}
        evals = [(r, v) for r, v in zip(h_full.rounds, h_full.val_loss)
                 if r >= head_rounds]
        if h_tail.all_sampled != h_full.all_sampled[head_rounds:] or \
                list(zip(h_tail.rounds, h_tail.val_loss)) != evals or \
                not all(torch.equal(eng.params[k], p_full[k])
                        for k in p_full):
            raise AssertionError(f"runtime (b) {key}: the resumed tail is "
                                 f"not the unbroken run's")
        if any(lt[k] != v for k, v in want_l.items()):
            raise AssertionError(f"runtime (b) {key}: tail launches {lt}, "
                                 f"want {want_l}")
        info["b_flengine"][key] = {
            "head_rounds": head_rounds, "tail_bitwise_unbroken": True,
            "tail_launches": {k: lt[k] for k in want_l}, "tail_s": sec,
            "checkpoint_bytes": os.path.getsize(path + ".npz"),
            "writer": head.runtime_stats()["checkpoint_writer"]}

    # (c) SimService: 4 FedGS cells, streamed in segments of 10
    ln = mixed[0][0]

    def svc_kw(i):
        return dict(seed=i, process=ln, avail_seed=80 + i, h=h,
                    sampler_process=make_sampler_process("fedgs"))
    svc = SimService(ScanEngine(ds, model, cfg(), device=dev))
    cells_n = RUNTIME["svc_cells"]
    ids = [svc.submit(**svc_kw(i)) for i in range(cells_n)]
    updates, sec_svc = timed(lambda: list(svc.drain(segment=every)))
    ref = ScanEngine(ds, model, cfg(), device=dev)
    ref_h, sec_ref = timed(lambda: ref.run_batch(
        [ref.cell(**svc_kw(i)) for i in range(cells_n)]))
    if len(updates) != cells_n * (rounds // every):
        raise AssertionError(f"runtime (c): {len(updates)} updates")
    bad = {i: d for i, (rid, b) in enumerate(zip(ids, ref_h))
           if (d := _hist_diff(np, svc.histories[rid], b))}
    if bad:
        raise AssertionError(f"runtime (c): service histories differ from "
                             f"run_batch {bad}")
    text = svc.metrics_text()
    fams = parse_prometheus(text)
    if fams.get("fedgs_rounds_streamed_total") != [float(cells_n * rounds)]:
        raise AssertionError(f"runtime (c): metrics {fams}")
    info["c_service"] = {
        "cells": cells_n, "updates": len(updates),
        "histories_bitwise_run_batch": True, "drain_s": sec_svc,
        "run_batch_s": sec_ref, "prometheus_parsed": True,
        "prometheus_families": len(fams),
        "first_segment_s": [svc.timings[r]["first_segment_s"] for r in ids],
        "stats": svc.stats()["service"]}

    # (d) telemetry card vs CPU, round by round from the card's state, on
    # the same host draws
    tel_rounds = RUNTIME["tel_rounds"]
    card = ScanEngine(ds, model, cfg(telemetry=True), device=dev)
    cpu = ScanEngine(ds, model, cfg(telemetry=True), device="cpu")
    cc = scan_mixed_cells(card, mixed, h)
    pc = scan_mixed_cells(cpu, mixed, h)

    def to(x, d):
        if isinstance(x, torch.Tensor):
            return x.to(d, copy=True)
        if isinstance(x, dict):
            return {k: to(v, d) for k, v in x.items()}
        if isinstance(x, list):
            return [to(v, d) for v in x]
        return x
    carry, gaps = card.init_carry(cc), {}
    for t in range(tel_rounds):
        start = rt.CarryHandle(to(carry.tree, "cpu"))
        carry, tc = card.run_segment(cc, carry, t, 1)
        _, tp = cpu.run_segment(pc, start, t, 1)
        if not torch.equal(tc["sel"].cpu(), tp["sel"]):
            raise AssertionError(f"runtime (d) round {t}: card and CPU "
                                 f"select differently")
        for k, v in tp["telemetry"].items():
            a, b = tc["telemetry"][k].cpu().numpy(), v.numpy()
            exact = k in ("avail_rate", "n_selected", "staleness_hist")
            if (exact and not np.array_equal(a, b)) or not np.allclose(
                    a, b, rtol=1e-4, atol=0.0):
                raise AssertionError(f"runtime (d) round {t}: {k} card "
                                     f"{a} vs CPU {b}")
            rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-30)
            gaps[k] = max(gaps.get(k, 0.0), float(np.max(rel)))
    info["d_telemetry_card_vs_cpu"] = {
        "rounds": tel_rounds, "exact": ["avail_rate", "n_selected",
                                        "staleness_hist"],
        "float_gate_rtol": 1e-4, "max_rel_gap": gaps}
    info["seconds"] = time.perf_counter() - t_phase
    return info


# ------------------------------------------------------------ phase 10
def plans_run(np, torch, dev) -> dict:
    """The plan table (see the module docstring)."""
    import tempfile
    from repro_torch.kernels import autotune as tat

    t_phase = time.perf_counter()
    table = tat.load_table()
    if not table:
        raise AssertionError("plans: the committed plan table is empty")
    rows, edges, moved = {}, 0, []
    for key, entry in sorted(table.items()):
        kernel, tier, platform = key.split("|")
        if platform != "cuda" or not entry.get("device") or \
                not entry.get("power_limit"):
            raise AssertionError(f"plans: {key} is not a card entry")
        winner = entry["tiles"]["plan"]
        dims = tat.call_dims(kernel, **entry["spec"])
        reg = tat.KERNELS[kernel]
        inputs = reg["setup"](dev, **entry["spec"])
        # the wrapper with plan=None takes the table's plan, and agrees
        # with the plain version
        if not reg["check"](reg["run"](None, *inputs), reg["plain"](*inputs)):
            raise AssertionError(f"plans: {key}'s default call disagrees "
                                 "with its plain version")
        got = tat.default_plan(kernel, **dims)
        if got != winner:
            raise AssertionError(f"plans: {key} takes {got}, the table "
                                 f"says {winner}")
        # at the tier's edges: the winner where it takes the shape, else
        # the heuristic
        tdims = {k[0]: int(k[1:]) for k in tier.split(",")}
        for pick in (0, 1):
            shape = {k: tat.tier_range(v)[pick] for k, v in tdims.items()}
            shape = {**dims, **shape}
            want = winner if reg["takes"](winner, **{
                k: shape[k] for k in tdims}) else \
                tat.heuristic(kernel, **shape)
            if tat.default_plan(kernel, **shape) != want:
                raise AssertionError(f"plans: {key} at {shape}: "
                                     f"{tat.default_plan(kernel, **shape)}"
                                     f", want {want}")
            edges += 1
        heur = tat.heuristic(kernel, **dims)
        if heur != winner:
            moved.append(key)
        rows[key] = {"winner": winner, "heuristic": heur,
                     "ms": entry["ms"], "candidates_ms": {
                         c["plan"]: v for c, v in entry["candidates"]}}
    # tune one small spec per kernel into a temp path (each candidate held
    # against its plain version first); the committed table is untouched
    specs = [("floyd_warshall", {"n": 128}), ("fused_3dg", {"n": 128}),
             ("greedy_argmax", {"n": 1024}), ("swap_gain", {"m": 64,
                                                           "n": 1024}),
             ("memory_aggregate", {"n": 256, "p": 1024}),
             ("krum_pairwise", {"m": 128, "p": 1024})]
    before = tat.TABLE_PATH.read_bytes()
    with tempfile.TemporaryDirectory() as tmp:
        tuned = tat.tune(specs, device=dev, base_table={}, verbose=False)
        tat.save_table(tuned, Path(tmp) / "plans.json")
    if tat.TABLE_PATH.read_bytes() != before:
        raise AssertionError("plans: the committed table was written")
    fresh = {k: {"winner": v["tiles"]["plan"], "heuristic": tat.heuristic(
        k.split("|")[0], **tat.call_dims(k.split("|")[0], **v["spec"])),
        "candidates_ms": {c["plan"]: ms for c, ms in v["candidates"]}}
        for k, v in sorted(tuned.items())}
    return {"phase": "plans", "card": smi_line(), "entries": len(table),
            "edges_checked": edges, "winners_away_from_heuristic": moved,
            "table": rows, "tuned_now": fresh,
            "seconds": time.perf_counter() - t_phase}


# ------------------------------------------------------------ phase 11
FEDSIM = {"clients": 4096, "aggregator": "memory"}
# the reference's cohort at N = 4096: round(0.1 N) = 410 padded to a
# multiple of the dp width (16 on pod1, 32 on pod2)
FEDSIM_M = 416


def fedsim_run(np, torch, dev) -> dict:
    """The fedsim launcher at N = 4096 (see the module docstring)."""
    from repro_torch.core.graph_device import GraphConfig, build_h
    from repro_torch.launch import fedsim

    t_phase = time.perf_counter()
    n = FEDSIM["clients"]
    rec = fedsim.run(n, aggregator=FEDSIM["aggregator"], force=True)
    out = {"phase": "fedsim", "card": smi_line(), **fedsim_gates(rec, dev)}
    m, p = out["m"], out["p"]
    sp = rec["server_pipeline"]
    feats, counts, avail = fedsim.pipeline_inputs(n, device=dev)
    h = build_h(feats, GraphConfig())
    # each kernel's device ms per call at the programs' shapes (20 calls
    # replayed from a CUDA graph), the planned plan, beside its bound
    from repro_torch.core.sampler_device import balance_z
    from repro_torch.kernels import aggregate as ag_k
    from repro_torch.kernels import floyd_warshall as fw_k
    from repro_torch.kernels import graph_fused as gf_k
    from repro_torch.kernels import solver as sv_k
    g = torch.Generator(device=dev).manual_seed(0)
    r, _ = gf_k.fused_adjacency_cuda(feats, eps=0.1, sigma2=0.01)
    z = balance_z(counts, m)
    sel = torch.as_tensor(sp["selected"], device=dev)
    valid = torch.ones(m, dtype=torch.bool, device=dev)
    a_m = torch.randn(m, generator=g, device=dev)
    b_n = torch.randn(n, generator=g, device=dev)
    mem = torch.randn(n, p, generator=g, device=dev)
    upd = torch.randn(m, p, generator=g, device=dev)
    w = torch.rand(n, generator=g, device=dev) / n
    calls = {"fused_adjacency": lambda: gf_k.fused_adjacency_cuda(
                 feats, eps=0.1, sigma2=0.01),
             "floyd_warshall": lambda: fw_k.floyd_warshall_cuda(r),
             "greedy_argmax": lambda: sv_k.masked_argmax_cuda(
                 b_n, b_n, avail, None),
             "swap_best_fused": lambda: sv_k.swap_best_fused_cuda(
                 h, z, 1.0 / n, sel, valid, a_m, b_n),
             "memagg": lambda: ag_k.memory_aggregate_cuda(mem, upd, sel,
                                                          valid, w)}
    plans = {"fused_adjacency": gf_k.fused_adjacency_plan(n, fedsim.CLASSES),
             "floyd_warshall": fw_k.floyd_warshall_plan(n),
             "greedy_argmax": sv_k.masked_argmax_plan(n),
             "swap_best_fused": sv_k.swap_best_fused_plan(m, n),
             "memagg": ag_k.memagg_plan(n, p, m)}
    work = fedsim.kernel_work(n, m, fedsim.CLASSES, p)
    kernels = {}
    for name, fn in calls.items():
        launched = rec["aggregator"]["launches"] if name == "memagg" \
            else sp["launches"]
        per_call = device_ms(torch, fn, reps=5 if name == "floyd_warshall"
                             else 20)
        t_bound, by = bound(work[name][1], work[name][0])
        kernels[name] = {"plan": plans[name], "launches": launched[name],
                         "device_ms_per_call": per_call,
                         "device_ms_per_program": per_call * launched[name],
                         "bound_ms_per_call": t_bound, "bound_by": by}
    out["kernels"] = kernels
    out["seconds"] = time.perf_counter() - t_phase
    return out


def fedsim_gates(rec: dict, dev) -> dict:
    """A fedsim record's gates at N = 4096: ``ok``; the cohort M = 416
    (the reference's, padded to the dp width); B1 = B2 = 1, B3 = M, B4 =
    the sweeps and B6 = 1 launches per measured call; the pipeline's set
    bitwise ``fedgs_select``'s on the same H built outside the twin.
    Returns the record's summary."""
    import torch
    from repro_torch.core.graph_device import GraphConfig, build_h
    from repro_torch.core.sampler_device import fedgs_select
    from repro_torch.launch import fedsim
    if not rec["ok"]:
        raise AssertionError(f"fedsim {rec['mesh']}: {rec.get('error')}\n"
                             f"{rec.get('traceback', '')}")
    n = FEDSIM["clients"]
    m = rec["round"]["m_sampled"]
    sp, ag = rec["server_pipeline"], rec["aggregator"]
    want = {"fused_adjacency": 1, "floyd_warshall": 1, "greedy_argmax": m,
            "swap_best_fused": sp["max_sweeps"]}
    if sp["launches"] != want or m != FEDSIM_M:
        raise AssertionError(f"fedsim {rec['mesh']}: pipeline launches "
                             f"{sp['launches']}, want {want} (M = {m})")
    if ag["launches"] != {"memagg": 1}:
        raise AssertionError(f"fedsim {rec['mesh']}: aggregator launches "
                             f"{ag['launches']}")
    # the set, bitwise, from fedgs_select on the same H outside the twin
    feats, counts, avail = fedsim.pipeline_inputs(n, device=dev)
    h = build_h(feats, GraphConfig())
    s = fedgs_select(h, counts, avail, 1.0, m=m, max_sweeps=sp["max_sweeps"])
    if torch.nonzero(s).flatten().tolist() != sp["selected"]:
        raise AssertionError(f"fedsim {rec['mesh']}: the pipeline's set is "
                             f"not fedgs_select's on the same H")
    out = {"mesh": rec["mesh"], "dp": rec["dp"], "n": n, "m": m,
           "p": ag["p"]}
    for part in ("round", "server_pipeline", "aggregator"):
        r = rec[part]
        out[part] = {k: r[k] for k in ("launches", "device_ms", "wall_ms",
                                       "first_call_ms", "mem", "flops")}
        if r["device_ms"] <= 0 or not r["mem"]["peak_bytes"]:
            raise AssertionError(f"fedsim {rec['mesh']} {part}: "
                                 f"{r['device_ms']}")
    out["round_terms_s"] = {k: rec[k] for k in ("compute_term_s",
                                                 "memory_term_s")}
    return out


# ------------------------------------------------------------ phase 12
MESH = {"rounds": 10, "loss_bound": 1e-5}
MESH_RUNS = (((2, 1), "gather"), ((1, 2), "gather"), ((1, 2), "psum"))


def mesh_cells(engine, dev):
    """The scan phase's 8 mixed cells on ``engine``, host draws."""
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.scan_engine import oracle_h
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    h = oracle_h(ds.opt_params, device=dev)
    return scan_mixed_cells(engine, scan_mixed(ds, engine.cfg.rounds), h)


def mesh_engine(dev, sizes, **kw):
    """The scan phase's engine at ``sizes`` = (rounds, max_sweeps)."""
    from repro_torch.data.synthetic import make_synthetic
    from repro_torch.fed.models import logistic_regression
    from repro_torch.fed.scan_engine import ScanConfig, ScanEngine
    ds = make_synthetic(n_clients=30, alpha=0.5, beta=0.5, seed=0)
    return ScanEngine(ds, logistic_regression(), ScanConfig(
        rounds=sizes[0], m=MAIN_M, local_steps=10, batch_size=10, lr=0.1,
        eval_every=1, max_sweeps=sizes[1], **kw), device=dev)


def mesh_hist(h) -> dict:
    return {"sel": h.sel, "valid": h.valid, "counts": h.counts,
            "val_loss": h.val_loss, "chosen": h.chosen,
            "gini": h.gini, "count_var": h.count_var, "val_acc": h.val_acc}


def mesh_rank(rank, world, job):
    """One of two ranks sharing the card over gloo: every mesh of
    MESH_RUNS on the 8 cells, launches counted around each run; the (2, 1)
    run checkpointed every round into ``job["ckpt"]``."""
    import torch
    from repro_torch.kernels import ops
    dev = torch.device(job["device"])
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
        torch.cuda.set_device(dev)
    out = {}
    for mesh, reduce in MESH_RUNS:
        eng = mesh_engine(dev, job["sizes"], mesh=mesh, silo_reduce=reduce)
        cells = mesh_cells(eng, dev)
        kw = {"ckpt_path": job["ckpt"], "ckpt_every": 1} \
            if mesh == (2, 1) else {}
        torch.cuda.synchronize()
        ops.reset_launches()
        t0 = time.perf_counter()
        hists = eng.run_batch(cells, **kw)
        torch.cuda.synchronize()
        out[f"{mesh[0]}x{mesh[1]}/{reduce}"] = {
            "hists": [mesh_hist(h) for h in hists],
            "launches": ops.launches(),
            "seconds": time.perf_counter() - t0}
    return out


def mesh_run(np, torch, dev) -> dict:
    """The (cells, silo) mesh on the card (see the module docstring)."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import run_ranks

    t_phase = time.perf_counter()
    work = OUT / "mesh"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    per_round = ("greedy_argmax", "swap_best_fused", "memagg", "krum")
    info = {"phase": "mesh", "card": smi_line(), "rounds": MESH["rounds"],
            "cells": 8}

    def same(a, b, *, loss_bound=None, what=""):
        for f in ("sel", "valid", "counts"):
            if not np.array_equal(a[f], b[f]):
                raise AssertionError(f"mesh {what}: {f} differs")
        if (a["chosen"] is None) != (b["chosen"] is None) or (
                a["chosen"] is not None and
                not np.array_equal(a["chosen"], b["chosen"])):
            raise AssertionError(f"mesh {what}: Krum rows differ")
        gap = float(np.nanmax(np.abs(a["val_loss"] - b["val_loss"])))
        if loss_bound is None and not all(
                np.array_equal(a[f], b[f], equal_nan=True)
                for f in ("val_loss", "gini", "count_var", "val_acc")):
            raise AssertionError(f"mesh {what}: not bitwise ({gap})")
        if loss_bound is not None and gap > loss_bound:
            raise AssertionError(f"mesh {what}: val_loss gap {gap}")
        return gap

    # the single-device run the meshes are held to
    sizes = (MESH["rounds"], SCAN["max_sweeps"])
    eng = mesh_engine(dev, sizes)
    cells = mesh_cells(eng, dev)
    torch.cuda.synchronize()
    ops.reset_launches()
    t0 = time.perf_counter()
    single = [mesh_hist(h) for h in eng.run_batch(cells)]
    torch.cuda.synchronize()
    info["single_s"] = time.perf_counter() - t0
    single_l = {k: ops.launches()[k] for k in per_round}
    info["single_launches"] = single_l

    # (a) a one-rank NCCL world, mesh (1, 1): bitwise the unmeshed run
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                                init_method=f"file://{tmp}/init",
                                world_size=1, rank=0)
        try:
            eng1 = mesh_engine(dev, sizes, mesh=(1, 1))
            t0 = time.perf_counter()
            one = [mesh_hist(h) for h in eng1.run_batch(
                mesh_cells(eng1, dev))]
            info["a_nccl_1x1_s"] = time.perf_counter() - t0
        finally:
            dist.destroy_process_group()
    for i, (a, b) in enumerate(zip(one, single)):
        same(a, b, what=f"(a) (1, 1) cell {i}")
    info["a_nccl_1x1"] = "bitwise the unmeshed run"

    # (b) two ranks sharing the card over gloo, CUDA tensors staged
    ck = str(work / "ck_2x1")
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_rank, 2, ({"ckpt": ck, "device": str(dev),
                                       "sizes": sizes},),
                      backend="gloo",
                      init_file=str(work / "init"), timeout=900)
    info["b_seconds"] = time.perf_counter() - t0
    for name, _ in ((f"{m[0]}x{m[1]}/{r}", None) for m, r in MESH_RUNS):
        runs = [r[name] for r in ranks]
        gaps = [same(a, b, loss_bound=MESH["loss_bound"], what=name)
                for a, b in zip(runs[0]["hists"], single)]
        for other in runs[1:]:      # every rank has the whole batch
            for a, b in zip(other["hists"], runs[0]["hists"]):
                same(a, b, what=f"{name} rank 1 vs rank 0")
        got = [{k: r["launches"][k] for k in per_round} for r in runs]
        if name.startswith("2x1"):
            # the per-cell kernels add up over the ranks; each rank's block
            # holds FedGS cells and solves them together, as the single run
            # solves all of its own
            solve = ("greedy_argmax", "swap_best_fused")
            tot = {k: sum(g[k] for g in got) for k in per_round
                   if k not in solve}
            if any(tot[k] != single_l[k] for k in tot) or \
                    any(g[k] != single_l[k] for g in got for k in solve):
                raise AssertionError(f"mesh {name}: launches per rank "
                                     f"{got}, single {single_l}")
        elif any(g != single_l for g in got):
            raise AssertionError(f"mesh {name}: launches per rank {got}, "
                                 f"single {single_l}")
        info[name] = {"val_loss_gap": max(gaps), "launches": got,
                      "seconds": [r["seconds"] for r in runs]}

    # (c) the (2, 1) checkpoint (round R - 1, every round saved) resumed
    # with no mesh: the saved rounds bitwise the unbroken (2, 1) run's, the
    # resumed round's decisions bitwise and its val_loss within the (b)
    # bound (CUDA's batched products are not batch-invariant: the round
    # runs 8 cells here, 4 a rank there; ROADMAP Queue C)
    res_eng = mesh_engine(dev, sizes)
    resumed = [mesh_hist(h) for h in res_eng.run_batch(
        mesh_cells(res_eng, dev), ckpt_path=ck, resume=True, ckpt_every=1)]
    last = MESH["rounds"] - 1
    gaps = []
    for i, (a, b) in enumerate(zip(resumed, ranks[0]["2x1/gather"]["hists"])):
        gaps.append(same(a, b, loss_bound=MESH["loss_bound"],
                         what=f"(c) resumed cell {i}"))
        head = ({k: v[:last] for k, v in a.items() if k != "counts" and
                 v is not None},
                {k: v[:last] for k, v in b.items() if k != "counts" and
                 v is not None})
        if not all(np.array_equal(head[0][k], head[1][k], equal_nan=True)
                   for k in head[0]):
            raise AssertionError(f"mesh (c) cell {i}: the checkpointed "
                                 "rounds are not the (2, 1) run's")
    info["c_resume_2x1_to_none"] = {
        "checkpointed_rounds": "bitwise", "decisions": "bitwise",
        "val_loss_gap_resumed_round": max(gaps)}
    info["seconds"] = time.perf_counter() - t_phase
    return info


# ------------------------------------------------------------ phase 13
def examples_run(np, torch, dev, slice_sets: dict) -> dict:
    """The example twins on the card (see the module docstring).
    ``slice_sets``: the slice phase's FedGS and uniform sets."""
    import contextlib
    import io
    from repro_torch.examples import availability_scenarios as av
    from repro_torch.examples import federated_vision, quickstart, serve_llm

    t_phase = time.perf_counter()
    info = {"phase": "examples", "card": smi_line()}
    logs = OUT / "examples"
    logs.mkdir(exist_ok=True)
    # as users run them: on CUDA by default
    on = [] if dev.type == "cuda" else ["--device", str(dev)]

    def twin(name, fn, argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            out = fn(argv)
        (logs / f"{name}.txt").write_text(buf.getvalue())
        info[f"{name}_s"] = time.perf_counter() - t0
        return out

    runs = twin("quickstart", quickstart.main, on)
    for label in ("uniform", "fedgs"):
        hist, _ = runs[label]
        if hist.all_sampled != slice_sets[label]:
            raise AssertionError(f"examples: the quickstart twin's {label} "
                                 "sets are not the slice phase's")
    info["quickstart"] = "FedGS and uniform sets = the slice phase's, " \
        "40 of 40 rounds"
    hists = twin("availability_scenarios", av.main, on)
    eng, labels, cells = av.build(None if dev.type == "cuda" else dev)
    for label, cell in zip(labels, cells):
        own = eng.run(cell)
        if not (np.array_equal(own.sel, hists[label].sel) and
                np.array_equal(own.counts, hists[label].counts)):
            raise AssertionError(f"examples: scenario {label!r}: the "
                                 "batch's sets are not its own run's")
    info["availability_scenarios"] = f"{len(labels)} scenarios' sets = " \
        "their own runs'"
    vis = twin("federated_vision", federated_vision.main,
               ["--rounds", "3", "--clients", "20", *on])
    if not all(np.isfinite(h.best_loss) for h, _ in vis.values()):
        raise AssertionError("examples: the vision twin's losses")
    tok = twin("serve_llm", serve_llm.main, ["--batch", "4", "--gen", "8",
                                             *on])
    if tok.shape != (4, 8):
        raise AssertionError(f"examples: serve_llm tokens {tok.shape}")
    from repro_torch.examples import train_federated_lm as tfl
    from repro_torch.launch import train
    argv = ["--rounds", "2", *on]
    _, counts, sets = twin("train_federated_lm", tfl.main, argv)
    own = []
    with contextlib.redirect_stdout(io.StringIO()):
        _, own_counts = train.main(tfl.with_defaults(argv), on_round=lambda
                                   r: own.append(r["sel"].tolist()))
    if sets != own or not np.array_equal(counts, own_counts):
        raise AssertionError("examples: the training twin's sets are not "
                             "train.main's")
    info["train_federated_lm"] = "2 rounds' sets and counts = train.main's"
    info["seconds"] = time.perf_counter() - t_phase
    return info


# ------------------------------------------------------------ phase 7
def visible_pairs(s: int, window: int) -> int:
    """Σ_i min(i + 1, window) over i < s: the (query, key) pairs one head
    of one sequence attends to."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_kernel_checks(np, torch, dev, shapes=WA_SHAPES) -> dict:
    """The window attention kernel against its plain version at ``shapes``:
    f32 within 1e-5 absolute, bf16 within one bf16 ulp of the plain output
    (2⁻⁷·|o| + 1e-6).  Times by CUDA events: the kernel, the plain
    version, and scaled_dot_product_attention on (B, H, S, D) with the KV
    heads repeated (is_causal for full attention, a boolean band mask for
    a window).  Returns shape -> row."""
    import torch.nn.functional as F
    from repro_torch.kernels import window_attention as wa

    rows = {}
    for b, s, hq, hkv, d, dt, window in shapes:
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


def _gated_agreement(torch, card, cpu, what: str = "serve (c)"):
    """Greedy tokens card vs CPU (or any two runs) per row of logits: where
    the first's top-2 margin exceeds the row's largest |Δlogit| the argmax
    must agree.  Returns (agreeing rows, rows, gated rows)."""
    top2 = card.float().topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    gap = (card.float() - cpu.float()).abs().max(dim=-1).values
    same = card.argmax(-1) == cpu.argmax(-1)
    gated = margin > gap
    if not bool(same[gated].all()):
        raise AssertionError(f"{what}: greedy tokens differ where the "
                             f"margin {margin.tolist()} exceeds the gap "
                             f"{gap.tolist()}")
    return int(same.sum()), same.numel(), int(gated.sum())


def _lm_close(torch, got, want, what: str) -> float:
    err = (got.float().cpu() - want.float().cpu()).abs()
    if not bool((err <= LM_ATOL + LM_RTOL * want.float().cpu().abs()).all()):
        raise AssertionError(f"serve {what}: logits beyond atol {LM_ATOL}, "
                             f"rtol {LM_RTOL} ({float(err.max())})")
    return float(err.max())


def served_main(torch, cfg, argv, n_b9: int, what: str):
    """``serve.main(argv)`` as a user runs it, its print captured and the
    launch counts reset before it and read after: B9 ``n_b9`` times and
    no other kernel, every token in the vocabulary.  Returns (the tokens,
    the printed lines, a row: argv, launches, seconds, the printed prefill
    s, decode s and tok/s, the first sequence's head)."""
    import contextlib
    import io
    import re
    from repro_torch.kernels import ops
    from repro_torch.launch import serve

    out = io.StringIO()
    ops.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        gen = serve.main(argv)
    main_s = time.perf_counter() - t0
    launched = ops.launches()
    printed = out.getvalue().splitlines()
    if launched["window_attention"] != n_b9 or any(
            n for k, n in launched.items() if k != "window_attention"):
        raise AssertionError(f"{what}: launches {launched}, expected {n_b9} "
                             f"of window_attention only")
    shape = tuple(int(argv[argv.index(k) + 1]) for k in ("--batch", "--gen"))
    if gen.shape != shape or gen.min() < 0 or gen.max() >= cfg.padded_vocab:
        raise AssertionError(f"{what}: tokens {gen.shape}, range "
                             f"[{gen.min()}, {gen.max()}]")
    m = re.match(r"prefill: ([0-9.]+)s  decode: ([0-9.]+)s \(([0-9.]+) "
                 r"tok/s\)", printed[1])
    return gen, printed, {"argv": argv, "launches": n_b9, "main_s": main_s,
                          "printed_prefill_s": float(m.group(1)),
                          "printed_decode_s": float(m.group(2)),
                          "printed_tok_per_s": float(m.group(3)),
                          "first_sequence": gen[0][:16].tolist()}


def warm_generate(np, params, cfg, tokens, gen, what: str, inputs=None):
    """``serve.generate`` on main's weights and request, timed by its own
    clock; its tokens must be main's.  Returns the warm prefill ms, decode
    ms a step and tok/s."""
    from repro_torch.launch import serve

    n_b, n_g = gen.shape
    warm, t = serve.generate(params, cfg, tokens, gen=n_g, inputs=inputs)
    if not np.array_equal(warm.cpu().numpy(), gen):
        raise AssertionError(f"{what}: the warm repeat's tokens differ from "
                             f"main's")
    return {"warm_prefill_ms": t["prefill_s"] * 1e3,
            "warm_decode_ms_per_step": t["decode_s"] * 1e3 / (n_g - 1),
            "warm_tok_per_s": n_b * n_g / t["decode_s"]}


def serve_run(np, torch, dev) -> tuple[dict, int]:
    """Phase 7: (b) serve smollm-135m through ``launch.serve.main`` with the
    launch counts reset before and read after (30 window-attention
    launches, one per layer, none in decode), then a warm repeat timed and
    profiled; (c) a second request card vs CPU with the same weights,
    prefill and teacher-forced decode; (d) the long-context variant's
    prefill of 8,191 tokens + one decode step against the prefill of
    8,192.  Returns (info, (b)'s launches of the kernel)."""
    import dataclasses
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
    gen, printed, info["b"] = served_main(torch, cfg, argv, cfg.n_layers,
                                          "serve (b)")
    for line in printed:
        emit(line)

    # the same request warm: generate() twice on the same weights, the
    # second timed; then one prefill and 4 decode steps profiled
    params = lm.init_params(cfg, seed=0, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (SERVE_MAIN["batch"], SERVE_MAIN["prompt"])),
        device=dev)
    serve.generate(params, cfg, tokens, gen=SERVE_MAIN["gen"])
    torch.cuda.reset_peak_memory_stats()
    info["b"].update(warm_generate(np, params, cfg, tokens, gen, "serve (b)"),
                     peak_mem_bytes=int(torch.cuda.max_memory_allocated()))
    info["b"]["profiled_prefill"] = dict(decode_steps=0, **profiled(
        torch, lambda: lm.prefill(params, cfg, {"tokens": tokens}))[0])
    logits, cache = lm.prefill(params, cfg, {"tokens": tokens},
                               max_len=SERVE_MAIN["prompt"] + 5)

    def four_steps(logits=logits, cache=cache):
        for _ in range(4):
            logits, cache = lm.decode_step(params, cfg, logits.argmax(-1),
                                           cache)
    info["b"]["profiled_decode"] = dict(decode_steps=4, **profiled(
        torch, four_steps)[0])

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
    return info, info["b"]["launches"]


# ------------------------------------------------------------ phase 14
# federated LM training (launch/train.py) at smollm-135m's full width: the
# reference docstring's accelerator run (--reduced dropped)
TRAIN_ARCH = "smollm-135m"
TRAIN_ARGV = ["--arch", TRAIN_ARCH, "--clients", "16", "--sample-frac",
              "0.25", "--local-steps", "4", "--batch", "4", "--seq", "64",
              "--sampler", "fedgs", "--mode", "SLN", "--seed", "0"]
TRAIN = {"rounds": 5, "krum_rounds": 3, "byz_frac": 0.25, "max_sweeps": 64,
         "loss_rtol": 1e-5, "grad_rtol": 1e-4, "val_bound": 1e-4}
MOE_ARCH = "granite-moe-1b-a400m"
MOE_SERVE = {"batch": 2, "prompt": 32, "gen": 9}
MOE_TRAIN_BATCH = (4, 64)


def _to_cpu(torch, tree):
    """A nested dict / list of tensors copied to the CPU."""
    if isinstance(tree, dict):
        return {k: _to_cpu(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return tree


def _host_rows(np, n_seq: int, steps: int, batch: int):
    """batch_indices(t, slot, client): (E, B) rows from a numpy stream keyed
    by (t, slot), the same on the card and on the CPU."""
    def rows(t, j, k):
        rng = np.random.default_rng(np.random.SeedSequence([7, t, j]))
        return rng.integers(0, n_seq, (steps, batch))
    return rows


def _fedgs_plain_set(np, torch, info, max_sweeps: int) -> list:
    """The round's FedGS set from the card's H, counts and mask, solved by
    the plain versions on the CPU."""
    from repro_torch.core.sampler_device import fedgs_select
    sampler, avail = info["setup"].sampler, info["avail"]
    m = info["setup"].m
    s = fedgs_select(sampler._h.cpu(),
                     torch.as_tensor(info["counts"], dtype=torch.float32),
                     torch.as_tensor(avail), sampler.alpha,
                     m=int(min(m, avail.sum())), max_sweeps=max_sweeps,
                     m_target=m)
    return np.flatnonzero(s.numpy()).tolist()


def _krum_plain_rows(torch, info) -> list:
    """The Krum rows the plain version picks on the CPU from the round's
    stacked updates (as aggregated); the card's are the server's."""
    from repro_torch.fed.aggregator_device import _flat_template, krum_select
    server = info["server"]
    ravel, _, _ = _flat_template(server.state["prev"])
    x = ravel(info["stacked"]).cpu()
    th = [float(v) for v in server.process.params()["theta"]]
    chosen, _ = krum_select(x, torch.ones(x.shape[0], dtype=torch.bool),
                            int(round(th[0])), int(round(th[1])))
    return chosen.tolist()


def _round_rows(info, train_argv) -> dict:
    """A round's printed numbers."""
    args = {train_argv[i]: train_argv[i + 1]
            for i in range(0, len(train_argv) - 1, 2)}
    steps = len(info["sel"]) * int(args["--local-steps"])
    tokens = steps * int(args["--batch"]) * int(args["--seq"])
    wall = info["train_s"] + info["aggregate_s"] + info["eval_s"]
    return {"t": info["t"], "sel": info["sel"].tolist(),
            "val_loss": info["val_loss"], "round_s": wall,
            "local_step_ms": info["train_s"] * 1e3 / steps,
            "train_tokens_per_s": tokens / info["train_s"],
            "aggregate_ms": info["aggregate_s"] * 1e3,
            "eval_ms": info["eval_s"] * 1e3}


def train_full_width(np, torch, dev, info: dict) -> dict:
    """(a) the memory aggregator over the (16, 134.5M) panel and (b) Krum
    under a 25% sign-flip, both through ``launch.train.main`` as users run
    it.  Returns the launches of (a) + (b)."""
    from repro_torch.kernels import aggregate as ag
    from repro_torch.kernels import krum as kr
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    # (a) memory: every round's set against the plain solve, memagg's first
    # call against its plain version on the same panel
    argv = TRAIN_ARGV + ["--aggregator", "memory", "--rounds",
                         str(TRAIN["rounds"])]
    rounds, last, check = [], {}, {}
    orig = ops.memory_aggregate

    def memagg_checked(mem, upd, sel, valid, w):
        if check:
            out = orig(mem, upd, sel, valid, w)
        else:
            before = mem.clone()
            out = orig(mem, upd, sel, valid, w)
            pm, pr = ag.memory_scatter_reduce_ref(before, upd, sel, valid, w)
            torch.cuda.synchronize()
            if not torch.equal(out[0], pm):
                raise AssertionError("train (a): memagg's panel is not the "
                                     "plain scatter's")
            e = (out[1] - pr).abs()
            check.update(
                entries=mem.numel(), max_abs_err=float(e.max()),
                within=bool((e <= 1e-5 + 1e-5 * pr.abs()).all()),
                tolerance="panel bitwise, red atol = rtol = 1e-5")
            del before, pm, pr
            if not check["within"]:
                raise AssertionError(f"train (a): memagg's reduction beyond "
                                     f"1e-5 ({check['max_abs_err']})")
        last.update(args=(mem, upd, sel, valid, w))
        return out

    def on_round(r):
        want = _fedgs_plain_set(np, torch, r, TRAIN["max_sweeps"])
        if r["sel"].tolist() != want:
            raise AssertionError(f"train (a) round {r['t']}: set "
                                 f"{r['sel'].tolist()} != the plain solve's "
                                 f"{want}")
        rounds.append({**_round_rows(r, argv),
                       "available": int(r["avail"].sum())})
        last.update(info=r)

    ops.memory_aggregate = memagg_checked
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launches()
        t0 = time.perf_counter()
        params, counts = train.main(argv, on_round=on_round)
        torch.cuda.synchronize()
        main_s = time.perf_counter() - t0
        launched = ops.launches()
    finally:
        ops.memory_aggregate = orig
    peak = torch.cuda.max_memory_allocated()
    n_rounds, m = len(rounds), last["info"]["setup"].m
    want = {"pairwise_similarity": 1, "adjacency": 1, "floyd_warshall": 1,
            "greedy_argmax": sum(min(m, r["available"]) for r in rounds),
            "swap_best_fused": TRAIN["max_sweeps"] * n_rounds,
            "memagg": n_rounds, "window_attention": 0}
    # the solve at N = 16 is the cell axis at B = 1, whose launches count
    # under the per-step kernels' names too
    for cell, per_step in ops.STANDS_FOR.items():
        want[cell] = want[per_step]
    others = {k: v for k, v in launched.items() if k not in want and v}
    if any(launched[k] != v for k, v in want.items()) or others or \
            n_rounds != TRAIN["rounds"]:
        raise AssertionError(f"train (a): launches {launched}, expected "
                             f"{want} over {n_rounds} rounds")
    if not all(bool(torch.isfinite(v.float()).all()) for v in params.values()):
        raise AssertionError("train (a): a parameter is not finite")
    n_params = sum(v.numel() for v in params.values())
    # one more round, profiled (device activity only: a round launches
    # ~1e5 kernels, and the host ops' events would cost more than the
    # round): its device busy share
    r = last["info"]
    args = train.parse_args(argv)
    prof, _ = profiled(torch, lambda: train.train_round(
        r["setup"], args, params, r["server"], None, TRAIN["rounds"],
        r["sel"], r["avail"]), host=False, top=6)
    # memagg at this shape: times beside its bound
    mem, upd, sel, valid, w = last["args"]
    n, p = mem.shape
    mm = sel.shape[0]
    b, by = bound(4 * (mm * p + n * p + n + p) + 9 * mm, 2 * n * p)

    def library():
        mem.index_copy_(0, sel, upd)
        return torch.mv(mem.T, w)
    memagg_row = dict(
        n=n, p=p, m=mm, plan=ag.memagg_plan(n, p, mm), **check,
        ms=cuda_ms(torch, lambda: ag.memory_aggregate_cuda(
            mem, upd, sel, valid, w), max_reps=20),
        device_ms=device_ms(torch, lambda: ag.memory_aggregate_cuda(
            mem, upd, sel, valid, w), reps=5),
        plain_ms=cuda_ms(torch, lambda: ag.memory_scatter_reduce_ref(
            mem, upd, sel, valid, w), max_reps=5),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, library, max_reps=5),
        library="index_copy_ + torch.mv")
    memagg_row["x_bound"] = memagg_row["device_ms"] / b
    del mem, upd, sel, valid, w, library
    last.clear()
    r = None
    info["a"] = {"argv": argv, "n_params": n_params,
                 "panel_entries": check["entries"],
                 "panel_over_2p31": check["entries"] > 2 ** 31,
                 "main_s": main_s, "rounds": rounds,
                 "launches": {k: launched[k] for k in want},
                 "launch_gates": want, "peak_mem_bytes": int(peak),
                 "counts": counts.tolist(), "memagg": memagg_row,
                 "profiled_round": prof}
    del params
    torch.cuda.empty_cache()

    # (b) Krum under a 25% sign-flip: every round's rows against the plain
    # selection on the CPU from the same stacked updates
    argv_b = TRAIN_ARGV + ["--aggregator", "krum", "--fault", "sign_flip",
                           "--byzantine-frac", str(TRAIN["byz_frac"]),
                           "--rounds", str(TRAIN["krum_rounds"])]
    rows_b, xs = [], {}

    def on_round_b(r):
        card = r["server"].last_chosen.cpu().tolist()
        plain = _krum_plain_rows(torch, r)
        if card != plain:
            raise AssertionError(f"train (b) round {r['t']}: Krum rows "
                                 f"{card} != the plain selection's {plain}")
        rows_b.append({**_round_rows(r, argv_b), "krum_rows": card})
        from repro_torch.fed.aggregator_device import _flat_template
        xs["x"] = _flat_template(r["server"].state["prev"])[0](r["stacked"])

    ops.reset_launches()
    params, _ = train.main(argv_b, on_round=on_round_b)
    launched_b = ops.launches()
    if launched_b["krum"] != TRAIN["krum_rounds"] or launched_b["memagg"]:
        raise AssertionError(f"train (b): launches {launched_b}")
    if not all(bool(torch.isfinite(v.float()).all()) for v in params.values()):
        raise AssertionError("train (b): a parameter is not finite")
    x = xs.pop("x").contiguous()
    mk, pk = x.shape
    b, by = bound(4 * (mk * pk + mk * mk), mk * (mk + 1) * pk)
    krum_row = dict(
        m=mk, p=pk, plan=kr.krum_plan(mk, pk),
        ms=cuda_ms(torch, lambda: kr.krum_distances_cuda(x), max_reps=20),
        device_ms=device_ms(torch, lambda: kr.krum_distances_cuda(x),
                            reps=5),
        plain_ms=cuda_ms(torch, lambda: kr.krum_pairwise_ref(x), max_reps=5),
        bound_ms=b, bound_by=by,
        library_ms=cuda_ms(torch, lambda: torch.cdist(x, x).square(),
                           max_reps=5),
        library="torch.cdist(x, x).square()")
    krum_row["x_bound"] = krum_row["device_ms"] / b
    info["b"] = {"argv": argv_b, "rounds": rows_b, "krum": krum_row,
                 "launches": {k: v for k, v in launched_b.items() if v},
                 "krum_rows": "bitwise the plain selection's, every round"}
    del x, params
    torch.cuda.empty_cache()
    return {k: launched[k] + launched_b[k] for k in launched}


def train_step_card_vs_cpu(np, torch, dev) -> dict:
    """(c) one local AdamW step at full width from the same weights and
    batch, card against CPU: f32 gated (loss, the gradient's global norm of
    difference), bf16 printed."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.optim.optimizers import adamw
    from repro_torch.utils.tree import global_norm

    out = {"tf32_matmul": torch.backends.cuda.matmul.allow_tf32}
    toks = torch.as_tensor(np.random.default_rng(11).integers(0, 512, (4,
                                                                      65)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(get_config(TRAIN_ARCH), dtype=dt)
        p_cpu = lm.init_params(cfg, seed=0, device="cpu")
        p_dev = {k: v.to(dev) for k, v in p_cpu.items()}

        def loss_fn(p, b):
            return lm.train_loss(p, cfg, b, remat=False)
        t0 = time.perf_counter()
        l_cpu, g_cpu = steps.value_and_grad(loss_fn, p_cpu, batch)
        cpu_s = time.perf_counter() - t0
        l_dev, g_dev = steps.value_and_grad(
            loss_fn, p_dev, {k: v.to(dev) for k, v in batch.items()})
        gap = {k: g_dev[k].cpu().float() - g_cpu[k].float() for k in g_cpu}
        row = {"loss_cpu": float(l_cpu), "loss_card": float(l_dev),
               "loss_rel_gap": abs(float(l_dev) - float(l_cpu)) /
               abs(float(l_cpu)),
               "grad_norm": float(global_norm(g_cpu)),
               "grad_gap_rel": float(global_norm(gap)) /
               float(global_norm(g_cpu)), "cpu_step_s": cpu_s}
        opt = adamw()
        with torch.no_grad():
            n_cpu, _ = opt.update(g_cpu, opt.init(p_cpu), p_cpu, 3e-3)
            n_dev, _ = opt.update(g_dev, opt.init(p_dev), p_dev, 3e-3)
        d = [(n_dev[k].cpu().float() - n_cpu[k].float()).abs() for k in n_cpu]
        row["adamw_param_max_gap"] = max(float(x.max()) for x in d)
        row["adamw_params_off_by_1e-4"] = sum(int((x > 1e-4).sum())
                                              for x in d)
        out[dt] = row
        del p_cpu, p_dev, g_cpu, g_dev, n_cpu, n_dev, gap, d
    f32 = out["float32"]
    if f32["loss_rel_gap"] > TRAIN["loss_rtol"] or \
            f32["grad_gap_rel"] > TRAIN["grad_rtol"]:
        raise AssertionError(f"train (c): f32 step card vs CPU: loss "
                             f"{f32['loss_rel_gap']}, gradient "
                             f"{f32['grad_gap_rel']}")
    out["bounds"] = (f"f32: loss rel <= {TRAIN['loss_rtol']}, |g_card - "
                     f"g_cpu| / |g_cpu| <= {TRAIN['grad_rtol']}; bf16 "
                     "printed")
    torch.cuda.empty_cache()
    return out


def train_reduced_card_vs_cpu(np, torch, dev) -> dict:
    """(d) the reduced f32 config, 5 rounds, memory and Krum (under the
    25% sign-flip), card against CPU on the same host batch rows: sets,
    counts and Krum rows bitwise free-running; val_loss within 1e-4 each
    round from the card's state (the round replayed on the CPU from the
    card's params and server state), the free-running gap printed."""
    from repro_torch.fed.faults_device import (HostFaultInjector,
                                               make_fault_process)
    from repro_torch.fed.aggregator_device import make_aggregator_process
    from repro_torch.fed.server import ServerAggregator
    from repro_torch.launch import train

    out = {}
    for agg in ("memory", "krum"):
        argv = TRAIN_ARGV + ["--reduced", "--aggregator", agg, "--rounds",
                             str(TRAIN["rounds"])]
        if agg == "krum":
            argv += ["--fault", "sign_flip", "--byzantine-frac",
                     str(TRAIN["byz_frac"])]
        args_cpu = train.parse_args(argv + ["--device", "cpu"])
        rows = _host_rows(np, args_cpu.batch * 8 - 1, args_cpu.local_steps,
                          args_cpu.batch)
        runs = {}
        for side, extra in (("card", []), ("cpu", ["--device", "cpu"])):
            rec = []

            def keep(r, rec=rec, side=side):
                rec.append({"t": r["t"], "sel": r["sel"].tolist(),
                            "avail": r["avail"], "val_loss": r["val_loss"],
                            "chosen": None if r["server"].last_chosen is None
                            else r["server"].last_chosen.cpu().tolist(),
                            "after": None if side == "cpu" else _to_cpu(
                                torch, {"params": r["params"],
                                        "server": r["server"].state,
                                        "faults": None if r["faults"] is None
                                        else r["faults"].state})})
            _, counts = train.main(argv + extra, batch_indices=rows,
                                   on_round=keep)
            runs[side] = (rec, counts)
        (card, c_card), (cpu, c_cpu) = runs["card"], runs["cpu"]
        if [r["sel"] for r in card] != [r["sel"] for r in cpu] or \
                not np.array_equal(c_card, c_cpu):
            raise AssertionError(f"train (d) {agg}: sets or counts differ")
        if [r["chosen"] for r in card] != [r["chosen"] for r in cpu]:
            raise AssertionError(f"train (d) {agg}: Krum rows differ")
        # each round t > 0 again on the CPU from the card's state after t-1
        s = train.setup(args_cpu)
        replay = [abs(cpu[0]["val_loss"] - card[0]["val_loss"])]
        for prev, now in zip(card, card[1:]):
            st = prev["after"]
            server = ServerAggregator(make_aggregator_process(agg),
                                      n_clients=s.n, data_sizes=s.sizes)
            server.init(st["params"])
            server.state = st["server"]
            faults = None
            if st["faults"] is not None:
                faults = HostFaultInjector(
                    make_fault_process("sign_flip", s.n,
                                       frac=TRAIN["byz_frac"]),
                    fault_seed=args_cpu.seed + 0xFA17)
                faults.init(st["params"])
                faults.state = st["faults"]
            got = train.train_round(s, args_cpu, st["params"], server, faults,
                                    now["t"], np.asarray(now["sel"]),
                                    now["avail"], batch_indices=rows)
            if agg == "krum" and server.last_chosen.tolist() != now["chosen"]:
                raise AssertionError(f"train (d) krum round {now['t']}: "
                                     "replayed Krum rows differ")
            replay.append(abs(got["val_loss"] - now["val_loss"]))
        if max(replay) > TRAIN["val_bound"]:
            raise AssertionError(f"train (d) {agg}: val_loss from the card's "
                                 f"state {replay} beyond {TRAIN['val_bound']}")
        out[agg] = {"sets": [r["sel"] for r in card],
                    "counts": c_card.tolist(),
                    "krum_rows": [r["chosen"] for r in card],
                    "val_loss_card": [r["val_loss"] for r in card],
                    "val_gap_free_running": [abs(a["val_loss"] -
                                                 b["val_loss"])
                                             for a, b in zip(card, cpu)],
                    "val_gap_from_card_state": replay}
    out["bound"] = (f"sets, counts, Krum rows bitwise; val_loss <= "
                    f"{TRAIN['val_bound']} a round from the card's state")
    return out


def train_moe(np, torch, dev) -> dict:
    """(e) granite-moe-1b-a400m at full width, random weights: serve.main
    (B9 prefill + 8 decode steps); each layer's output and each step's
    logits on the CPU from the card's state within the serve gates, the
    card's tokens and expert choices forced (a random router's top-8 of 32
    sits on near-ties that bf16 round-off flips; the CPU's own choice must
    agree wherever its margin exceeds twice the probabilities' gap); the
    free-running gaps and both sides' gaps to an f32 run printed; one
    train step on the card, finite, and again, bitwise."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, steps
    from repro_torch.models import ffn, lm

    cfg = get_config(MOE_ARCH)
    out = {"arch": MOE_ARCH, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "experts": [cfg.moe.num_experts, cfg.moe.top_k],
           "dtype": cfg.dtype}
    argv = ["--arch", MOE_ARCH, "--batch", str(MOE_SERVE["batch"]),
            "--prompt-len", str(MOE_SERVE["prompt"]), "--gen",
            str(MOE_SERVE["gen"]), "--seed", "0"]
    # one draw of the weights (24 s on the CPU at this width) serves both
    # sides: serve.main's own ``lm.init_params(cfg, seed=0, device=card)``
    # draws on the CPU and moves the result, so it gets these moved
    t0 = time.perf_counter()
    params_cpu = lm.init_params(cfg, seed=0, device="cpu")
    out["init_s"] = time.perf_counter() - t0
    params = {k: v.to(dev) for k, v in params_cpu.items()}
    real_init = lm.init_params

    def drawn(c, *, seed=0, device=None, draw="host"):
        if c != cfg or seed != 0 or draw != "host":
            raise AssertionError("train (e): serve.main asked for other "
                                 "weights")
        return params
    ops.reset_launches()
    t0 = time.perf_counter()
    lm.init_params = drawn
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            served = serve.main(argv)
    finally:
        lm.init_params = real_init
    out["serve_main_s"] = time.perf_counter() - t0
    launched = ops.launches()
    if launched["window_attention"] != cfg.n_layers or \
            any(v for k, v in launched.items() if k != "window_attention"):
        raise AssertionError(f"train (e): serve launches {launched}")
    out["n_params"] = sum(v.numel() for v in params.values())
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MOE_SERVE["batch"], MOE_SERVE["prompt"])))
    n_gen = MOE_SERVE["gen"]

    def steps_of(p, c, tk, forced, tap=None):
        """Prefill, then n_gen - 1 decode steps (the card's greedy tokens,
        or ``forced``'s): every step's logits."""
        logits, cache = lm.prefill(p, c, {"tokens": tk},
                                   max_len=tk.shape[1] + n_gen, tap=tap)
        res = [logits]
        for i in range(1, n_gen):
            nxt = logits.argmax(-1) if forced is None else forced[:, i - 1]
            logits, cache = lm.decode_step(p, c, nxt, cache, tap=tap)
            res.append(logits)
        return res

    # the card's run records each layer's output and each MoE call's
    # expert choices
    real_top_k, calls, layers = ffn._top_k, [], []

    def recorded(probs, k):
        vals, idx = real_top_k(probs, k)
        calls.append((idx.cpu(), probs.detach().float().cpu()))
        return vals, idx

    def record(i, x):
        layers.append(x.cpu())
        return x
    ffn._top_k = recorded
    try:
        card = steps_of(params, cfg, toks.to(dev), None, tap=record)
    finally:
        ffn._top_k = real_top_k
    card_toks = torch.stack([x.argmax(-1) for x in card], 1).cpu()
    if not np.array_equal(card_toks.numpy(), served):
        raise AssertionError("train (e): serve.main's tokens are not the "
                             "step loop's")
    # the CPU from the card's state: each layer from the card's input to
    # it, the card's expert choices forced, its own choice held where its
    # margin exceeds twice the probabilities' gap
    route = {"calls": 0, "tokens": 0, "flips": 0, "gated": 0,
             "gated_flips": 0}
    queue, layer_q, layer_err = iter(calls), iter(layers), []

    def forced(probs, k):
        idx, p_card = next(queue)
        _, own = real_top_k(probs, k)
        top = torch.sort(probs.float(), dim=-1, descending=True).values
        margin = top[..., k - 1] - top[..., k]
        gap = (probs.float() - p_card).abs().amax(-1)
        flip = (torch.sort(own, -1).values !=
                torch.sort(idx, -1).values).any(-1)
        gated = margin > 2 * gap
        route["calls"] += 1
        route["tokens"] += flip.numel()
        route["flips"] += int(flip.sum())
        route["gated"] += int(gated.sum())
        route["gated_flips"] += int((flip & gated).sum())
        return probs.gather(-1, idx), idx

    def from_card(i, x):
        want = next(layer_q)
        layer_err.append(_over_gate(x, want))
        return want.to(x.dtype)
    ffn._top_k = forced
    t0 = time.perf_counter()
    try:
        cpu = steps_of(params_cpu, cfg, toks, card_toks, tap=from_card)
    finally:
        ffn._top_k = real_top_k
    out["cpu_serve_s"] = time.perf_counter() - t0
    logit_err = [_over_gate(a, b) for a, b in zip(card, cpu)]
    layer_route = dict(route)
    # findings, not gated: the CPU free-running (the card's tokens only;
    # then its expert choices too), and both sides against an f32 run of
    # the same weights on the CPU
    free = steps_of(params_cpu, cfg, toks, card_toks)
    queue = iter(calls)
    route.update({k: 0 for k in route})
    ffn._top_k = forced
    try:
        routed = steps_of(params_cpu, cfg, toks, card_toks)
    finally:
        ffn._top_k = real_top_k
    p32 = {k: v.float() for k, v in params_cpu.items()}
    truth = steps_of(p32, dataclasses.replace(cfg, dtype="float32"), toks,
                     card_toks)
    del p32
    if layer_route["gated_flips"]:
        raise AssertionError(f"train (e): the CPU routes otherwise where its "
                             f"margin exceeds twice the gap: {layer_route}")
    worst = max(o for _, o in layer_err + logit_err)
    if worst > 1:
        raise AssertionError(f"train (e): a layer or the logits beyond atol "
                             f"{LM_ATOL}, rtol {LM_RTOL} from the card's "
                             f"state ({worst} of the gate)")
    agree = [_gated_agreement(torch, a.cpu(), b) for a, b in zip(card, cpu)]
    out["serve"] = {
        "argv": argv, "launches": launched["window_attention"],
        "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}, each layer and each "
                 "step's logits on the CPU from the card's state, the "
                 "card's tokens and expert choices forced",
        "logits_max_abs_err": [e for e, _ in logit_err],
        "logits_of_gate": [o for _, o in logit_err],
        "layers_max_abs_err": max(e for e, _ in layer_err),
        "layers_of_gate": max(o for _, o in layer_err),
        "layers_checked": len(layer_err), "routing": layer_route,
        "free_running": [_over_gate(a, b) for a, b in zip(card, free)],
        "routing_forced_only": [_over_gate(a, b) for a, b in
                                zip(card, routed)],
        "routing_free_running_from_card_choices": dict(route),
        "card_vs_f32": [_over_gate(a, b)[0] for a, b in zip(card, truth)],
        "cpu_vs_f32": [_over_gate(a, b)[0] for a, b in zip(free, truth)],
        "greedy_agree": sum(a[0] for a in agree),
        "greedy_total": sum(a[1] for a in agree),
        "greedy_gated": sum(a[2] for a in agree)}
    del params_cpu, card, cpu, free, routed, truth, calls, layers
    # one train step, twice
    b, s = MOE_TRAIN_BATCH
    tk = torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab_size, (b, s + 1)), device=dev)
    batch = {"tokens": tk[:, :-1], "labels": tk[:, 1:]}

    def loss_fn(p, bb):
        return lm.train_loss(p, cfg, bb)
    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    l1, g1 = steps.value_and_grad(loss_fn, params, batch)
    torch.cuda.synchronize()
    grad_s = time.perf_counter() - t0
    l2, g2 = steps.value_and_grad(loss_fn, params, batch)
    if any(ops.launches().values()):
        raise AssertionError(f"train (e): the train step launched "
                             f"{ops.launches()}")
    finite = bool(torch.isfinite(l1)) and all(
        bool(torch.isfinite(g.float()).all()) for g in g1.values())
    same = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k]) for k in g1)
    del g1, g2
    step, opt = steps.make_train_step(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n1, _, s1 = step(params, opt.init(params), batch, 1e-3)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    n2, _, s2 = step(params, opt.init(params), batch, 1e-3)
    same_step = torch.equal(s1, s2) and all(torch.equal(n1[k], n2[k])
                                            for k in n1)
    finite = finite and all(bool(torch.isfinite(v.float()).all())
                            for v in n1.values())
    out["train"] = {"batch": [b, s], "loss": float(l1),
                    "value_and_grad_s": grad_s, "train_step_s": step_s,
                    "finite": finite, "repeat_bitwise": same and same_step}
    if not finite:
        raise AssertionError("train (e): a loss, gradient or parameter is "
                             "not finite")
    if not (same and same_step):
        raise AssertionError("train (e): the train step does not repeat bit "
                             "for bit on the card")
    del n1, n2, params
    torch.cuda.empty_cache()
    return out


def train_run(np, torch, dev) -> tuple[dict, dict]:
    """Phase 14 (see the module docstring), one JSON line per part as it
    ends.  Returns (the phase's summary, the launches of (a) and (b))."""
    t_phase = time.perf_counter()
    card = smi_line()
    parts = {}
    t0 = time.perf_counter()
    info: dict = {}
    launches = train_full_width(np, torch, dev, info)
    parts["ab"] = time.perf_counter() - t0
    for part in ("a", "b"):
        emit({"phase": "train", "part": part, "card": card,
              "arch": TRAIN_ARCH, part: info[part]})
    for part, fn in (("c", train_step_card_vs_cpu),
                     ("d", train_reduced_card_vs_cpu), ("e", train_moe)):
        t0 = time.perf_counter()
        row = fn(np, torch, dev)
        parts[part] = time.perf_counter() - t0
        emit({"phase": "train", "part": part, "card": card, part: row,
              "seconds": parts[part]})
    return {"phase": "train", "card": card, "seconds_per_part": parts,
            "seconds": time.perf_counter() - t_phase}, launches


# ------------------------------------------------------------ phase 16
# the SSM, hybrid, VLM and audio families at full width (random weights,
# drawn on the card from a seed): each config's source
FAMILY_SOURCES = {"mamba2-780m": "arXiv:2405.21060",
                  "hymba-1.5b": "arXiv:2411.13676",
                  "llava-next-mistral-7b":
                      "hf:llava-hf/llava-v1.6-mistral-7b-hf",
                  "seamless-m4t-large-v2": "arXiv:2308.11596"}
# B9 launches per prefill: one per layer with causal self-attention (the
# audio family's encoder and cross-attention take the plain route)
FAMILY_B9 = {"mamba2-780m": 0, "hymba-1.5b": 32,
             "llava-next-mistral-7b": 32, "seamless-m4t-large-v2": 24}
FAMILY_SERVE = {"batch": 8, "prompt": 64, "gen": 32}
# (b) card vs CPU: batch 2, a 32-token prompt, 8 decode steps; the audio
# family's encoder over 64 frames (the CPU cannot take 1,024 in time)
FAMILY_CHECK = {"batch": 2, "prompt": 32, "steps": 8, "frames": 64}
LLAVA_LAYERS = (0, 15, 31)
# (c) llava: 2,880 image + 1,216 text positions = one window exactly; then
# 2,880 + 2,048 = 4,928 positions, the window active, served with 4 tokens
RING = {"text": 1216, "steps": 16, "past_text": 2048, "past_gen": 4}
# (e) B9 at the shapes the families' prefills give it: llava's image
# prefix + prompt, llava past its window, hymba's 25/5 heads, hymba padded
# to 48/6, seamless' 16/16; the last three also in f32 (the CUDA-core body)
FAMILY_WA_SHAPES = (
    (8, 2944, 32, 8, 128, "bfloat16", None),
    (1, 4928, 32, 8, 128, "bfloat16", 4096),
    (8, 64, 25, 5, 64, "bfloat16", None),
    (8, 64, 48, 6, 64, "bfloat16", None),
    (8, 64, 16, 16, 64, "bfloat16", None),
    (8, 64, 25, 5, 64, "float32", None),
    (8, 64, 48, 6, 64, "float32", None),
    (8, 64, 16, 16, 64, "float32", None))
# the kernels line's name for each FAMILY_WA_SHAPES row; its launches are
# those of the run that prefills at that row's shape
FAMILY_WA_ROWS = ("llava_prefill", "llava_window", "hymba", "hymba_padded",
                  "seamless", "hymba/f32", "hymba_padded/f32", "seamless/f32")
FAMILY_TRAIN = {"archs": ("mamba2-780m", "hymba-1.5b"), "batch": (4, 64),
                "loss_rtol": 1e-5, "grad_rtol": 1e-4}


def _over_gate(a, b) -> tuple[float, float]:
    """(max |a − b|, its largest share of the serve gate atol + rtol·|b|)."""
    e = (a.float().cpu() - b.float().cpu()).abs()
    return float(e.max()), float(
        (e / (LM_ATOL + LM_RTOL * b.float().cpu().abs())).max())


def family_serve(np, torch, dev, arch: str) -> dict:
    """(a) ``serve.main`` as users run it (weights drawn on the card): B9
    launches per prefill, the tokens; then the same weights and request
    through prefill and the decode steps: every logit finite and the same
    tokens; a warm ``generate`` timed; one prefill profiled."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config(arch)
    n_b, n_p, n_g = (FAMILY_SERVE[k] for k in ("batch", "prompt", "gen"))
    argv = ["--arch", arch, "--batch", str(n_b), "--prompt-len", str(n_p),
            "--gen", str(n_g), "--seed", "0", "--draw", "device"]
    what = f"families (a) {arch}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen, _, main_row = served_main(torch, cfg, argv, FAMILY_B9[arch], what)
    row = {"arch": arch, "source": FAMILY_SOURCES[arch],
           "family": cfg.family, "layers": cfg.n_layers,
           "enc_layers": cfg.n_enc_layers, "d_model": cfg.d_model,
           "heads": [cfg.n_heads, cfg.n_kv_heads], "dtype": cfg.dtype,
           **main_row,
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated())}
    # the same weights and request, step by step: every logit finite
    params = lm.init_params(cfg, seed=0, device=dev, draw="device")
    tokens, inputs = serve.prompt_inputs(cfg, n_b, n_p, 0, dev)
    prefix = cfg.n_image_tokens if cfg.family == "vlm" else 0
    finite = True
    with torch.no_grad():
        logits, cache = lm.prefill(params, cfg, {"tokens": tokens, **inputs},
                                   max_len=prefix + n_p + n_g)
        steps_ = [logits.argmax(-1)]
        for _ in range(n_g - 1):
            finite = finite and bool(torch.isfinite(logits).all())
            logits, cache = lm.decode_step(params, cfg, steps_[-1], cache)
            steps_.append(logits.argmax(-1))
        finite = finite and bool(torch.isfinite(logits).all())
    del cache
    if not finite:
        raise AssertionError(f"{what}: a logit is not finite")
    if not np.array_equal(torch.stack(steps_, 1).cpu().numpy(), gen):
        raise AssertionError(f"{what}: the step loop's tokens are not "
                             f"serve.main's")
    with torch.no_grad():
        row.update(warm_generate(np, params, cfg, tokens, gen, what,
                                 inputs=inputs),
                   logits_finite=True, prefill_positions=prefix + n_p)
        row["profiled_prefill"] = profiled(torch, lambda: lm.prefill(
            params, cfg, {"tokens": tokens, **inputs}))[0]
    del params, inputs
    torch.cuda.empty_cache()
    return row


def _host_batch(cfg, seed: int, n_text: int, batch: int,
                frames: int | None = None) -> dict:
    """``serve.prompt_inputs``' request on the host, as one dict."""
    from repro_torch.launch import serve
    tokens, inputs = serve.prompt_inputs(cfg, batch, n_text, seed, "cpu",
                                         frames=frames)
    return {"tokens": tokens, **inputs}


def family_card_vs_cpu(np, torch, dev, arch: str) -> dict:
    """(b) the same weights (drawn on the card, copied to the host) and
    request on the card and the CPU: prefill + 8 decode steps fed the
    card's greedy tokens.  Free-running, the logits; and each layer (the
    encoder's first) and step from the card's state through the ``tap``
    seam.  The free-running logits are gated where they hold; where bf16
    round-off carries them past the gate, every layer and step from the
    card's state is."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm

    cfg = get_config(arch)
    c = FAMILY_CHECK
    p_dev = lm.init_params(cfg, seed=1, device=dev, draw="device")
    p_cpu = {k: v.cpu() for k, v in p_dev.items()}
    host = _host_batch(cfg, 1, c["prompt"] + c["steps"], c["batch"],
                       frames=c["frames"])
    prompt = {k: (v[:, :c["prompt"]] if k == "tokens" else v)
              for k, v in host.items()}

    def run(p, d, forced, tap=None, cfg_=cfg):
        with torch.no_grad():
            logits, cache = lm.prefill(
                p, cfg_, {k: v.to(d) for k, v in prompt.items()},
                max_len=c["prompt"] + c["steps"], tap=tap)
            res = [logits]
            for i in range(c["steps"]):
                nxt = logits.argmax(-1) if forced is None else \
                    forced[:, i].to(d)
                logits, cache = lm.decode_step(p, cfg_, nxt, cache, tap=tap)
                res.append(logits)
        return res

    layers = []

    def record(i, x):
        layers.append(x.cpu())
        return x
    t0 = time.perf_counter()
    card = run(p_dev, dev, None, record)
    card_s = time.perf_counter() - t0
    card_toks = torch.stack([x.argmax(-1) for x in card[:-1]], 1).cpu()
    t0 = time.perf_counter()
    free = run(p_cpu, "cpu", card_toks)
    cpu_s = time.perf_counter() - t0
    queue, layer_err = iter(layers), []

    def from_card(i, x):
        want = next(queue)
        layer_err.append(_over_gate(x, want))
        return want.to(x.dtype)
    held = run(p_cpu, "cpu", card_toks, from_card)
    # finding, not gated: both sides against an f32 run of the same
    # weights on the CPU
    c32 = dataclasses.replace(cfg, dtype="float32")
    truth = run({k: v.float() for k, v in p_cpu.items()}, "cpu", card_toks,
                cfg_=c32)
    free_err = [_over_gate(a, b) for a, b in zip(card, free)]
    held_err = [_over_gate(a, b) for a, b in zip(card, held)]
    free_ok = max(o for _, o in free_err) <= 1
    held_worst = max(o for _, o in held_err + layer_err)
    if not free_ok and held_worst > 1:
        raise AssertionError(f"families (b) {arch}: from the card's state a "
                             f"layer or the logits are {held_worst} of the "
                             f"gate")
    agree = [_gated_agreement(torch, a.cpu(), b, f"families (b) {arch}")
             for a, b in zip(card, held)]
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    return {"arch": arch, "request": dict(c, frames=c["frames"]
                                          if cfg.enc_dec else 0),
            "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}",
            "gated": "free-running" if free_ok else
                     "each layer and step from the card's state",
            "free_running_max_abs_err": [e for e, _ in free_err],
            "free_running_of_gate": [o for _, o in free_err],
            "from_card_logits_max_abs_err": [e for e, _ in held_err],
            "from_card_logits_of_gate": [o for _, o in held_err],
            "from_card_layers_max_abs_err": max(e for e, _ in layer_err),
            "from_card_layers_of_gate": max(o for _, o in layer_err),
            "layers_checked": len(layer_err),
            "greedy_agree": sum(a[0] for a in agree),
            "greedy_total": sum(a[1] for a in agree),
            "greedy_gated": sum(a[2] for a in agree),
            "card_vs_f32": [float((a.float().cpu() - b).abs().max())
                            for a, b in zip(card, truth)],
            "cpu_vs_f32": [float((a.float() - b).abs().max())
                           for a, b in zip(free, truth)],
            "card_s": card_s, "cpu_free_running_s": cpu_s}


def llava_layers_card_vs_cpu(np, torch, dev) -> dict:
    """(b) llava layer by layer from the card's state: the inputs and
    outputs of layers LLAVA_LAYERS in prefill (2,880 image + 32 text
    positions) and in 8 decode steps on the card; each of those layers on
    the CPU from the card's input, its weights alone copied to the host,
    its K/V cache its own; within the serve gates."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    from repro_torch.models.layers import rope_angles

    arch = "llava-next-mistral-7b"
    cfg = get_config(arch)
    c = FAMILY_CHECK
    b, n_txt, n_steps = 1, c["prompt"], c["steps"]
    p_dev = lm.init_params(cfg, seed=1, device=dev, draw="device")
    host = _host_batch(cfg, 1, n_txt + n_steps, b)
    batch = {k: (v[:, :n_txt] if k == "tokens" else v).to(dev)
             for k, v in host.items()}
    want = set(LLAVA_LAYERS) | {i - 1 for i in LLAVA_LAYERS if i}
    seen: dict = {}

    def record(i, x):
        if i in want:
            seen.setdefault(i, []).append(x.cpu())
        return x
    first_in = []
    with torch.no_grad():
        first_in.append(lm._embed_inputs(p_dev, cfg, batch)[0].cpu())
        logits, cache = lm.prefill(p_dev, cfg, batch,
                                   max_len=cfg.n_image_tokens + n_txt +
                                   n_steps, tap=record)
        s = cache["len"]
        for t in range(n_steps):
            nxt = logits.argmax(-1)
            first_in.append(lm._embed(p_dev, nxt)[:, None].cpu())
            logits, cache = lm.decode_step(p_dev, cfg, nxt, cache,
                                           tap=record)
    del cache
    rows, worst = {}, 0.0
    for i in LLAVA_LAYERS:
        p_i = {part: {k: v.cpu() for k, v in sub.items()}
               for part, sub in lm._layer_params(p_dev, i).items()}
        ins = first_in if i == 0 else seen[i - 1]
        outs = seen[i]
        t0 = time.perf_counter()
        with torch.no_grad():
            x, _, st = lm._block_fwd(p_i, ins[0], cfg,
                                     positions=torch.arange(s))
            errs = [_over_gate(x, outs[0])]
            one = {"len": s, "k": torch.zeros((1, b, s + n_steps,
                                               cfg.n_kv_heads, cfg.head_dim),
                                              dtype=x.dtype)}
            one["v"] = torch.zeros_like(one["k"])
            one["k"][0, :, :s], one["v"][0, :, :s] = st["k"], st["v"]
            for t in range(n_steps):
                rope = rope_angles(torch.full((b, 1), s + t), cfg.head_dim,
                                   cfg.rope_theta)
                y = lm._decode_layer(p_i, ins[t + 1], cfg, one, 0, s + t,
                                     rope, False)
                errs.append(_over_gate(y, outs[t + 1]))
        rows[i] = {"max_abs_err": [e for e, _ in errs],
                   "of_gate": [o for _, o in errs],
                   "cpu_s": time.perf_counter() - t0}
        worst = max(worst, max(o for _, o in errs))
    del p_dev
    torch.cuda.empty_cache()
    if worst > 1:
        raise AssertionError(f"families (b) llava: a layer from the card's "
                             f"state is {worst} of the gate")
    return {"arch": arch, "positions": s, "steps": n_steps, "batch": b,
            "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}", "layers": rows}


def llava_ring(np, torch, dev) -> dict:
    """(c) llava, batch 1: a prefill of exactly one window (2,880 image +
    1,216 text positions), then 16 decode steps with ``lm.RING_CACHE`` on,
    on a cache grown to 4,112 slots (the grown route: the ring needs
    exactly ``window`` slots) and on a ring of 4,096 slots, the ring fed
    the grown run's greedy tokens.  Held from the grown run's state
    (each layer's input through the ``tap`` seam, so both caches take the
    same K/V): every layer and step within the serve gates (the logits
    then come from the grown run's last layer by construction, so they
    are not compared), each ring slot bitwise the grown cache's entry for
    its position, and each layer's ring attention in f32 within 1e-5 of
    the grown read (the same keys summed in ring order).  Free-running,
    the ring's greedy tokens equal the grown run's wherever the top-2
    margin exceeds the gap; its logit gaps are printed.  Then the window
    active: ``serve.generate`` over 2,880 image + 2,048 text positions,
    B9 once per layer at (e)'s (1, 4,928) row."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import lm

    cfg = get_config("llava-next-mistral-7b")
    w, n_txt, n_steps = cfg.window, RING["text"], RING["steps"]
    p = lm.init_params(cfg, seed=2, device=dev, draw="device")
    host = _host_batch(cfg, 2, n_txt, 1)
    batch = {k: v.to(dev) for k, v in host.items()}
    if cfg.n_image_tokens + n_txt != w:
        raise AssertionError("families (c): the prefill is not one window")
    layers, toks = [], []

    def record(i, x):
        layers.append(x)
        return x
    queue, layer_err = None, []

    def from_grown(i, x):
        want = next(queue)
        layer_err.append(_over_gate(x, want))
        return want
    lm.RING_CACHE = True
    try:
        with torch.no_grad():
            logits, grown = lm.prefill(p, cfg, batch, max_len=w + n_steps)
            ring = {"len": w, "k": grown["k"][:, :, :w].clone(),
                    "v": grown["v"][:, :, :w].clone()}
            free = {"len": w, "k": ring["k"].clone(),
                    "v": ring["v"].clone()}
            first = logits
            g_logits = []
            for _ in range(n_steps):
                toks.append(logits.argmax(-1))
                logits, grown = lm.decode_step(p, cfg, toks[-1], grown,
                                               tap=record)
                g_logits.append(logits)
            queue = iter(layers)
            free_logits = []
            for t in range(n_steps):
                _, ring = lm.decode_step(p, cfg, toks[t], ring,
                                         tap=from_grown)
                lf, free = lm.decode_step(p, cfg, toks[t], free)
                free_logits.append(lf)
            # slot j of the ring holds position n − ((n % W − j) mod W)
            n = w + n_steps - 1
            pos = n - torch.remainder(n % w - torch.arange(w), w)
            slots_same = all(
                torch.equal(ring[k], grown[k][:, :, pos.to(dev)])
                for k in ("k", "v"))
            q = torch.randn((1, 1, cfg.n_heads, cfg.head_dim),
                            generator=torch.Generator(device=dev)
                            .manual_seed(3), device=dev)
            f32_err = max(float((attn_mod.decode_attend_ring(
                q, ring["k"][i].float(), ring["v"][i].float(), n, window=w)
                - attn_mod.decode_attend(
                    q, grown["k"][i].float(), grown["v"][i].float(), n + 1,
                    window=w)).abs().max()) for i in range(cfg.n_layers))
    finally:
        lm.RING_CACHE = False
    free_err = [_over_gate(a, b) for a, b in zip(free_logits, g_logits)]
    agree = [_gated_agreement(torch, a, b, "families (c)")
             for a, b in zip(g_logits, free_logits)]
    del grown, ring, free, layers
    worst = max(o for _, o in layer_err)
    if worst > 1 or not slots_same or f32_err > 1e-5:
        raise AssertionError(f"families (c): from the grown run's state "
                             f"{worst} of the gate, slots bitwise "
                             f"{slots_same}, f32 attention {f32_err}")
    # the window active: the prefill is longer than the window
    n_past = cfg.n_image_tokens + RING["past_text"]
    if n_past != FAMILY_WA_SHAPES[1][1] or n_past <= w:
        raise AssertionError("families (c): the long prefill is not (e)'s "
                             "window row")
    tokens, inputs = serve.prompt_inputs(cfg, 1, RING["past_text"], 4, dev)
    ops.reset_launches()
    with torch.no_grad():
        past, _ = serve.generate(p, cfg, tokens, gen=RING["past_gen"],
                                 inputs=inputs)
    past_launches = ops.launches()
    del p, inputs
    torch.cuda.empty_cache()
    if past_launches["window_attention"] != cfg.n_layers or any(
            n for k, n in past_launches.items() if k != "window_attention") \
            or past.min() < 0 or past.max() >= cfg.padded_vocab:
        raise AssertionError(f"families (c) past the window: launches "
                             f"{past_launches}, tokens {past.tolist()}")
    return {"prefill_positions": w, "steps": n_steps, "ring_slots": w,
            "grown_slots": w + n_steps, "first_logits_finite":
            bool(torch.isfinite(first).all()),
            "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}, each layer and step "
                     "from the grown run's state; f32 attention <= 1e-5; "
                     "free-running greedy where the margin exceeds the gap",
            "layers_max_abs_err": max(e for e, _ in layer_err),
            "layers_of_gate": max(o for _, o in layer_err),
            "layers_checked": len(layer_err),
            "ring_slots_bitwise": slots_same,
            "f32_attention_max_abs_err": f32_err,
            "free_running_max_abs_err": [e for e, _ in free_err],
            "free_running_of_gate": [o for _, o in free_err],
            "greedy_agree": sum(a[0] for a in agree),
            "greedy_total": sum(a[1] for a in agree),
            "greedy_gated": sum(a[2] for a in agree),
            "past_window": {"prefill_positions": n_past, "window": w,
                            "gen": RING["past_gen"],
                            "launches": past_launches["window_attention"],
                            "tokens": past[0].tolist()}}


def hymba_padded(np, torch, dev) -> dict:
    """(d) hymba padded to (48, 6) heads by ``embed_params_padded``:
    prefill logits against the unpadded model's on (a)'s request, B9 at
    48/6 once per layer."""
    from repro_torch.configs.base import pad_heads
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    cfg = get_config("hymba-1.5b")
    cfg_p = pad_heads(cfg)
    p = lm.init_params(cfg, seed=0, device=dev, draw="device")
    p_pad = lm.embed_params_padded(p, cfg, cfg_p)
    tokens, _ = serve.prompt_inputs(cfg, FAMILY_SERVE["batch"],
                                    FAMILY_SERVE["prompt"], 0, dev)
    out = {}
    with torch.no_grad():
        for name, c_, pp in (("unpadded", cfg, p), ("padded", cfg_p, p_pad)):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[name], _ = lm.prefill(pp, c_, {"tokens": tokens})
            torch.cuda.synchronize()
            out[name + "_ms"] = (time.perf_counter() - t0) * 1e3
            out[name + "_launches"] = ops.launches()["window_attention"]
    err, of = _over_gate(out["padded"], out["unpadded"])
    del p, p_pad
    torch.cuda.empty_cache()
    if of > 1 or out["padded_launches"] != cfg.n_layers:
        raise AssertionError(f"families (d): {err} ({of} of the gate), "
                             f"{out['padded_launches']} launches")
    return {"heads": [cfg.n_heads, cfg.n_kv_heads],
            "padded_heads": [cfg_p.n_heads, cfg_p.n_kv_heads],
            "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}", "max_abs_err": err,
            "of_gate": of, "launches": out["padded_launches"],
            "prefill_ms": {"unpadded": out["unpadded_ms"],
                           "padded": out["padded_ms"]}}


def family_train(np, torch, dev) -> dict:
    """(f) one remat value-and-grad of ``train_loss`` at full width (4 × 64
    tokens) for mamba2 and hymba: finite, and bit for bit again; then the
    reduced f32 config of every family card vs CPU from the same weights
    and batch: loss within 1e-5 relative, the gradient's norm of
    difference within 1e-4 relative."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import steps
    from repro_torch.models import lm
    from repro_torch.utils.tree import global_norm

    b, s = FAMILY_TRAIN["batch"]
    out = {"batch": [b, s]}
    for arch in FAMILY_TRAIN["archs"]:
        cfg = get_config(arch)
        p = lm.init_params(cfg, seed=0, device=dev, draw="device")
        host = _host_batch(cfg, 12, s + 1, b)
        tk = host["tokens"].to(dev)
        batch = {"tokens": tk[:, :-1], "labels": tk[:, 1:]}

        def loss_fn(pp, bb):
            return lm.train_loss(pp, cfg, bb)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        l1, g1 = steps.value_and_grad(loss_fn, p, batch)
        torch.cuda.synchronize()
        grad_s = time.perf_counter() - t0
        l2, g2 = steps.value_and_grad(loss_fn, p, batch)
        finite = bool(torch.isfinite(l1)) and all(
            bool(torch.isfinite(g.float()).all()) for g in g1.values())
        same = torch.equal(l1, l2) and all(torch.equal(g1[k], g2[k])
                                           for k in g1)
        launched = {k: v for k, v in ops.launches().items() if v}
        out[arch] = {"loss": float(l1), "value_and_grad_s": grad_s,
                     "n_params": sum(v.numel() for v in p.values()),
                     "finite": finite, "repeat_bitwise": same,
                     "launches": launched}
        del p, g1, g2
        torch.cuda.empty_cache()
        if not finite or not same or launched:
            raise AssertionError(f"families (f) {arch}: {out[arch]}")
    rows = {}
    for arch in FAMILY_SOURCES:
        cfg = dataclasses.replace(get_config(arch).reduced(),
                                  dtype="float32")
        p_cpu = lm.init_params(cfg, seed=0, device="cpu")
        p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
        host = _host_batch(cfg, 13, s + 1, b)
        batch = dict(host, tokens=host["tokens"][:, :-1],
                     labels=host["tokens"][:, 1:])

        def loss_fn(pp, bb):
            return lm.train_loss(pp, cfg, bb)
        l_cpu, g_cpu = steps.value_and_grad(loss_fn, p_cpu, batch)
        l_dev, g_dev = steps.value_and_grad(
            loss_fn, p_dev, {k: v.to(dev) for k, v in batch.items()})
        gap = {k: g_dev[k].cpu() - g_cpu[k] for k in g_cpu}
        rows[arch] = {"loss_rel_gap": abs(float(l_dev) - float(l_cpu)) /
                      abs(float(l_cpu)),
                      "grad_gap_rel": float(global_norm(gap)) /
                      float(global_norm(g_cpu))}
        if rows[arch]["loss_rel_gap"] > FAMILY_TRAIN["loss_rtol"] or \
                rows[arch]["grad_gap_rel"] > FAMILY_TRAIN["grad_rtol"]:
            raise AssertionError(f"families (f) reduced {arch}: "
                                 f"{rows[arch]}")
    out["reduced_card_vs_cpu"] = rows
    out["bounds"] = (f"reduced f32: loss rel <= {FAMILY_TRAIN['loss_rtol']}"
                     f", |g_card - g_cpu| / |g_cpu| <= "
                     f"{FAMILY_TRAIN['grad_rtol']}")
    return out


def families_run(np, torch, dev) -> tuple[dict, dict]:
    """Phase 16 (see the module docstring), one JSON line a part.  Returns
    (the phase's summary, (e)'s kernel rows by FAMILY_WA_ROWS name, each
    with the B9 launches of the run that prefills at its shape)."""
    t_phase = time.perf_counter()
    card = smi_line()
    parts, served = {}, {}
    for arch in FAMILY_SOURCES:
        t0 = time.perf_counter()
        served[arch] = family_serve(np, torch, dev, arch)
        emit({"phase": "families", "part": "a", "card": card,
              "a": served[arch], "seconds": time.perf_counter() - t0})
    parts["a"] = sum(r["main_s"] for r in served.values())
    t0 = time.perf_counter()
    for arch in ("mamba2-780m", "hymba-1.5b", "seamless-m4t-large-v2"):
        t1 = time.perf_counter()
        emit({"phase": "families", "part": "b", "card": card,
              "b": family_card_vs_cpu(np, torch, dev, arch),
              "seconds": time.perf_counter() - t1})
    t1 = time.perf_counter()
    emit({"phase": "families", "part": "b", "card": card,
          "b": llava_layers_card_vs_cpu(np, torch, dev),
          "seconds": time.perf_counter() - t1})
    parts["b"] = time.perf_counter() - t0
    done = {}
    for part, fn in (("c", llava_ring), ("d", hymba_padded)):
        t0 = time.perf_counter()
        done[part] = fn(np, torch, dev)
        parts[part] = time.perf_counter() - t0
        emit({"phase": "families", "part": part, "card": card,
              part: done[part], "seconds": parts[part]})
    t0 = time.perf_counter()
    wa = attention_kernel_checks(np, torch, dev, FAMILY_WA_SHAPES)
    parts["e"] = time.perf_counter() - t0
    emit({"phase": "kernels", "families": True, "card": card,
          "seconds": parts["e"], "rows": wa})
    run_of = {"llava_prefill": served["llava-next-mistral-7b"]["launches"],
              "llava_window": done["c"]["past_window"]["launches"],
              "hymba": served["hymba-1.5b"]["launches"],
              "hymba_padded": done["d"]["launches"],
              "seamless": served["seamless-m4t-large-v2"]["launches"]}
    rows = {}
    for name, row in zip(FAMILY_WA_ROWS, wa.values()):
        rows[name] = dict(row, launches=run_of[name.split("/")[0]])
    t0 = time.perf_counter()
    emit({"phase": "families", "part": "f", "card": card,
          "f": family_train(np, torch, dev)})
    parts["f"] = time.perf_counter() - t0
    return {"phase": "families", "card": card, "seconds_per_part": parts,
            "b9_launches_per_prefill": {a: r["launches"]
                                        for a, r in served.items()},
            "seconds": time.perf_counter() - t_phase}, rows



# ------------------------------------------------------------ phase 17
# (a) the dry-run matrix: 10 archs x 4 shapes x {pod1, pod2}, and (b) the
# variants, each in a process of its own (the card's memory its own, the
# earlier phases' cache released first) with expandable segments: every
# block split to its size, so (a)'s allocation is exact and (b)'s large
# steps do not fail on a fragmented cache
DRYRUN_TIMEOUT_S = 600
DRYRUN_ENV = {"PYTORCH_CUDA_ALLOC_CONF": "expandable_segments:True"}
# (b) the variants at full width: smollm-135m in f32, 30 layers, S = 4,096.
# Each variant runs at the first batch of its list that fits the card,
# against the baseline at that batch.  Where the baseline runs out of
# memory (its dense (B, 9, S, S) f32 score
# buffers) minremat stands in for it at that batch: the port's remat
# changes no bit, which is held first (minremat bitwise the baseline at
# 8).  micro16_minremat and the remat2_micro16 pair need 16; no_remat
# saves every layer's score buffers and is tried at 2, then 1.
VARIANT_ARCH, VARIANT_SEQ = "smollm-135m", 4096
# name -> (batches to try, its tolerance's kind)
VARIANT_RUNS = {
    "minremat": ((8,), "remat_bitwise"),
    "dense_max_2k": ((8,), "cpu"),
    "chunked_attn": ((8,), "cpu"),
    "kv_chunk_2k": ((8,), "cpu"),
    "loss_chunk_128": ((8,), "cpu"),
    "loss_chunk_1k": ((8,), "cpu"),
    "bf16_scores": ((8,), "cpu"),
    "chunked_attn_minremat": ((8,), "cpu"),
    "micro8": ((8,), "micro"),
    "micro8_minremat": ((8,), "micro"),
    "micro8_chunked_minremat": ((8,), "micro+cpu"),
    "remat2_micro8": ((8,), "micro"),
    "no_remat": ((2, 1), "remat"),
    "micro16_minremat": ((16,), "micro"),
    "remat2_micro16": ((16,), "micro"),
    "remat2_micro16_gradbf16": ((16,), "micro+bf16acc"),
}
# the reference's own tolerances (tests/test_variants.py): remat, the loss
# within rel 1e-5 and the gradients within atol 1e-4 (:62); microbatches,
# the loss within rel 1e-4 and the parameters after an SGD step within
# atol 3e-3 (:91), held here on the gradients (the step at lr 1)
REMAT_TOL = {"loss_rel": 1e-5, "grad_abs": 1e-4}
MICRO_TOL = {"loss_rel": 1e-4, "grad_abs": 3e-3}
# the attention, loss-chunk and bf16 variants: the same comparison's gap
# on the CPU at 2 layers, batch 1 x 4,096 (``python3 chip_smoke.py
# --variant-bounds``, stated before the card's run; |loss gap| and the
# largest |gradient gap|), each at least one f32 ulp of what it compares
# (the loss near 10.8: 9.5e-7; a gradient recovered as p − (p − g) next to
# a norm weight of 1: 1.2e-7), scaled to the card's 30 layers by depth
# (round-off adds up layer by layer), times 4
VARIANT_CPU_GAPS = {
    "dense_max_2k": {"loss": 0.0, "grad": 1.1920928955078125e-07},
    "chunked_attn": {"loss": 0.0, "grad": 1.1920928955078125e-07},
    "kv_chunk_2k": {"loss": 0.0, "grad": 0.0},
    "loss_chunk_128": {"loss": 0.0, "grad": 7.450580596923828e-09},
    "loss_chunk_1k": {"loss": 0.0, "grad": 7.450580596923828e-09},
    "bf16_scores": {"loss": 0.0001010894775390625,
                    "grad": 7.466005627065897e-05},
    "chunked_attn_minremat": {"loss": 0.0,
                              "grad": 1.1920928955078125e-07}}
VARIANT_ULP = {"loss": 2.0 ** -20, "grad": 2.0 ** -23}
VARIANT_CPU_LAYERS = 2
# a bf16 gradient accumulator: each of the 16 additions rounds the running
# sum to bf16 (half an ulp, 2^-9 of it); the mean's gap stays within
# 2^-4 of the largest gradient
BF16_ACC_REL = 2.0 ** -4


def variant_bound(kind: str, name: str, g_max: float, layers: int) -> dict:
    """The stated bound of a variant: {"loss_rel"/"loss_abs", "grad_abs"}."""
    tol = {"loss_abs": 0.0, "loss_rel": 0.0, "grad_abs": 0.0}
    for part in kind.split("+"):
        if part in ("remat", "remat_bitwise"):
            new = dict(REMAT_TOL)
        elif part == "micro":
            new = dict(MICRO_TOL)
        elif part == "bf16acc":
            new = {"grad_abs": BF16_ACC_REL * g_max}
        else:                         # 4x the CPU gap of its route
            gap = VARIANT_CPU_GAPS[name if name in VARIANT_CPU_GAPS
                                   else "chunked_attn"]
            depth = layers / VARIANT_CPU_LAYERS
            new = {f"{k}_abs": 4 * depth * max(gap[k], VARIANT_ULP[k])
                   for k in ("loss", "grad")}
        for k, v in new.items():
            tol[k] = max(tol[k], v)
    return tol


def variant_step(torch, cfg, params, batch, name: str) -> tuple:
    """One ``train_step`` under variant ``name`` with SGD at lr 1: (loss,
    gradients as params − new params, ms by CUDA events on the card)."""
    from repro_torch.launch import steps, variants
    from repro_torch.optim.optimizers import sgd
    cuda = batch["tokens"].is_cuda
    with variants.apply_variant(name):
        step, opt = steps.make_train_step(cfg, sgd())
        if cuda:
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        new, _, loss = step(params, opt.init(params), batch, 1.0)
        ms = None
        if cuda:
            end.record()
            end.synchronize()
            ms = start.elapsed_time(end)
    grads = {k: params[k] - new[k] for k in params}
    return float(loss), grads, ms


def variant_gap(base, other) -> dict:
    (l0, g0), (l1, g1) = base[:2], other[:2]
    return {"loss": abs(l1 - l0),
            "grad": max(float((g1[k] - g0[k]).abs().max()) for k in g0),
            "grad_max": max(float(g.abs().max()) for g in g0.values())}


def variant_batch(torch, cfg, b: int, dev) -> dict:
    g = torch.Generator().manual_seed(17)
    tk = torch.randint(0, cfg.vocab_size, (b, VARIANT_SEQ + 1), generator=g)
    return {"tokens": tk[:, :-1].to(dev), "labels": tk[:, 1:].to(dev)}


def variant_cpu_gaps(np, torch) -> dict:
    """The CPU's gaps that set the attention, loss-chunk and bf16 variants'
    bounds: smollm-135m at full width in f32, 2 layers, batch 1 x 4,096."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(VARIANT_ARCH), dtype="float32",
                              n_layers=VARIANT_CPU_LAYERS)
    params = lm.init_params(cfg, seed=0, device="cpu")
    batch = variant_batch(torch, cfg, 1, "cpu")
    base = variant_step(torch, cfg, params, batch, "baseline")
    return {name: variant_gap(base, variant_step(torch, cfg, params, batch,
                                                 name))
            for name, (_, kind) in VARIANT_RUNS.items() if kind == "cpu"}


def _own_process(torch, argv: list, what: str) -> tuple[str, float]:
    """``python argv`` with DRYRUN_ENV and the repository's ``src``, after
    this process's cached blocks are released; (its stdout, seconds)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = {**os.environ, **DRYRUN_ENV,
           "PYTHONPATH": str(ROOT / "src") + os.pathsep +
           os.environ.get("PYTHONPATH", "")}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *argv], env=env,
                          capture_output=True, text=True,
                          timeout=DRYRUN_TIMEOUT_S)
    seconds = time.perf_counter() - t0
    (OUT / f"dryrun_{what}.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun ({what}): exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return proc.stdout, seconds


def dryrun_matrix(torch) -> dict:
    """(a) The 80 pairs through the dry-run's CLI in one process (pod1,
    then pod2: the traces shared), on the card; every record ok, and on
    each pair that fits, the allocation equal to the plan."""
    from repro_torch.configs.base import INPUT_SHAPES
    from repro_torch.configs.registry import list_archs
    out_dir = OUT / "dryrun"
    code = ("import sys; from pathlib import Path; "
            "from repro_torch.launch import dryrun; "
            "dryrun.RESULTS_DIR = Path(sys.argv[1]); "
            "a = ['--all', '--device', 'cuda', '--force']; "
            "sys.exit(dryrun.main(a) | dryrun.main(a + ['--multi-pod']))")
    _, seconds = _own_process(torch, ["-c", code, str(out_dir)], "a")
    rows, n_fit = {}, 0
    for mesh in ("pod1", "pod2"):
        for arch in list_archs():
            for shape in INPUT_SHAPES:
                key = f"{arch}__{shape}__{mesh}"
                rec = json.loads((out_dir / f"{key}.json").read_text())
                alloc = rec.get("alloc", {})
                if not rec["ok"] or not alloc:
                    raise AssertionError(f"dryrun (a) {key}: "
                                         f"{rec.get('error')}")
                if rec["fits_one_h100"]:
                    n_fit += 1
                    if alloc["allocated_growth_bytes"] != \
                            alloc["plan_block_bytes"] or \
                            alloc["requested_growth_bytes"] != \
                            rec["mem"]["argument_size_in_bytes"]:
                        raise AssertionError(f"dryrun (a) {key}: allocated "
                                             f"{alloc}, the plan "
                                             f"{rec['mem']}")
                rows[key] = {
                    "args_gb_per_device":
                        rec["mem"]["argument_size_in_bytes"] / 1e9,
                    "fits_one_h100": rec["fits_one_h100"],
                    "flops_per_device": rec["flops_per_device"],
                    "useful_flop_ratio": rec["useful_flop_ratio"],
                    "dominant": rec["dominant"],
                    "trace_s": rec["trace_s"], "seconds": rec["total_s"]}
    return {"pairs": len(rows), "fit_one_h100": n_fit,
            "cli_seconds": seconds, "rows": rows}


def dryrun_variants(np, torch, dev) -> dict:
    """(b) One train step of smollm-135m at full width in f32 under the
    baseline and each variant of VARIANT_RUNS, loss and gradients held to
    each variant's stated bound; each step's ms and peak memory beside its
    reference's."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config(VARIANT_ARCH), dtype="float32")
    params = lm.init_params(cfg, seed=0, device=dev, draw="device")

    def run(name, b):
        """(loss, grads, ms, peak GB) or None where it does not fit."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            res = variant_step(torch, cfg, params,
                               variant_batch(torch, cfg, b, dev), name)
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            return None
        return res + (torch.cuda.max_memory_allocated() / 1e9,)
    refs, ref_rows = {}, {}

    def ref(b):
        """The baseline at batch b, or minremat where it does not fit."""
        if b not in refs:
            for name in ("baseline", "minremat"):
                res = run(name, b)
                ref_rows[f"{name}@{b}"] = "out of memory" if res is None \
                    else {"ms": res[2], "peak_gb": res[3]}
                if res is not None:
                    break
            refs[b] = (name, res)
        return refs[b]
    ref(1)                            # the process's first step: warms up
    ref(8)
    rows = {}
    for name, (batches, kind) in VARIANT_RUNS.items():
        res, tried = None, []
        for b in batches:
            res = run(name, b)
            if res is not None:
                break
            tried.append(b)
        ref_name, base = ref(b) if res is not None else (None, None)
        if res is None or base is None:
            raise AssertionError(f"dryrun (b) {name}: does not fit at "
                                 f"{batches} x {VARIANT_SEQ} ({ref_name})")
        gap = variant_gap(base, res)
        tol = variant_bound(kind, name, gap["grad_max"], cfg.n_layers)
        loss_tol = max(tol["loss_abs"], tol["loss_rel"] * abs(base[0]))
        rows[name] = {"batch": [b, VARIANT_SEQ], "out_of_memory_at": tried,
                      "held_against": f"{ref_name}@{b}",
                      "loss": res[0], "loss_gap": gap["loss"],
                      "loss_bound": loss_tol, "grad_gap": gap["grad"],
                      "grad_bound": tol["grad_abs"], "ms": res[2],
                      "ref_ms": base[2], "peak_gb": res[3]}
        if kind == "remat_bitwise" and (gap["loss"] or gap["grad"]):
            raise AssertionError(f"dryrun (b) {name}: not bitwise the "
                                 f"baseline: {rows[name]}")
        if gap["loss"] > loss_tol or gap["grad"] > tol["grad_abs"]:
            raise AssertionError(f"dryrun (b) {name}: beyond its bound: "
                                 f"{rows[name]}")
        del res
    del params, refs
    torch.cuda.empty_cache()
    return {"arch": VARIANT_ARCH, "dtype": "float32",
            "layers": cfg.n_layers, "refs": ref_rows, "rows": rows}


def dryrun_moe_grouped(np, torch, dev) -> dict:
    """(c) granite-moe-1b-a400m's prefill under moe_grouped on the pod1
    context (dp 16: 16 dispatch groups of 32 tokens at 8 x 64): full width
    on the card, logits finite, 24 B9 launches; then in f32 at 2 layers,
    card vs CPU from the card's state with the card's expert choices
    forced, the CPU's own choice held wherever its margin exceeds twice
    the probabilities' gap."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_production_mesh, make_shard_ctx
    from repro_torch.launch.variants import apply_variant
    from repro_torch.models import ffn, lm
    from repro_torch.sharding.ctx import use_sharding

    cfg = get_config(MOE_ARCH)
    ctx = make_shard_ctx(make_production_mesh())
    b, s = FAMILY_SERVE["batch"], FAMILY_SERVE["prompt"]
    toks = torch.as_tensor(np.random.default_rng(25).integers(
        0, cfg.vocab_size, (b, s)))
    real_top_k = ffn._top_k
    groups = []

    def counted(probs, k):
        groups.append(probs.shape[0])
        return real_top_k(probs, k)
    out = {"arch": MOE_ARCH, "batch": [b, s], "dp": ctx.dp_size}
    params = lm.init_params(cfg, seed=0, device=dev, draw="device")
    ops.reset_launches()
    ffn._top_k = counted
    try:
        with use_sharding(ctx), apply_variant("moe_grouped"), \
                torch.no_grad():
            logits, _ = lm.prefill(params, cfg, {"tokens": toks.to(dev)})
            torch.cuda.synchronize()
    finally:
        ffn._top_k = real_top_k
    launched = ops.launches()
    out.update(b9_launches=launched["window_attention"],
               groups_per_layer=sorted(set(groups)),
               logits_finite=bool(torch.isfinite(logits).all()))
    if launched["window_attention"] != cfg.n_layers or \
            any(v for k, v in launched.items() if k != "window_attention"):
        raise AssertionError(f"dryrun (c): launches {launched}")
    if out["groups_per_layer"] != [ctx.dp_size] or \
            not out["logits_finite"]:
        raise AssertionError(f"dryrun (c): {out}")
    del params, logits
    torch.cuda.empty_cache()
    # f32 at 2 layers: card vs CPU from the card's state
    c32 = dataclasses.replace(cfg, dtype="float32", n_layers=2)
    p_cpu = lm.init_params(c32, seed=0, device="cpu")
    p_dev = {k: v.to(dev) for k, v in p_cpu.items()}
    calls, layers = [], []

    def recorded(probs, k):
        vals, idx = real_top_k(probs, k)
        calls.append((idx.cpu(), probs.detach().float().cpu()))
        return vals, idx

    def record(i, x):
        layers.append(x.cpu())
        return x
    route = {"tokens": 0, "flips": 0, "gated_flips": 0}
    queue, layer_q, layer_err = iter(calls), iter(layers), []

    def forced(probs, k):
        idx, p_card = next(queue)
        _, own = real_top_k(probs, k)
        top = torch.sort(probs.float(), dim=-1, descending=True).values
        margin = top[..., k - 1] - top[..., k]
        gap = (probs.float() - p_card).abs().amax(-1)
        flip = (torch.sort(own, -1).values !=
                torch.sort(idx, -1).values).any(-1)
        route["tokens"] += flip.numel()
        route["flips"] += int(flip.sum())
        route["gated_flips"] += int((flip & (margin > 2 * gap)).sum())
        return probs.gather(-1, idx), idx

    def from_card(i, x):
        want = layers[i]
        layer_err.append(_over_gate(x, want))
        return want.to(x.dtype)
    with use_sharding(ctx), apply_variant("moe_grouped"), torch.no_grad():
        ffn._top_k = recorded
        try:
            card, _ = lm.prefill(p_dev, c32, {"tokens": toks.to(dev)},
                                 tap=record)
            ffn._top_k = forced
            cpu, _ = lm.prefill(p_cpu, c32, {"tokens": toks},
                                tap=from_card)
        finally:
            ffn._top_k = real_top_k
    logit_err = _over_gate(card, cpu)
    out["f32_2_layers"] = {
        "bound": f"atol {LM_ATOL}, rtol {LM_RTOL}, each layer and the "
                 "logits on the CPU from the card's state, the card's "
                 "expert choices forced",
        "layers_max_abs_err": max(e for e, _ in layer_err),
        "layers_of_gate": max(o for _, o in layer_err),
        "logits_max_abs_err": logit_err[0],
        "logits_of_gate": logit_err[1], "routing": route}
    if route["gated_flips"] or max(o for _, o in layer_err) > 1 or \
            logit_err[1] > 1:
        raise AssertionError(f"dryrun (c): card vs CPU {out}")
    del p_dev
    torch.cuda.empty_cache()
    return out


def dryrun_run(np, torch, dev, pod1: dict) -> dict:
    """Phase 17 (see the module docstring), one JSON line a part."""
    from repro_torch.launch import fedsim
    t_phase = time.perf_counter()
    card = smi_line()
    parts = {}
    t0 = time.perf_counter()
    a = dryrun_matrix(torch)
    parts["a"] = time.perf_counter() - t0
    emit({"phase": "dryrun", "part": "a", "card": card, "a": a,
          "seconds": parts["a"]})
    t0 = time.perf_counter()
    out, _ = _own_process(torch, [str(ROOT / "chip_smoke.py"), "--variants"],
                          "b")
    parts["b"] = time.perf_counter() - t0
    emit({"phase": "dryrun", "part": "b", "card": card,
          "b": json.loads(out.strip().splitlines()[-1]),
          "seconds": parts["b"]})
    t0 = time.perf_counter()
    c = dryrun_moe_grouped(np, torch, dev)
    parts["c"] = time.perf_counter() - t0
    emit({"phase": "dryrun", "part": "c", "card": card, "c": c,
          "seconds": parts["c"]})
    t0 = time.perf_counter()
    rec = fedsim.run(FEDSIM["clients"], multi_pod=True,
                     aggregator=FEDSIM["aggregator"], force=True)
    d = fedsim_gates(rec, dev)
    if rec["mesh"] != "pod2" or rec["dp"] != 32:
        raise AssertionError(f"dryrun (d): {rec['mesh']}, dp {rec['dp']}")
    parts["d"] = time.perf_counter() - t0
    emit({"phase": "dryrun", "part": "d", "card": card,
          "d": {"pod2": d, "pod1": pod1}, "seconds": parts["d"]})
    return {"phase": "dryrun", "card": card, "seconds_per_part": parts,
            "pairs": a["pairs"], "fit_one_h100": a["fit_one_h100"],
            "seconds": time.perf_counter() - t_phase}

def main() -> int:
    import torch
    if sys.argv[1:] == ["--variant-bounds"]:
        # phase 17 (b)'s CPU gaps (VARIANT_CPU_GAPS): the CPU only
        sys.path.insert(0, str(ROOT / "src"))
        import numpy as np
        torch.set_num_threads(min(8, os.cpu_count() or 1))
        print(json.dumps(variant_cpu_gaps(np, torch)), flush=True)
        return 0
    if sys.argv[1:] == ["--variants"] and torch.cuda.is_available():
        # phase 17 (b) in a process of its own (dryrun_run starts it)
        sys.path.insert(0, str(ROOT / "src"))
        import numpy as np
        print(json.dumps(dryrun_variants(np, torch, torch.device("cuda"))),
              flush=True)
        return 0
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
    cells_rows = cells_kernel_checks(np, torch, dev)
    emit({"phase": "kernels", "cell_axis": True, "card": smi,
          "rows": cells_rows})
    staged_rows = {**staged_kernel_checks(np, torch, dev),
                   **swap_gain_checks(np, torch, dev)}
    emit({"phase": "kernels", "staged": True, "card": smi,
          "rows": staged_rows})
    emit({"phase": "graph_routes", "card": smi,
          "checks": graph_route_checks(np, torch, dev)})
    robust_rows = robust_kernel_checks(np, torch, dev)
    emit({"phase": "kernels", "robust": True, "card": smi,
          "rows": robust_rows})

    kept: dict = {}
    slice_sets: dict = {}
    info, launches = slice_run(np, torch, dev, kept, slice_sets)
    slice_launches = dict(launches)
    emit(info)
    info, robust_launches = robust_run(np, torch, dev, kept)
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
    info, scan_launches = scan_run(np, torch, dev, slice_launches)
    emit(info)
    emit(runtime_run(np, torch, dev, kept))
    emit(plans_run(np, torch, dev))
    fed1 = fedsim_run(np, torch, dev)
    emit(fed1)
    emit(mesh_run(np, torch, dev))
    emit(examples_run(np, torch, dev, slice_sets))
    t0 = time.perf_counter()
    attn_rows = attention_kernel_checks(np, torch, dev)
    emit({"phase": "kernels", "attention": True, "card": smi,
          "seconds": time.perf_counter() - t0, "rows": attn_rows})
    info, launches["window_attention"] = serve_run(np, torch, dev)
    emit(info)
    info, train_launches = train_run(np, torch, dev)
    emit(info)
    info, family_rows = families_run(np, torch, dev)
    emit(info)
    emit(dryrun_run(np, torch, dev, {k: fed1[k] for k in (
        "mesh", "dp", "m", "round", "server_pipeline", "aggregator")}))
    main_rows = {
        "pairwise_similarity": staged_rows[
            "pairwise_similarity/{}x{}".format(*STAGED_SHAPES[0])],
        "pairwise_similarity/vision": staged_rows[
            "pairwise_similarity/{}x{}".format(*STAGED_SHAPES[-1])],
        "adjacency": staged_rows["adjacency/{}x{}".format(*STAGED_SHAPES[0])],
        # the greedy step's call: A_t and S read in the kernel
        "greedy_argmax": per_n[MAIN_N]["greedy_argmax/taken"],
        "greedy_cells": cells_rows["greedy_cells/b={}/m={}/n={}".format(
            *CELLS_SHAPES[0])],
        "swap_cells": cells_rows["swap_cells/b={}/m={}/n={}".format(
            *CELLS_SHAPES[0])],
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
                        "replaces": replaces,
                        "launches": own_launches(launches, name),
                        "scan_launches": own_launches(scan_launches, name),
                        "train_launches": own_launches(train_launches, name),
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
    source, replaces = KERNEL_INFO["window_attention"]
    for name, row in family_rows.items():
        if row["dtype"] != "bfloat16":
            continue                  # the families' prefills run bf16
        kernels.append({"name": f"window_attention/{name}", "route": "cuda",
                        "source": source, "replaces": replaces,
                        "launches": row["launches"],
                        "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                        "plain_ms": row["plain_ms"],
                        "bound_ms": row["bound_ms"],
                        "bound_by": row["bound_by"],
                        "library_ms": row["library_ms"],
                        "device_ms": row["device_ms"],
                        "library_device_ms": row["library_device_ms"],
                        "plan": row["body"],
                        **{k: row[k] for k in ("shape", "dtype", "window")},
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
