"""Floyd–Warshall all-pairs shortest paths.

Replaces ``repro/kernels/floyd_warshall.py`` ``_fw_round_kernel`` /
``floyd_warshall_pallas`` with ``csrc/floyd_warshall.cu``, which runs the
plain version's per-pivot order ``h = min(h, h[:, k] + h[k, :])`` on every
cell, so the two agree bit for bit (and with the JAX reference given the
same R), on one of three plans (:func:`floyd_warshall_plan`; the
switches measured on an H100):

* ``single`` (N ≤ 64; forced, N ≤ 256): the whole matrix in one block's
  registers, row and column k passed through shared memory, one launch, a
  barrier per pivot;
* ``blocked32`` (N ≤ 2048) and ``blocked64``: pivots in blocks of T = 32
  or 64; per block one launch steps the pivot tile and the pivot row and
  column panels through the block's pivots and records each panel's row or
  column k as it stands at step k (a snapshot), and a second launch
  updates every other tile from those snapshots.  The TPU kernel's blocked
  rounds read the FINAL pivot panels instead, another order of operations
  (its own test holds it to 1e-4).

What bounds it on the card: the 2N³ min/add operations from N ≈ 100 on;
below, and in every panel launch, the barrier of each pivot step.

Precondition (as for every adjacency the 3DG builds): no negative entry,
no −0.0 and no NaN, so row and column k do not change at step k and the
in-place update is race-free.

:func:`floyd_warshall` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import I, P, Kernel, library, stream_of
from repro_torch.kernels.ref import floyd_warshall_ref

KERNEL = Kernel("floyd_warshall", "floyd_warshall_launch", [P, I, I, P, P])
PLANS = ("single", "blocked32", "blocked64")
SINGLE_MOST = 256          # the largest N the single plan takes
SNAP_TILE = 64             # the largest pivot block a blocked plan takes

floyd_warshall_plain = floyd_warshall_ref

_plans: dict[int, str] = {}


def floyd_warshall_heuristic(n: int) -> str:
    """The plan the C heuristic picks for n (``floyd_warshall_plan_kind``)."""
    fn = library("floyd_warshall").floyd_warshall_plan_kind
    fn.argtypes, fn.restype = [I], ctypes.c_int
    return PLANS[fn(n)]


def floyd_warshall_plan(n: int) -> str:
    """The plan floyd_warshall_cuda takes for an (n, n) matrix: the plan
    table's winner for n's tier where it takes n (``autotune.resolve``),
    else :func:`floyd_warshall_heuristic`'s, resolved once."""
    if n not in _plans:
        _plans[n] = autotune.resolve(
            "floyd_warshall", {"plan": floyd_warshall_heuristic(n)},
            takes=lambda q: autotune.fw_takes(q, n), n=n)["plan"]
    return _plans[n]


def floyd_warshall_cuda(h: torch.Tensor, *,
                        plan: str | None = None) -> torch.Tensor:
    """The CUDA kernel on a copy of ``h`` (N, N); returns the distances.
    ``plan`` forces one of :data:`PLANS` (``single`` takes N ≤ 256), to
    time them against each other; None takes :func:`floyd_warshall_plan`'s.
    One launch count per call, whatever the plan launches."""
    if not h.is_cuda or h.dim() != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"floyd_warshall_cuda takes a square CUDA matrix, "
                         f"got {tuple(h.shape)} on {h.device}")
    out = h.to(torch.float32, copy=True).contiguous()
    n = out.shape[0]
    if n == 0:
        return out
    plan = plan or floyd_warshall_plan(n)
    kind = PLANS.index(plan)
    if plan == "single" and n > SINGLE_MOST:
        raise ValueError(f"floyd_warshall_cuda: the single plan takes N <= "
                         f"{SINGLE_MOST}, got {n}")
    scratch = None if plan == "single" else torch.empty(
        2 * SNAP_TILE * n + SNAP_TILE * SNAP_TILE, dtype=torch.float32,
        device=out.device)
    with torch.cuda.device(out.device):
        KERNEL(out.data_ptr(), n, kind,
               None if scratch is None else scratch.data_ptr(),
               stream_of(out))
    return out


def floyd_warshall(h: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version."""
    if h.is_cuda:
        return floyd_warshall_cuda(h)
    if h.device.type != "cpu":
        raise ValueError(f"floyd_warshall: no kernel for {h.device}")
    return floyd_warshall_plain(h)
