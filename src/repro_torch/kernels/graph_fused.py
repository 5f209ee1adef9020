"""Fused 3DG adjacency: similarity -> min-max stats -> adjacency.

Replaces ``repro/kernels/graph_fused.py`` ``_fused_kernel`` /
``fused_adjacency_pallas`` with ``csrc/graph_fused.cu``.  The kernel
computes each product of V = U·Uᵀ once (the upper triangle's tiles,
mirrored, through the staged similarity's own tile kernels and plan) and
writes V straight into the R output, never into a buffer of its own; its
blocks fold lo/hi with order-preserving keys (exact: min and max are
associative) and meet in the 16-byte per-stream state that
``solver.grid_state`` keeps, whose last block writes [lo, hi] and re-zeroes
it, so no call needs a memset.  The epilogue then turns V into R in place:
for small N the last block does it itself (one launch), else a bytes-bound
launch of its own.  What bounds it on the card is the N(N+1)/2·d
multiply-adds of the product; the bytes are U in and R out.

Plans of the tile pass (:func:`fused_adjacency_plan`): ``small`` (the
quickstart's (30, 610): one thread per (entry, chunk) chain, many short
blocks), and the staged similarity's ``split``, ``serial`` and ``big``.

The plain version is the staged pipeline (``ref.similarity_ref`` ->
``graph_device.minmax01`` -> ``to_adjacency``), whose V every plan
reproduces bit for bit (the same chunked mul-then-add order), so lo/hi and
R's inf pattern match exactly; on the card R is bitwise the staged
kernels' R.  Unlike the TPU kernel there is no padding: Floyd–Warshall
takes any N, so R comes out at (N, N).

:func:`fused_adjacency` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import F, I, P, Kernel, library, stream_of
from repro_torch.kernels.solver import grid_state

KERNEL = Kernel("graph_fused", "fused_adjacency_launch",
                [P, I, I, I, F, F, I, I, P, P, P, P, P])
# the C plan kinds, in their order
PLANS = ("serial", "split", "big", "small")
# who turns V into R: a launch of its own, or the tile pass's last block
EPILOGUES = ("launch", "last_block")


def fused_adjacency_plain(u: torch.Tensor, *, eps: float, sigma2: float,
                          clamp: bool = False):
    """Plain version: returns (R (N, N), stats (2,) = [lo, hi])."""
    from repro_torch.core.graph_device import minmax01, to_adjacency
    from repro_torch.kernels.ref import similarity_ref
    v = similarity_ref(u)
    if clamp:
        v = torch.clamp_min(v, 0.0)
    r = to_adjacency(minmax01(v), eps=eps, sigma2=sigma2)
    return r, torch.stack([torch.min(v), torch.max(v)])


def fused_adjacency_cuda(u: torch.Tensor, *, eps: float, sigma2: float,
                         clamp: bool = False, plan: str | None = None,
                         epilogue: str | None = None):
    """The CUDA kernel: returns (R (N, N), stats (2,) = [lo, hi]).

    ``plan`` forces one of :data:`PLANS` that takes (N, d)
    (:func:`fused_adjacency_plans`), and ``epilogue`` one of
    :data:`EPILOGUES`, to time them against each other; None takes the
    planned ones.  u must be a contiguous float32 (N, d) CUDA tensor.  For
    N = 0, R is (0, 0) and stats NaN, with no launch."""
    if not u.is_cuda or u.dim() != 2:
        raise ValueError(f"fused_adjacency_cuda takes a 2-D CUDA tensor, "
                         f"got {u.dim()}-D on {u.device}")
    if u.dtype != torch.float32 or not u.is_contiguous():
        raise ValueError("fused_adjacency_cuda takes a contiguous float32 "
                         f"tensor, got {u.dtype}")
    n, d = u.shape
    if n == 0:
        return (torch.empty((0, 0), dtype=torch.float32, device=u.device),
                torch.full((2,), float("nan"), device=u.device))
    kind = -1 if plan is None else PLANS.index(plan)
    epi = -1 if epilogue is None else EPILOGUES.index(epilogue)
    with torch.cuda.device(u.device):
        if plan is not None and plan not in fused_adjacency_plans(n, d):
            raise ValueError(f"fused_adjacency_cuda: plan {plan!r} does not "
                             f"take {(n, d)}")
        nbytes = _ask("fused_adjacency_scratch_bytes", n, d, kind,
                      restype=ctypes.c_longlong)
        r = torch.empty((n, n), dtype=torch.float32, device=u.device)
        stats = torch.empty(2, dtype=torch.float32, device=u.device)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=u.device) \
            if nbytes else None
        stream = stream_of(u)
        KERNEL(u.data_ptr(), n, d, int(clamp), eps, sigma2, kind, epi,
               r.data_ptr(), None if scratch is None else scratch.data_ptr(),
               grid_state(u.device, stream).data_ptr(), stats.data_ptr(),
               stream)
    return r, stats


# (C function, arguments, device index) -> its answer
_answers: dict[tuple, int] = {}


def _ask(symbol: str, *args: int, restype=ctypes.c_int) -> int:
    """One of the kernel library's plan questions, for the current device
    (the answers depend on its SM count), asked once."""
    key = (symbol, args, torch.cuda.current_device())
    if key not in _answers:
        fn = getattr(library("graph_fused"), symbol)
        fn.argtypes, fn.restype = [I] * len(args), restype
        _answers[key] = int(fn(*args))
    return _answers[key]


def fused_adjacency_plan(n: int, d: int) -> str:
    """The plan fused_adjacency_cuda's tile pass takes for (n, d) on the
    current device: ``small``, ``split``, ``serial`` or ``big``."""
    return PLANS[_ask("fused_adjacency_plan_kind", n, d)]


def fused_adjacency_plans(n: int, d: int) -> list[str]:
    """Every plan that takes (n, d) when forced."""
    return [p for k, p in enumerate(PLANS)
            if _ask("fused_adjacency_plan_takes", n, d, k)]


def fused_adjacency_epilogue(n: int) -> str:
    """Who turns V into R for n clients: ``last_block`` (the tile pass's
    last block; the call is one launch) or ``launch`` (its own launch)."""
    return EPILOGUES[_ask("fused_adjacency_epilogue_kind", n)]


def fused_adjacency(u: torch.Tensor, *, eps: float, sigma2: float,
                    clamp: bool = False):
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version.  Returns (R, stats)."""
    if u.is_cuda:
        return fused_adjacency_cuda(u, eps=eps, sigma2=sigma2, clamp=clamp)
    if u.device.type != "cpu":
        raise ValueError(f"fused_adjacency: no kernel for {u.device}")
    return fused_adjacency_plain(u, eps=eps, sigma2=sigma2, clamp=clamp)
