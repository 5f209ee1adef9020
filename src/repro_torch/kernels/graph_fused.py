"""Fused 3DG adjacency: similarity -> min-max stats -> adjacency.

Replaces ``repro/kernels/graph_fused.py`` ``_fused_kernel`` /
``fused_adjacency_pallas`` with ``csrc/graph_fused.cu``.  The kernel keeps
V = U·Uᵀ out of device memory: pass 1 reduces lo/hi over every V tile with
order-preserving atomics (exact: min and max are associative), pass 2
recomputes each tile and writes R.  What bounds it on the card is the
2·N²·d multiply-adds of the product; the bytes are only U in and R out.

The plain version is the staged pipeline (``ref.similarity_ref`` ->
``graph_device.minmax01`` -> ``to_adjacency``), whose V the kernel
reproduces bit for bit (same ascending-k mul-then-add order), so lo/hi and
R's inf pattern match exactly.  Unlike the TPU kernel there is no padding:
Floyd–Warshall takes any N, so R comes out at (N, N).

:func:`fused_adjacency` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, P, Kernel, stream_of

KERNEL = Kernel("graph_fused", "fused_adjacency_launch",
                [P, I, I, I, F, F, P, P, P, P])


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
                         clamp: bool = False):
    """The CUDA kernel: returns (R (N, N), stats (2,) = [lo, hi])."""
    if not u.is_cuda or u.dim() != 2:
        raise ValueError(f"fused_adjacency_cuda takes a 2-D CUDA tensor, "
                         f"got {u.dim()}-D on {u.device}")
    u = u.to(torch.float32).contiguous()
    n, d = u.shape
    r = torch.empty((n, n), dtype=torch.float32, device=u.device)
    keys = torch.empty(2, dtype=torch.int32, device=u.device)
    stats = torch.empty(2, dtype=torch.float32, device=u.device)
    if n == 0:
        return r, stats
    with torch.cuda.device(u.device):
        KERNEL(u.data_ptr(), n, d, int(clamp), eps, sigma2, r.data_ptr(),
               keys.data_ptr(), stats.data_ptr(), stream_of(u))
    return r, stats


def fused_adjacency(u: torch.Tensor, *, eps: float, sigma2: float,
                    clamp: bool = False):
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version.  Returns (R, stats)."""
    if u.is_cuda:
        return fused_adjacency_cuda(u, eps=eps, sigma2=sigma2, clamp=clamp)
    if u.device.type != "cpu":
        raise ValueError(f"fused_adjacency: no kernel for {u.device}")
    return fused_adjacency_plain(u, eps=eps, sigma2=sigma2, clamp=clamp)
