"""The staged 3DG kernels: similarity V = U·Uᵀ and the adjacency epilogue
V -> R, each beside its plain version.

Replaces ``repro/kernels/pairwise_similarity.py`` ``_sim_kernel`` /
``similarity_pallas`` and ``_adj_kernel`` / ``adjacency_pallas`` with
``csrc/pairwise_similarity.cu``.  The staged route writes V and R between
its stages (the fused kernel, ``graph_fused``, never writes V): it serves
``similarity="precomputed"`` and every caller that needs V.  The similarity
is summed in ascending k, mul then add (``ref.similarity_ref``), and the
adjacency is the fused kernel's epilogue, so given the same features the
staged R is bitwise the fused R.  What bounds them on the card: the
similarity's N²·d multiply-adds, the adjacency's bytes (V in, R out).

lo/hi are reduced by the caller (``torch.min``/``torch.max``, as the JAX
wrapper reduces them outside its kernel) and handed over as a (2,) device
tensor, so the adjacency kernel needs no host sync.  Each wrapper launches
the kernel for CUDA tensors and takes the plain version only for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import F, I, P, Kernel, stream_of
# the plain similarity: V summed in the kernel's order
from repro_torch.kernels.ref import similarity_ref as similarity_plain

SIM_KERNEL = Kernel("pairwise_similarity", "similarity_launch", [P, I, I, P, P])
ADJ_KERNEL = Kernel("pairwise_similarity", "adjacency_launch",
                    [P, I, P, F, F, P, P])


# -------------------------------------------------------------- similarity
def similarity_cuda(u: torch.Tensor) -> torch.Tensor:
    if not u.is_cuda or u.dim() != 2:
        raise ValueError(f"similarity_cuda takes a 2-D CUDA tensor, got "
                         f"{u.dim()}-D on {u.device}")
    u = u.to(torch.float32).contiguous()
    n, d = u.shape
    v = torch.empty((n, n), dtype=torch.float32, device=u.device)
    if n == 0:
        return v
    with torch.cuda.device(u.device):
        SIM_KERNEL(u.data_ptr(), n, d, v.data_ptr(), stream_of(u))
    return v


def similarity(u: torch.Tensor) -> torch.Tensor:
    """Features u (N, d) -> raw similarity V = U Uᵀ (N, N) float32."""
    if u.is_cuda:
        return similarity_cuda(u)
    if u.device.type != "cpu":
        raise ValueError(f"similarity: no kernel for {u.device}")
    return similarity_plain(u)


# --------------------------------------------------------------- adjacency
def adjacency_plain(v: torch.Tensor, stats: torch.Tensor, *, eps: float,
                    sigma2: float) -> torch.Tensor:
    """Vn = (V − lo) / max(hi − lo, 1e-12), then 0 on the diagonal,
    exp(−Vn/σ²) where Vn ≥ eps and inf elsewhere (``graph_device``'s
    ``minmax01`` and ``to_adjacency``, given lo/hi)."""
    from repro_torch.core.graph_device import to_adjacency
    vn = (v.to(torch.float32) - stats[0]) / torch.clamp_min(
        stats[1] - stats[0], 1e-12)
    return to_adjacency(vn, eps=eps, sigma2=sigma2)


def adjacency_cuda(v: torch.Tensor, stats: torch.Tensor, *, eps: float,
                   sigma2: float) -> torch.Tensor:
    if not (v.is_cuda and stats.is_cuda):
        raise ValueError("adjacency_cuda takes CUDA tensors")
    n = v.shape[0]
    if v.shape != (n, n) or stats.shape != (2,):
        raise ValueError(f"adjacency_cuda: shapes {tuple(v.shape)}, "
                         f"{tuple(stats.shape)} are not (N, N), (2,)")
    v = v.to(torch.float32).contiguous()
    st = stats.to(torch.float32).contiguous()
    r = torch.empty((n, n), dtype=torch.float32, device=v.device)
    if n == 0:
        return r
    with torch.cuda.device(v.device):
        ADJ_KERNEL(v.data_ptr(), n, st.data_ptr(), eps, sigma2, r.data_ptr(),
                   stream_of(v))
    return r


def adjacency(v: torch.Tensor, stats: torch.Tensor, *, eps: float,
              sigma2: float) -> torch.Tensor:
    """Raw similarity v (N, N) and stats (2,) = [lo, hi] on v's device ->
    the 3DG adjacency R (N, N): 0 on the diagonal, exp(−Vn/σ²) where the
    normalized Vn ≥ eps, inf (no edge) elsewhere."""
    if v.is_cuda:
        return adjacency_cuda(v, stats, eps=eps, sigma2=sigma2)
    if v.device.type != "cpu":
        raise ValueError(f"adjacency: no kernel for {v.device}")
    return adjacency_plain(v, stats, eps=eps, sigma2=sigma2)
