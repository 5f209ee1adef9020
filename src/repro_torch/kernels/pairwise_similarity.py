"""The staged 3DG kernels: similarity V = U·Uᵀ and the adjacency epilogue
V -> R, each beside its plain version.

Replaces ``repro/kernels/pairwise_similarity.py`` ``_sim_kernel`` /
``similarity_pallas`` and ``_adj_kernel`` / ``adjacency_pallas`` with
``csrc/pairwise_similarity.cu``.  The staged route writes V and R between
its stages (the fused kernel, ``graph_fused``, never writes V): it serves
``similarity="precomputed"`` and every caller that needs V.  The similarity
is summed in the order ``ref.similarity_ref`` fixes (chunks of
``SIM_CHUNK`` columns, each chunk's partial in ascending k, mul then add,
the partials added in ascending order), which the fused kernel also
follows, and the adjacency is the fused kernel's epilogue, so given the
same features the staged R is bitwise the fused R.  What bounds them on the
card: the similarity's N(N+1)/2·d multiply-adds (the kernel computes the
upper triangle and mirrors it; where its tiles are too few to fill the card
it splits the chunks over blocks and adds their partials in order), the
adjacency's bytes (V in, R out: a thread for every access of the flat N²
array, single entries at small N, 16-byte vectors beyond,
:func:`adjacency_grid`).

lo/hi are reduced by the caller (``torch.min``/``torch.max``, as the JAX
wrapper reduces them outside its kernel) and handed over as a (2,) device
tensor, so the adjacency kernel needs no host sync.  Each wrapper launches
the kernel for CUDA tensors and takes the plain version only for CPU
tensors.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import (F, I, P, Kernel, library,
                                        stream_of)
# the plain similarity: V summed in the kernel's order
from repro_torch.kernels.ref import similarity_ref as similarity_plain

SIM_KERNEL = Kernel("pairwise_similarity", "similarity_launch",
                    [P, I, I, P, P, P])
SERIAL_KERNEL = Kernel("pairwise_similarity", "similarity_serial_launch",
                       [P, I, I, P, P])
ADJ_KERNEL = Kernel("pairwise_similarity", "adjacency_launch",
                    [P, I, P, F, F, P, P])
ADJ_THREADS = 256            # csrc/similarity.cuh ADJ_THREADS
ADJ_ENTRIES_MOST = 1 << 18   # single entries up to this many (N = 512)


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
        # the split plan's partials (none when the plan does not split)
        nbytes = _plan(n, d, u.device.index)[1]
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=u.device) \
            if nbytes else None
        SIM_KERNEL(u.data_ptr(), n, d, v.data_ptr(),
                   None if scratch is None else scratch.data_ptr(),
                   stream_of(u))
    return v


def similarity_serial_cuda(u: torch.Tensor) -> torch.Tensor:
    """V through the kernel's serial plan whatever the shape: bitwise
    similarity_cuda's V.  It exists to time the plans against each other;
    no path of the port calls it."""
    if not u.is_cuda or u.dim() != 2:
        raise ValueError(f"similarity_serial_cuda takes a 2-D CUDA tensor, "
                         f"got {u.dim()}-D on {u.device}")
    u = u.to(torch.float32).contiguous()
    n, d = u.shape
    v = torch.empty((n, n), dtype=torch.float32, device=u.device)
    if n:
        with torch.cuda.device(u.device):
            SERIAL_KERNEL(u.data_ptr(), n, d, v.data_ptr(), stream_of(u))
    return v


def similarity_plan(n: int, d: int) -> str:
    """The plan similarity_cuda takes for (n, d) on the current device."""
    return _plan(n, d, torch.cuda.current_device())[0]


_plans: dict[tuple, tuple[str, int]] = {}


def _plan(n: int, d: int, device_index) -> tuple[str, int]:
    """The kernel's plan for (n, d) on the current device (it depends on
    the SM count) and its scratch bytes, asked once per shape and device."""
    key = (n, d, device_index)
    if key not in _plans:
        lib = library("pairwise_similarity")
        kind, nbytes = lib.similarity_plan_kind, lib.similarity_scratch_bytes
        kind.argtypes, kind.restype = [I, I], ctypes.c_int
        nbytes.argtypes, nbytes.restype = [I, I], ctypes.c_longlong
        _plans[key] = (("serial", "split", "big")[kind(n, d)],
                       int(nbytes(n, d)))
    return _plans[key]


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


def adjacency_grid(n: int) -> tuple[int, int]:
    """The adjacency kernel's (floats a thread's access, blocks) for n on
    aligned storage (``csrc/similarity.cuh`` ``adjacency_grid``, which the
    fused route's epilogue launch also takes): a thread for every access,
    single entries up to :data:`ADJ_ENTRIES_MOST` entries of R, 16-byte
    vectors beyond."""
    width = 1 if n * n <= ADJ_ENTRIES_MOST else 4
    return width, max(1, -(-(-(-n * n // width)) // ADJ_THREADS))


def adjacency_cuda(v: torch.Tensor, stats: torch.Tensor, *, eps: float,
                   sigma2: float) -> torch.Tensor:
    """The CUDA kernel on :func:`adjacency_grid`'s grid.  v and stats are
    taken as they come when they are contiguous float32 (else converted);
    no device context when their device is the current one."""
    dev = v.get_device()
    if dev < 0 or stats.get_device() != dev:
        raise ValueError("adjacency_cuda takes CUDA tensors on one device")
    n = v.shape[0]
    if v.shape != (n, n) or stats.shape != (2,):
        raise ValueError(f"adjacency_cuda: shapes {tuple(v.shape)}, "
                         f"{tuple(stats.shape)} are not (N, N), (2,)")
    if v.dtype != torch.float32 or not v.is_contiguous():
        v = v.to(torch.float32).contiguous()
    if stats.dtype != torch.float32 or not stats.is_contiguous():
        stats = stats.to(torch.float32).contiguous()
    r = v.new_empty((n, n))
    if n == 0:
        return r
    args = (v.data_ptr(), n, stats.data_ptr(), eps, sigma2, r.data_ptr())
    if dev == torch.cuda.current_device():
        ADJ_KERNEL(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            ADJ_KERNEL(*args, torch.cuda.current_stream(dev).cuda_stream)
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
