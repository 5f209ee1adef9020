"""Floyd–Warshall all-pairs shortest paths.

Replaces ``repro/kernels/floyd_warshall.py`` ``_fw_round_kernel`` /
``floyd_warshall_pallas`` with ``csrc/floyd_warshall.cu``: one launch per
pivot k applying ``h = min(h, h[:, k] + h[k, :])`` in place — the plain
version's op order, so the two agree bit for bit (and with the JAX
reference given the same R).  The TPU kernel's blocked rounds rest on a
sequential grid with resident panels, which CUDA blocks do not have; the
per-pivot design needs neither.  What bounds it on the card: N launches
that each stream the (N, N) matrix — memory traffic beyond the L2 and
launch latency at small N, well above the 2N³ min/add operations of the
work.  A blocked, shared-memory version is later work.

Precondition (as for every adjacency the 3DG builds): no negative entry
and no NaN, so row and column k do not change at step k and the in-place
update is race-free.

:func:`floyd_warshall` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, Kernel, stream_of
from repro_torch.kernels.ref import floyd_warshall_ref

KERNEL = Kernel("floyd_warshall", "floyd_warshall_launch", [P, I, P])

floyd_warshall_plain = floyd_warshall_ref


def floyd_warshall_cuda(h: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel on a copy of ``h`` (N, N); returns the distances."""
    if not h.is_cuda or h.dim() != 2 or h.shape[0] != h.shape[1]:
        raise ValueError(f"floyd_warshall_cuda takes a square CUDA matrix, "
                         f"got {tuple(h.shape)} on {h.device}")
    out = h.to(torch.float32, copy=True).contiguous()
    if out.shape[0] == 0:
        return out
    with torch.cuda.device(out.device):
        KERNEL(out.data_ptr(), out.shape[0], stream_of(out))
    return out


def floyd_warshall(h: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version."""
    if h.is_cuda:
        return floyd_warshall_cuda(h)
    if h.device.type != "cpu":
        raise ValueError(f"floyd_warshall: no kernel for {h.device}")
    return floyd_warshall_plain(h)
