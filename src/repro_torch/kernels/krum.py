"""The Krum aggregator's pairwise squared-distance panel
D[i, j] = ‖x_i‖² + ‖x_j‖² − 2 x_i·x_j over the (m, P) flat update matrix.

Replaces ``repro/kernels/krum.py`` ``_krum_kernel`` / ``krum_pallas`` with
``csrc/krum.cu``: a row-norm launch, then a tiled Gram kernel that stages
x in shared memory and accumulates over P in IEEE f32 (CUDA cores, never
TF32), with the epilogue ``(n_i + n_j) − 2g`` in the plain version's op
order.  Only the upper tiles run and each writes its mirror, so D is
exactly symmetric.  The panel agrees with the plain version to f32
round-off (the sums over P run in another order); what Krum decides from
it, the chosen rows, is held bitwise.  What bounds it on the card is the
m·(m+1)·P operations of the symmetric Gram; at the main path's m = 6,
launch latency.

:func:`krum_distances` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, Kernel, stream_of

KERNEL = Kernel("krum", "krum_distances_launch", [P, I, I, P, P, P])


def krum_pairwise_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version, the reference's op order:
    ``n2[:, None] + n2[None, :] − 2.0 · (x @ xᵀ)``."""
    x = x.to(torch.float32)
    n2 = torch.sum(x * x, dim=1)
    return n2[:, None] + n2[None, :] - 2.0 * (x @ x.T)


def krum_distances_cuda(x: torch.Tensor) -> torch.Tensor:
    """The CUDA kernel: x (m, P) contiguous f32 on the card -> D (m, m)."""
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"krum_distances_cuda takes a 2-D CUDA tensor, got "
                         f"{x.dim()}-D on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"krum_distances_cuda takes a contiguous float32 "
                         f"matrix, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")
    m, p = x.shape
    d = torch.empty((m, m), dtype=torch.float32, device=x.device)
    if m == 0:
        return d
    if p == 0:
        return d.zero_()
    nrm = torch.empty(m, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        KERNEL(x.data_ptr(), m, p, nrm.data_ptr(), d.data_ptr(),
               stream_of(x))
    return d


def krum_distances(x: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version."""
    if x.is_cuda:
        return krum_distances_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"krum_distances: no kernel for {x.device}")
    return krum_pairwise_ref(x)
