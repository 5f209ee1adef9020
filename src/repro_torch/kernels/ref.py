"""Plain PyTorch versions of the 3DG kernels (the port of ``repro.kernels.ref``).

Both follow the op order their CUDA kernels use, so kernel and plain version
agree bit for bit on the same device; against the JAX package they agree
under the contracts the tests state.
"""
from __future__ import annotations

import torch


def floyd_warshall_ref(h: torch.Tensor) -> torch.Tensor:
    """APSP min-plus closure. h (N, N) f32, inf = no edge, diag 0.

    One pivot at a time, ``h = min(h, h[:, k] + h[k, :])``: the op order of
    ``repro.kernels.ref.floyd_warshall_ref`` (bitwise equal given the same
    R) and of the CUDA kernel."""
    h = h.to(torch.float32)
    for k in range(h.shape[0]):
        h = torch.minimum(h, h[:, k:k + 1] + h[k:k + 1, :])
    return h


def similarity_ref(u: torch.Tensor) -> torch.Tensor:
    """Raw dot-product similarity V = U Uᵀ.  u (N, d) f32.

    Summed in ascending k as ``acc = acc + u_ik·u_jk`` with a rounding after
    the product and after the sum (no FMA): the op order of the fused CUDA
    kernel, so the kernel's V (and so its min-max stats and R's inf pattern)
    is bitwise this one's.  Against XLA's matmul the sums run in another
    order: f32 round-off."""
    u = u.to(torch.float32)
    v = torch.zeros((u.shape[0], u.shape[0]), dtype=torch.float32,
                    device=u.device)
    for k in range(u.shape[1]):
        v = v + u[:, k:k + 1] * u[:, k]
    return v
