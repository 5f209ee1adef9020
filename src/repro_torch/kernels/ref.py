"""Plain PyTorch references (the port of ``repro.kernels.ref``).

The two 3DG references follow the op order their CUDA kernels use, so
kernel and plain version agree bit for bit on the same device; against the
JAX package they agree under the contracts the tests state.
``window_attention_ref`` follows the JAX reference's op order instead
(probabilities rounded to the input dtype before the product with V); the
attention kernel's own plain version is ``window_attention.
window_attention_plain``.
"""
from __future__ import annotations

import math

import torch

# columns of U per partial sum of the similarity; mirrors `KS` in
# csrc/common.cuh (a test holds the two equal)
SIM_CHUNK = 256


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

    The summation order every similarity kernel follows: the d columns of U
    fall into chunks of ``SIM_CHUNK`` consecutive columns; each chunk's
    partial P_c is summed in ascending k as ``p = p + u_ik·u_jk`` with a
    rounding after the product and after the sum (no FMA), starting from 0;
    V = Σ_c P_c adds the partials in ascending c into an accumulator that
    starts from 0.  For d ≤ ``SIM_CHUNK`` that is one ascending-k sum.  The
    CUDA kernels (the staged similarity's split over chunks and the fused
    kernel's serial loop) sum in this order, so their V (and so the min-max
    stats and R's inf pattern) is bitwise this one's.  Against XLA's matmul
    the sums run in another order: f32 round-off."""
    u = u.to(torch.float32)
    n, d = u.shape
    v = torch.zeros((n, n), dtype=torch.float32, device=u.device)
    for c0 in range(0, d, SIM_CHUNK):
        p = torch.zeros_like(v)
        for k in range(c0, min(d, c0 + SIM_CHUNK)):
            p = p + u[:, k:k + 1] * u[:, k]
        v = v + p
    return v


def window_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, window: int) -> torch.Tensor:
    """Causal sliding-window attention, q/k/v (B, S, H, D) with the KV heads
    already repeated; f32 softmax, probabilities cast to q's dtype before
    the product with V (``repro.kernels.ref.window_attention_ref``)."""
    s, d = q.shape[1], q.shape[3]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) / math.sqrt(d)
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    scores = torch.where(mask[None, None], scores, -1e30)
    p = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)
