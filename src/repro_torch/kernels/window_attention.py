"""Causal sliding-window attention with an online softmax.

Replaces ``repro/kernels/window_attention.py`` ``_wa_kernel`` /
``window_attention_pallas`` with ``csrc/window_attention.cu``: one block
per (64-row query tile, query head, batch row) loops over 64-key tiles of
the rows' span, each row's running max, denominator and accumulator in
registers.  Scores, probabilities and the accumulator are f32; the output
is cast once to the input dtype.  Query head h reads KV head h // (Hq /
Hkv), the reference's ``_repeat_kv`` without the copy.  Full causal
attention is window = S.  What bounds it on the card: 4·B·Hq·D·P
operations over the P visible pairs per (b, h).  bf16 with D <= 128 (the
LM's prefill) runs them on the tensor cores (``mma.sync`` bf16 -> f32,
K/V tiles in bf16 through a ``cp.async`` ring, P·V with p split into three
bf16 terms so that it keeps f32's precision); f32, and bf16 with D > 128,
on the CUDA cores.

:func:`window_attention` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; on the meta device (a dry-run's shape
trace, ``launch/dryrun.py``) nothing runs: it returns an empty output of
the right shape and logs the call in ``META_CALLS``.  The kernel has no backward, so both
refuse (raise on) an input that requires grad while grad mode is on: a
backward would otherwise drop the attention's gradients on the card and
not on the CPU.  Training takes ``models/attention``'s training route.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels._build import F, I, P, Kernel, stream_of

KERNEL = Kernel("window_attention", "window_attention_launch",
                [P, P, P, P, I, I, I, I, I, I, F, I, P])
NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)


def _check_shapes(q, k, v, window) -> None:
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"window_attention takes q (B, S, Hq, D) and k, v "
                         f"(B, S, Hkv, D), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    if (k.shape[0], k.shape[1], k.shape[3]) != (b, s, d) or hkv == 0 or \
            hq % hkv:
        raise ValueError(f"window_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)} (Hkv must divide Hq)")
    if window < 1:
        raise ValueError(f"window_attention: window must be >= 1, got {window}")


def _refuse_grad(q, k, v) -> None:
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or
                                    v.requires_grad):
        raise RuntimeError(
            "window_attention has no backward: an input requires grad with "
            "grad mode on.  Train through models.attention."
            "multihead_attention (the training route), or call under "
            "torch.no_grad()")


def window_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, window: int) -> torch.Tensor:
    """The same function in PyTorch: f32 scores scaled by 1/√D, masked with
    −1e30 outside i − window < j ≤ i, softmax in f32, the product with V in
    f32, one cast to q's dtype at the end."""
    _check_shapes(q, k, v, window)
    b, s, hq, d = q.shape
    rep = hq // k.shape[2]
    qf = q.to(torch.float32).transpose(1, 2)                 # (B, Hq, S, D)
    kf = k.to(torch.float32).repeat_interleave(rep, dim=2).transpose(1, 2)
    vf = v.to(torch.float32).repeat_interleave(rep, dim=2).transpose(1, 2)
    scores = (qf @ kf.transpose(-1, -2)) * (1.0 / math.sqrt(d))
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = (kpos <= qpos) & (kpos > qpos - window)
    scores = torch.where(mask, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return (p @ vf).transpose(1, 2).to(q.dtype)


def window_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, window: int) -> torch.Tensor:
    """The CUDA kernel: contiguous q (B, S, Hq, D), k/v (B, S, Hkv, D) of one
    dtype (f32 or bf16) on the card, D a multiple of 16 up to 256.  Raises
    on an input that requires grad under grad mode (no backward)."""
    _check_shapes(q, k, v, window)
    _refuse_grad(q, k, v)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"window_attention_cuda takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"window_attention_cuda takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("window_attention_cuda takes contiguous q, k, v")
    b, s, hq, d = q.shape
    if d % 16 or not 16 <= d <= 256:
        raise ValueError(f"window_attention_cuda takes a head dim that is a "
                         f"multiple of 16 up to 256, got {d}")
    if q.dtype == torch.bfloat16 and d <= 128 and \
            any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("window_attention_cuda takes bf16 q, k, v whose "
                         "data start on a 16-byte boundary (the tensor-core "
                         "body's 16-byte async copies)")
    o = torch.empty_like(q)
    if b == 0 or s == 0:
        return o
    with torch.cuda.device(q.device):
        KERNEL(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s,
               hq, k.shape[2], d, min(window, s), 1.0 / math.sqrt(d),
               int(q.dtype == torch.bfloat16), stream_of(q))
    return o


def visible_pairs(s: int, window: int) -> int:
    """Σ_i min(i + 1, window) over i < s: the (query, key) pairs one head
    of one sequence attends to."""
    w = min(window, s)
    return w * (w + 1) // 2 + (s - w) * w


def attention_ops(b: int, s: int, hq: int, d: int, window: int) -> int:
    """The kernel's operations (PERF.md §6): 4·B·Hq·D per visible pair
    (QKᵀ and P·V, a multiply and an add each)."""
    return 4 * b * hq * d * visible_pairs(s, window)


# Calls on the meta device (shapes only: a dry-run's trace): one entry per
# call, (B, S, Hq, Hkv, D, window).  Nothing runs and nothing is launched;
# the tracer adds each call's ``attention_ops`` to what it counts.
META_CALLS: list[tuple[int, int, int, int, int, int]] = []


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int) -> torch.Tensor:
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version, meta (a shape trace) returns an empty output of the
    right shape and logs the call in ``META_CALLS``.  Each refuses an input
    that requires grad under grad mode, as the kernel has no backward."""
    _refuse_grad(q, k, v)
    if q.is_cuda:
        return window_attention_cuda(q, k, v, window=window)
    if q.device.type == "meta":
        _check_shapes(q, k, v, window)
        b, s, hq, d = q.shape
        META_CALLS.append((b, s, hq, k.shape[2], d, window))
        return torch.empty_like(q)
    if q.device.type != "cpu":
        raise ValueError(f"window_attention: no kernel for {q.device}")
    return window_attention_plain(q, k, v, window=window)
