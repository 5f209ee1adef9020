"""Attention for the LM (the port of ``repro.models.attention``).

Causal self-attention in prefill goes through the sliding-window kernel
(``ops.window_attention``; full attention is window = Sk), which takes the
KV heads unrepeated.  The reference computes the same function with its
pure-JAX paths (``attend_dense`` up to 8192 positions, chunked and windowed
scans beyond); the JAX package pins the kernel equal to ``attend_dense``
(``tests/test_kernels.py``).  Decode, one query token against the cache,
is plain PyTorch in the reference's op order, as the reference computes it
outside any kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv·n_rep, D), repeating each KV head."""
    if n_rep == 1:
        return k
    return torch.repeat_interleave(k, n_rep, dim=2)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int | None) -> torch.Tensor:
    """Self-attention over a whole sequence: q (B, S, Hq, D), k/v
    (B, S, Hkv, D) with Hkv dividing Hq (already repeated or not).
    ``window`` None is full causal attention."""
    if not causal:
        raise NotImplementedError(
            "multihead_attention(causal=False) is cross-attention, used only "
            "by the audio family's encoder-decoder, which the port does not "
            "run yet")
    sq, sk = q.shape[1], k.shape[1]
    if sq != sk:
        raise ValueError(f"multihead_attention: causal self-attention takes "
                         f"as many queries as keys, got {sq} and {sk}")
    return ops.window_attention(q, k, v, window=sk if window is None else window)


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  cache_len: int, *, window: int | None) -> torch.Tensor:
    """One-token decode.  q (B, 1, Hq, D); caches (B, Smax, Hkv, D) with Hkv
    dividing Hq; ``cache_len`` valid entries.  With a window shorter than
    the cache only the last ``window`` entries are read (the reference's
    static-size slice, its start clamped into the cache).  Probabilities are
    cast to q's dtype before the product with V, as in the reference."""
    d = q.shape[3]
    smax = k_cache.shape[1]
    if window is not None and smax > window:
        start = min(max(cache_len - window, 0), smax - window)
        kb = k_cache[:, start:start + window]
        vb = v_cache[:, start:start + window]
        kpos = start + torch.arange(window, device=q.device)
    else:
        kb, vb = k_cache, v_cache
        kpos = torch.arange(smax, device=q.device)
    rep = q.shape[2] // kb.shape[2]
    kb, vb = _repeat_kv(kb, rep), _repeat_kv(vb, rep)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(torch.float32) / math.sqrt(d)
    s = torch.where((kpos < cache_len)[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vb)
