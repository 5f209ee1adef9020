"""Attention for the LM (the port of ``repro.models.attention``).

Two routes, chosen by the caller (``models/lm``), never by looking at
``requires_grad``:

* **prefill** (:func:`prefill_attention`): causal self-attention through
  the sliding-window kernel (``ops.window_attention``; full attention is
  window = Sk), which takes the KV heads unrepeated.  The kernel has no
  backward and refuses an input that requires grad.
* **training** (:func:`multihead_attention`): the reference's three pure
  paths in plain PyTorch with autograd, dispatched as the reference does
  (the reference trains through these, outside any Pallas kernel):

  - dense (S <= ``DENSE_MAX``): materialized (B, H, S, S) scores in
    ``SCORE_DTYPE``;
  - chunked (full attention, long S): online softmax over ``KV_CHUNK``
    key chunks;
  - windowed (sliding window, long S): ``Q_CHUNK`` query chunks, each
    against a static-size key span.

  The knobs are read at call time.  The KV heads are repeated to the query
  heads first, as the reference's ``_attn_fwd`` does, by an expand (whose
  backward is a sum, the same on every run) rather than an index.

The bidirectional encoder and cross-attention (``causal=False``) take the
training route's plain paths in prefill too: the kernel is causal
self-attention only, and no Pallas kernel of the reference serves them.

Decode, one query token against the cache (:func:`decode_attend`) or
against a ring buffer of exactly ``window`` slots
(:func:`decode_attend_ring`), is plain PyTorch in the reference's op order,
as the reference computes it outside any kernel.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import ops

DENSE_MAX = 8192
Q_CHUNK = 1024
KV_CHUNK = 1024

NEG_INF = -1e30

# dtype of the materialized (B, H, Sq, Sk) score/prob buffers in the dense
# path ("float32" or "bfloat16")
SCORE_DTYPE = "float32"


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, Hkv·n_rep, D), repeating each KV head."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(
        b, s, h * n_rep, d)


def _repeated(q, k, v):
    rep = q.shape[2] // k.shape[2]
    return _repeat_kv(k, rep), _repeat_kv(v, rep)


def attend_dense(q, k, v, *, causal: bool, window: int | None,
                 q_offset: int = 0) -> torch.Tensor:
    """Materialized attention.  q (B, Sq, H, D), k/v (B, Sk, H, D) (KV
    already repeated)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    sdt = {"float32": torch.float32,
           "bfloat16": torch.bfloat16}[SCORE_DTYPE]
    neg = torch.tensor(-6e4 if sdt == torch.bfloat16 else NEG_INF,
                       dtype=sdt, device=q.device)
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=sdt, device=q.device)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(sdt) * scale
    qpos = torch.arange(sq, device=q.device) + q_offset
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos[None, :] <= qpos[:, None])
    if window is not None:
        mask = mask & (kpos[None, :] > qpos[:, None] - window)
    scores = torch.where(mask[None, None], scores, neg)
    # max-subtracted softmax: stable in bf16 because exp inputs are <= 0
    m = torch.amax(scores, dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    probs = (p / torch.sum(p, dim=-1, keepdim=True)).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attend_chunked_full(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Online softmax over KV chunks (the flash pattern), all queries at
    once: O(B·H·Sq·KV_CHUNK) transient instead of O(Sq·Sk)."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    chunk = KV_CHUNK
    if sk % chunk:
        raise ValueError(f"attend_chunked_full: {sk} keys are no multiple of "
                         f"KV_CHUNK = {chunk}")
    scale = 1.0 / math.sqrt(d)
    dev = q.device
    qpos = torch.arange(sq, device=dev)
    acc = torch.zeros((b, sq, h, d), dtype=torch.float32, device=dev)
    m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=dev)
    for i in range(sk // chunk):
        kb = k[:, i * chunk:(i + 1) * chunk]
        vb = v[:, i * chunk:(i + 1) * chunk]
        kp = i * chunk + torch.arange(chunk, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(torch.float32) * scale
        if causal:
            msk = kp[None, :] <= qpos[:, None]
            s = torch.where(msk[None, None], s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr.transpose(1, 2)[..., None] + torch.einsum(
            "bhqk,bkhd->bqhd", p.to(q.dtype), vb).to(torch.float32)
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30).transpose(1, 2)[..., None]
    return out.to(q.dtype)


def attend_windowed(q, k, v, *, window: int) -> torch.Tensor:
    """Causal sliding-window attention by query chunks over static key
    spans: chunk i (length C) attends to the W + C keys ending at its last
    position — O(S·(W + C)) compute."""
    b, sq, h, d = q.shape
    c = min(Q_CHUNK, sq)
    if sq % c:
        raise ValueError(f"attend_windowed: {sq} queries are no multiple of "
                         f"Q_CHUNK = {c}")
    span = window + c
    pad = span
    # left-pad K/V so every span slice is in bounds and of static size
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, pad, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, pad, 0))
    dev = q.device
    outs = []
    for i in range(sq // c):
        qb = q[:, i * c:(i + 1) * c]
        start = (i + 1) * c + pad - span
        kb = kp[:, start:start + span]
        vb = vp[:, start:start + span]
        qpos = i * c + torch.arange(c, device=dev)
        kpos = start - pad + torch.arange(span, device=dev)
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kb).to(torch.float32) / \
            math.sqrt(d)
        msk = (kpos[None, :] <= qpos[:, None]) & \
            (kpos[None, :] > qpos[:, None] - window) & (kpos[None, :] >= 0)
        s = torch.where(msk[None, None], s, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", p, vb))
    return torch.cat(outs, dim=1)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool, window: int | None) -> torch.Tensor:
    """The training route: self-attention over a whole sequence, q (B, Sq,
    Hq, D), k/v (B, Sk, Hkv, D) with Hkv dividing Hq (repeated to Hq here
    when not yet), dispatched on sequence length and window as the
    reference dispatches.  ``window`` None is full attention; ``causal``
    False is the audio family's bidirectional encoder and its
    cross-attention (Sq may differ from Sk there)."""
    k, v = _repeated(q, k, v)
    sq, sk = q.shape[1], k.shape[1]
    if window is not None and sk > window + Q_CHUNK and sq == sk:
        return attend_windowed(q, k, v, window=window)
    if max(sq, sk) <= DENSE_MAX:
        return attend_dense(q, k, v, causal=causal, window=window)
    return attend_chunked_full(q, k, v, causal=causal)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      window: int | None) -> torch.Tensor:
    """The prefill route: causal self-attention through the sliding-window
    kernel, q (B, S, Hq, D), k/v (B, S, Hkv, D) unrepeated.  ``window``
    None is full causal attention."""
    sq, sk = q.shape[1], k.shape[1]
    if sq != sk:
        raise ValueError(f"prefill_attention: causal self-attention takes "
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
    kb, vb = _repeated(q, kb, vb)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(torch.float32) / math.sqrt(d)
    s = torch.where((kpos < cache_len)[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vb)


def decode_attend_ring(q: torch.Tensor, k_ring: torch.Tensor,
                       v_ring: torch.Tensor, cache_len: int, *,
                       window: int) -> torch.Tensor:
    """One-token decode over a ring-buffer cache of exactly ``window``
    slots, q (B, 1, Hq, D), rings (B, window, Hkv, D) with Hkv dividing Hq.
    Slot j holds absolute position L − ((L % W − j) mod W), L = ``cache_len``
    the position of the token just written; slots at a negative position
    (a cold start) are masked.  The positions read are those
    :func:`decode_attend` reads over a grown cache, in ring order."""
    d = q.shape[3]
    w = k_ring.shape[1]
    if w != window:
        raise ValueError(f"decode_attend_ring: the ring has {w} slots, the "
                         f"window is {window}")
    j = torch.arange(w, device=q.device)
    pos = cache_len - torch.remainder(cache_len % w - j, w)
    kb, vb = _repeated(q, k_ring, v_ring)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kb).to(torch.float32) / math.sqrt(d)
    s = torch.where((pos >= 0)[None, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, vb)
