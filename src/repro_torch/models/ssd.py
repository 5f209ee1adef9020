"""Mamba-2 / SSD (state-space duality) block, chunked (the port of
``repro.models.ssd``).

Follows arXiv:2405.21060 (Dao & Gu, "Transformers are SSMs"):
  h_t = exp(dt_t·A) h_{t-1} + dt_t · B_t ⊗ x_t        (per head, state N)
  y_t = C_t · h_t + D ⊙ x_t
Chunked form: a within-chunk attention-like term plus the cross-chunk state
recurrence (the reference's ``lax.scan`` over chunks is a Python loop).
Single B/C group (ngroups = 1) as in mamba2-780m.  Params are the
reference's separate projections (w_z / w_x / w_B / w_C / w_dt), a flat
dict of tensors.

The operation order is the reference's: segment sums by cumsum difference,
``L = exp(segsum)`` masked with −inf above the diagonal, the chunk states,
the inter-chunk recurrence, the final state from the last incoming state,
and padding to a chunk multiple with dt = 0.  The reference's multi-operand
einsums are written as the batched products they amount to, so f32 results
agree with it to round-off, not bit for bit.  States are f32; the conv
state keeps the activations' dtype.  ``silu`` and ``softplus`` are torch's
one-kernel ops, as the FFN's gate is: in bf16 XLA:CPU rounds each op of
``jax.nn.silu``'s graph, so the port's silu is within 2 bf16 ulps of the
reference's, not bit for bit.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init, draw_kw


def init_ssd(gen: torch.Generator, d_model: int, cfg, dtype) -> dict:
    """cfg: SSMConfig.  The reference's distributions, drawn from ``gen``."""
    d_in = cfg.expand * d_model
    nheads = d_in // cfg.head_dim
    dev = gen.device
    u = torch.rand(nheads, dtype=torch.float32, **draw_kw(gen))
    lo, hi = math.log(1e-3), math.log(1e-1)
    dt = torch.exp(lo + u * (hi - lo))
    return {
        "w_z": dense_init(gen, d_model, d_in, dtype),
        "w_x": dense_init(gen, d_model, d_in, dtype),
        "w_B": dense_init(gen, d_model, cfg.d_state, dtype),
        "w_C": dense_init(gen, d_model, cfg.d_state, dtype),
        "w_dt": dense_init(gen, d_model, nheads, dtype),
        "dt_bias": torch.log(torch.expm1(dt)),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads,
                                          dtype=torch.float32, device=dev)),
        "D": torch.ones(nheads, dtype=torch.float32, device=dev),
        "conv_w": (torch.randn((cfg.d_conv, d_in + 2 * cfg.d_state),
                               dtype=torch.float32, **draw_kw(gen))
                   * 0.1).to(dtype),
        "w_out": dense_init(gen, d_in, d_model, dtype),
    }


def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 init_state: torch.Tensor | None = None):
    """Depthwise causal conv.  u (B, S, C), w (K, C).  Returns (y, the last
    K − 1 inputs)."""
    k, s = w.shape[0], u.shape[1]
    if init_state is None:
        init_state = torch.zeros((u.shape[0], k - 1, u.shape[2]),
                                 dtype=u.dtype, device=u.device)
    up = torch.cat([init_state, u], dim=1)
    y = sum(up[:, i:i + s] * w[i][None, None] for i in range(k))
    return F.silu(y), up[:, -(k - 1):]


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., Q) -> (..., Q, Q) lower-triangular segment sums:
    out[i, j] = Σ_{j<k<=i} a[k], −inf above the diagonal."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, out, -math.inf)


def ssd_chunked(x, dt, A, B, C, D, *, chunk: int, init_state=None):
    """SSD forward.

    x (b, s, h, p)   dt (b, s, h)    A (h,) [negative]
    B (b, s, n)      C (b, s, n)     D (h,)
    Returns y (b, s, h, p) in x's dtype, final_state (b, h, p, n) f32.
    """
    b, s, h, p = x.shape
    n = B.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_chunked: {s} steps are no multiple of the "
                         f"chunk {chunk}")
    nc = s // chunk
    f32 = torch.float32
    xc = x.reshape(b, nc, chunk, h, p).to(f32)
    dtc = dt.reshape(b, nc, chunk, h).to(f32)
    Bc = B.reshape(b, nc, chunk, n).to(f32)
    Cc = C.reshape(b, nc, chunk, n).to(f32)

    a = dtc * A[None, None, None]                       # (b,nc,q,h) log-decay
    a_h = a.permute(0, 1, 3, 2)                         # (b,nc,h,q)
    a_cum = torch.cumsum(a_h, dim=-1)                   # within-chunk cumulative

    # ---- intra-chunk (diagonal blocks): attention-like with decay mask
    L = torch.exp(_segsum(a_h))                         # (b,nc,h,q,q)
    scores = Cc @ Bc.transpose(-1, -2)                  # (b,nc,q,q)
    xh = xc.permute(0, 1, 3, 2, 4)                      # (b,nc,h,q,p)
    dth = dtc.permute(0, 1, 3, 2)                       # (b,nc,h,q)
    ydiag = (L * scores[:, :, None] * dth[..., None, :]) @ xh   # (b,nc,h,q,p)

    # ---- chunk states: the state each chunk contributes
    decay_to_end = torch.exp(a_cum[..., -1:] - a_cum)   # (b,nc,h,q)
    states = (xh * (decay_to_end * dth)[..., None]).transpose(-1, -2) \
        @ Bc[:, :, None]                                # (b,nc,h,p,n)

    # ---- inter-chunk recurrence over the chunk index
    chunk_decay = torch.exp(a_cum[..., -1])             # (b,nc,h)
    st = (torch.zeros((b, h, p, n), dtype=f32, device=x.device)
          if init_state is None else init_state)
    prev = []
    for c in range(nc):
        prev.append(st)                                 # state seen by chunk c
        st = st * chunk_decay[:, c][..., None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)              # (b,nc,h,p,n)

    # ---- inter-chunk output: the decayed incoming state read by C
    in_decay = torch.exp(a_cum)                         # (b,nc,h,q)
    yoff = (Cc[:, :, None] @ prev_states.transpose(-1, -2)) * \
        in_decay[..., None]                             # (b,nc,h,q,p)

    y = (ydiag + yoff).permute(0, 1, 3, 2, 4) + \
        (x.to(f32) * D[None, None, :, None]).reshape(b, nc, chunk, h, p)
    return y.reshape(b, s, h, p).to(x.dtype), st


def _project(params, x, cfg, conv_state):
    """The mixer's input side: the gate z, then x, B, C through the causal
    conv, and dt; returns (z, xs, B, C, dt, the new conv state)."""
    d_in = cfg.expand * x.shape[-1]
    z = x @ params["w_z"]
    xbc = torch.cat([x @ params["w_x"], x @ params["w_B"],
                     x @ params["w_C"]], dim=-1)
    xbc, new_conv = _causal_conv(xbc, params["conv_w"], conv_state)
    xs, B, C = torch.split(xbc, [d_in, cfg.d_state, cfg.d_state], dim=-1)
    dt = F.softplus((x @ params["w_dt"]).to(torch.float32) +
                  params["dt_bias"][None, None])
    return z, xs, B, C, dt, new_conv


def apply_ssd(params, x, cfg, *, state=None, conv_state=None):
    """The full mamba2 mixer.  x (b, s, d_model) -> (y (b, s, d_model),
    (ssm_state (b, h, p, n) f32, conv_state (b, K − 1, C))) for decode
    continuation."""
    d_in = cfg.expand * x.shape[-1]
    h = d_in // cfg.head_dim
    z, xs, B, C, dt, new_conv = _project(params, x, cfg, conv_state)
    A = -torch.exp(params["A_log"])

    # pad the sequence to a chunk multiple; dt = 0 on the padding makes the
    # padded steps identity transitions (decay 1, no contribution), so the
    # final state is exact for decode continuation
    s_len = xs.shape[1]
    chunk = min(cfg.chunk, s_len)
    pad = (-s_len) % chunk
    if pad:
        xs_p = torch.nn.functional.pad(xs, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
    else:
        xs_p = xs
    xh = xs_p.reshape(*xs_p.shape[:-1], h, cfg.head_dim)
    y, new_state = ssd_chunked(xh, dt, A, B, C, params["D"], chunk=chunk,
                               init_state=state)
    y = y.reshape(xs_p.shape[0], xs_p.shape[1], d_in)[:, :s_len]
    y = y * F.silu(z)
    return y @ params["w_out"], (new_state, new_conv)


def ssd_decode_step(params, x, cfg, state, conv_state):
    """A single-token recurrent step.  x (b, 1, d_model); state (b, h, p, n)
    f32; conv_state (b, K − 1, C).  Returns (y, (state, conv_state)), both
    new tensors."""
    d_in = cfg.expand * x.shape[-1]
    h = d_in // cfg.head_dim
    z, xs, B, C, dt, new_conv = _project(params, x, cfg, conv_state)
    dt = dt[:, 0]                                                # (b,h)
    A = -torch.exp(params["A_log"])
    xh = xs[:, 0].reshape(-1, h, cfg.head_dim).to(torch.float32)  # (b,h,p)
    Bt = B[:, 0].to(torch.float32)                               # (b,n)
    Ct = C[:, 0].to(torch.float32)

    decay = torch.exp(dt * A[None])                              # (b,h)
    upd = (dt[..., None] * xh)[..., None] * Bt[:, None, None, :]
    new_state = state * decay[..., None, None] + upd
    y = (new_state @ Ct[:, None, :, None])[..., 0] + \
        xh * params["D"][None, :, None]
    y = y.reshape(x.shape[0], 1, d_in).to(x.dtype)
    y = y * F.silu(z)
    return y @ params["w_out"], (new_state, new_conv)
