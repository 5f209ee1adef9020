"""Plain PyTorch reference of a FedGS sweep: B cells of federated logistic
regression on host availability masks, each round

  sampler   FedGS (Eq. 14/16: greedy m steps, then best-swap sweeps on
            Q = sym(alpha/N H) - diag(z)) or uniform (Gumbel top-m),
  training  E SGD steps of B samples on each sampled client (softmax
            cross-entropy, gradients written out by hand),
  server    FedAvg weighted by data size (Eq. 18),
  eval      the mean cross-entropy on the shared validation set,

with H the 3DG (Appendix C): V = U U^T, min-max normalized, edges
exp(-Vn / sigma2) where Vn >= eps, Floyd-Warshall shortest paths, capped
and scaled to [0, 1].  It imports nothing of the program and takes none of
its state: the inputs are the benchmark's.  The program's default random
streams are a documented convention (a ``torch.Generator`` seeded from
``SeedSequence([seed, t, 1])`` for the batch rows, ``[sampler_seed, t]`` for
the Gumbel noise), so the reference draws the same numbers from the same
seeds on the same device.

Order of operations.  FedGS's sets are decided by exact comparisons, so the
reference forms each value the program compares in the order the paper's
solver states it (Q entries ``0.5 ((a H_ij - d_ij z_i) + (a H_ji - d_ij z_j))``,
gains ``diag + 2 r``, swap deltas ``(out_i + in_j) - 2 Q_ij``, first maximum
in row-major order, a swap taken only above 1e-9; V summed over chunks of 256
columns, each ascending, with no fused multiply-add).  Training, averaging
and eval follow the mathematics in plain float32 with TF32 off.  ``starts``
restarts the weights at given rounds from given values (the program's, to
follow it segment by segment; the sets and counts run on free).

``tf32=True`` is the control: every product's operands are rounded to TF32
(10 mantissa bits) first, as TF32 tensor cores do, the nearest precision
below the configuration's float32.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e18
SWAP_TOL = 1e-9
SIM_CHUNK = 256


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> nearest TF32 value (ties to even), kept in float32."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & ~0x1FFF
    i = torch.where(i >= 2 ** 31, i - 2 ** 32, i)
    return i.to(torch.int32).view(torch.float32)


def stream(entropy, device) -> torch.Generator:
    """The program's default stream for ``entropy``."""
    state = np.random.SeedSequence(list(entropy)).generate_state(1)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(state[0]))
    return gen


# ---------------------------------------------------------------- the 3DG
def build_h(u: torch.Tensor, *, eps: float, sigma2: float,
            cap_scale: float = 2.0, tf32: bool = False) -> torch.Tensor:
    u = u.to(torch.float32)
    if tf32:
        u = round_tf32(u)
    n, d = u.shape
    v = torch.zeros((n, n), dtype=torch.float32, device=u.device)
    for c0 in range(0, d, SIM_CHUNK):
        p = torch.zeros_like(v)
        for k in range(c0, min(d, c0 + SIM_CHUNK)):
            p = p + u[:, k:k + 1] * u[:, k]
        v = v + p
    lo, hi = torch.min(v), torch.max(v)
    vn = (v - lo) / torch.clamp_min(hi - lo, 1e-12)
    s2 = torch.full((), sigma2, dtype=torch.float32, device=u.device)
    eye = torch.eye(n, dtype=torch.bool, device=u.device)
    r = torch.where(vn >= eps, torch.exp(-vn / s2),
                    torch.full_like(vn, float("inf")))
    h = torch.where(eye, torch.zeros_like(r), r)
    for k in range(n):
        h = torch.minimum(h, h[:, k:k + 1] + h[k:k + 1, :])
    finite = torch.isfinite(h)
    mx = torch.max(torch.where(finite, h, torch.full_like(h, -float("inf"))))
    cap = cap_scale * torch.where(torch.isfinite(mx), mx, torch.ones_like(mx))
    h = torch.where(eye, torch.zeros_like(h),
                    torch.where(finite, h, cap.expand_as(h)))
    hmax = torch.max(h)
    return h / torch.where(hmax > 0, hmax, torch.ones_like(hmax))


# ------------------------------------------------------------- the samplers
def fedgs_sets(h: torch.Tensor, counts: torch.Tensor, avail: torch.Tensor,
               *, alpha: float, m: int, sweeps: int) -> torch.Tensor:
    """(B, N) bool sets for B cells sharing H: Eq. 16 by greedy + swaps."""
    b, n = avail.shape
    dev = h.device
    a = float(np.float32(alpha) / np.float32(n))
    counts = counts.to(torch.float32)
    mean = torch.sum(counts, -1, keepdim=True) * float(
        np.float32(1.0) / np.float32(n))
    z = 2.0 * (counts - mean - m / n) + 1.0                      # (B, N)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    t = a * h[None] - torch.where(eye[None], z[:, :, None],
                                  torch.zeros((), device=dev))
    q = 0.5 * (t + t.transpose(1, 2))                            # (B, N, N)
    diag = torch.diagonal(q, dim1=1, dim2=2)
    rows = torch.arange(b, device=dev)
    iota = torch.arange(n, device=dev)
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    s = torch.zeros((b, n), dtype=torch.bool, device=dev)
    r = torch.zeros((b, n), dtype=torch.float32, device=dev)
    for _ in range(m):
        gain = torch.where(avail & ~s, diag + 2.0 * r, neg)
        k = torch.argmax(gain, -1)
        ok = gain[rows, k] > NEG / 2
        s = s | ((iota[None] == k[:, None]) & ok[:, None])
        r = r + torch.where(ok[:, None], q[rows, k], 0.0)
    for _ in range(sweeps):
        out_t = -2.0 * r + diag
        in_t = 2.0 * r + diag
        delta = (out_t[:, :, None] + in_t[:, None, :]) - 2.0 * q
        keep = s[:, :, None] & (~s & avail)[:, None, :]
        flat = torch.where(keep, delta, neg).reshape(b, -1)
        best_at = torch.argmax(flat, -1)
        best = flat[rows, best_at]
        i, j = best_at // n, best_at % n
        s2 = (s & (iota[None] != i[:, None])) | (iota[None] == j[:, None])
        r2 = r - q[rows, i] + q[rows, j]
        swap = (best > SWAP_TOL)[:, None]
        s = torch.where(swap, s2, s)
        r = torch.where(swap, r2, r)
    return s


def uniform_sets(avail: torch.Tensor, sampler_seeds, t: int,
                 m: int) -> torch.Tensor:
    """(B, N) bool: the top m of the round's Gumbel noise among A_t."""
    b, n = avail.shape
    u = torch.stack([torch.rand((n,), generator=stream((seed, t),
                                                       avail.device),
                                device=avail.device, dtype=torch.float32)
                     for seed in sampler_seeds])
    g = -torch.log(-torch.log(u))
    score = torch.where(avail, g, torch.full_like(g, -float("inf")))
    idx = torch.topk(score, m, dim=-1).indices
    return torch.zeros_like(avail).scatter(1, idx, torch.gather(avail, 1,
                                                                idx))


def slots(s: torch.Tensor, m: int):
    """(B, M) slot clients: the selected ascending, then the unselected
    ascending as zero-weight pads; and which slots are real."""
    n = s.shape[-1]
    iota = torch.arange(n, device=s.device)
    order = torch.argsort(torch.where(s, iota, n + iota), dim=-1)
    sel = order[:, :m]
    return sel, torch.gather(s, 1, sel)


# ------------------------------------------------------ training and eval
def _mm(a, b, tf32):
    return torch.matmul(round_tf32(a), round_tf32(b)) if tf32 else \
        torch.matmul(a, b)


def local_sgd(w, bias, x, y, clients, idx, lr, classes, tf32):
    """E SGD steps; w (R, d, C), bias (R, C) for the R rows' ``clients``
    of x (N, n_max, d), y (N, n_max), their rows idx (R, E, B).
    Cross-entropy of softmax(x w + b), mean over B."""
    rows = clients[:, None]
    for e in range(idx.shape[1]):
        xb, yb = x[rows, idx[:, e]], y[rows, idx[:, e]]
        logits = _mm(xb, w, tf32) + bias[:, None, :]
        g = torch.softmax(logits, -1)
        g = g - torch.nn.functional.one_hot(yb, classes).to(g.dtype)
        g = g / xb.shape[1]
        w = w - lr * _mm(xb.transpose(1, 2), g, tf32)
        bias = bias - lr * g.sum(1)
    return w, bias


def val_loss(w, bias, xv, yv, tf32):
    logits = _mm(xv[None], w, tf32) + bias[:, None, :]
    lse = torch.logsumexp(logits, -1)
    picked = torch.gather(logits, 2, yv[None, :, None].expand(
        w.shape[0], -1, 1))[..., 0]
    return (lse - picked).mean(-1)


@torch.no_grad()
def evaluate(data: dict, w, bias, device) -> np.ndarray:
    """(B,) val_loss of B given weights (the program's, to judge the loss
    it reported for them)."""
    dev = torch.device(device)
    xv = torch.as_tensor(data["x_val"], dtype=torch.float32, device=dev)
    yv = torch.as_tensor(data["y_val"], dtype=torch.int64, device=dev)
    return val_loss(torch.as_tensor(w, device=dev),
                    torch.as_tensor(bias, device=dev), xv, yv,
                    False).cpu().numpy()


# ------------------------------------------------------------------- sweep
def run(data: dict, cells: list[dict], *, rounds: int, m: int, sampler: str,
        alpha: float, sweeps: int, local_steps: int, batch_size: int,
        lr: float, lr_decay: float, eps: float, sigma2: float, device,
        ends=(), starts=None, tf32: bool = False) -> dict:
    """Every cell from round 0 for ``rounds`` rounds.  ``cells`` hold
    ``seed``, ``sampler_seed``, ``masks`` (T, N) bool and ``w0`` (d, C),
    ``b0`` (C,).  ``starts`` {t: (w (B, d, C), b (B, C))} restarts the
    weights at round t (the sets and counts run on); ``ends`` lists the
    rounds after which the weights are kept.  Returns H, the (B, T, N)
    sets, the (B, N) counts, the (B, T) val_loss and {t: (w, b)} at the
    ``ends``, as numpy."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _run(data, cells, rounds=rounds, m=m, sampler=sampler,
                    alpha=alpha, sweeps=sweeps, local_steps=local_steps,
                    batch_size=batch_size, lr=lr, lr_decay=lr_decay,
                    eps=eps, sigma2=sigma2, device=device, tf32=tf32,
                    ends=set(ends), starts=starts or {})
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


@torch.no_grad()
def _run(data, cells, *, rounds, m, sampler, alpha, sweeps, local_steps,
         batch_size, lr, lr_decay, eps, sigma2, device, tf32, ends, starts):
    dev = torch.device(device)
    classes = int(data["classes"])
    x = torch.as_tensor(data["x"], dtype=torch.float32, device=dev)
    y = torch.as_tensor(data["y"], dtype=torch.int64, device=dev)
    xv = torch.as_tensor(data["x_val"], dtype=torch.float32, device=dev)
    yv = torch.as_tensor(data["y_val"], dtype=torch.int64, device=dev)
    sizes = torch.as_tensor(np.asarray(data["sizes"]), dtype=torch.int64,
                            device=dev)
    b, n = len(cells), x.shape[0]
    h = build_h(torch.as_tensor(data["opt_params"], dtype=torch.float32,
                                device=dev), eps=eps, sigma2=sigma2,
                tf32=tf32) if sampler == "fedgs" else None
    masks = torch.as_tensor(np.stack([c["masks"][:rounds] for c in cells]),
                            dtype=torch.bool, device=dev)
    w = torch.as_tensor(np.stack([c["w0"] for c in cells]),
                        dtype=torch.float32, device=dev)
    bias = torch.as_tensor(np.stack([c["b0"] for c in cells]),
                           dtype=torch.float32, device=dev)
    counts = torch.zeros((b, n), dtype=torch.float32, device=dev)
    sets, losses, kept = [], [], {}
    for t in range(rounds):
        if t in starts:
            w = torch.as_tensor(starts[t][0], dtype=torch.float32, device=dev)
            bias = torch.as_tensor(starts[t][1], dtype=torch.float32,
                                   device=dev)
        avail = masks[:, t]
        if sampler == "fedgs":
            s = fedgs_sets(h, counts, avail, alpha=alpha, m=m, sweeps=sweeps)
        else:
            s = uniform_sets(avail, [c["sampler_seed"] for c in cells], t, m)
        sel, valid = slots(s, m)
        u = torch.cat([torch.rand((m, local_steps, batch_size),
                                  dtype=torch.float64,
                                  generator=stream((cell["seed"], t, 1), dev),
                                  device=dev) for cell in cells])
        flat = sel.reshape(-1)
        top = torch.clamp_min(sizes[flat].to(torch.float64), 1.0)
        idx = torch.minimum(torch.floor(u * top[:, None, None]).to(
            torch.int64), top.to(torch.int64)[:, None, None] - 1)
        rate = float(np.float32(lr * lr_decay ** t))
        lw, lb = local_sgd(w.repeat_interleave(m, 0),
                           bias.repeat_interleave(m, 0), x, y, flat,
                           idx, rate, classes, tf32)
        wt = sizes[sel].to(torch.float32) * valid.to(torch.float32)
        tot = wt.sum(1, keepdim=True)
        frac = wt / torch.clamp_min(tot, 1e-12)
        if tf32:
            frac, lw, lb = round_tf32(frac), round_tf32(lw), round_tf32(lb)
        new_w = torch.einsum("bm,bmdc->bdc", frac,
                             lw.reshape(b, m, *w.shape[1:]))
        new_b = torch.einsum("bm,bmc->bc", frac, lb.reshape(b, m, -1))
        fired = tot[:, 0] > 0
        w = torch.where(fired[:, None, None], new_w, w)
        bias = torch.where(fired[:, None], new_b, bias)
        counts = counts + s.to(torch.float32)
        sets.append(s)
        losses.append(val_loss(w, bias, xv, yv, tf32))
        if t + 1 in ends:
            kept[t + 1] = (w.cpu().numpy(), bias.cpu().numpy())
    return {"h": None if h is None else h.cpu().numpy(),
            "sets": torch.stack(sets, 1).cpu().numpy(),
            "counts": counts.cpu().numpy(),
            "val_loss": torch.stack(losses, 1).cpu().numpy(),
            "params": kept}
