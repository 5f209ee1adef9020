"""Feed-forward blocks (the port of ``repro.models.ffn``): the SwiGLU /
squared-ReLU dense FFN, and the token-choice MoE.

The MoE keeps the reference's sort-based fixed-capacity dispatch: the
tokens' top-k expert choices are flattened, sorted by expert id (stable),
placed into an (E, C) capacity buffer (an entry past its expert's
capacity is dropped), run through the grouped products ``ecd,edf->ecf``,
then combined back weighted by the router's gates.  What the port does
about the card:

* **Ties.** ``torch.topk`` on CUDA does not promise the lowest index among
  equal values, and ``jax.lax.top_k`` does: the choice is a stable
  descending sort, which keeps equal probabilities in index order.
* **A deterministic combine.** The reference adds each token's K
  contributions with a scatter-add in the sorted order, so in ascending
  expert id, from zero.  A CUDA ``index_add_`` uses atomics, which sum in
  an order of their own on each run.  Here each token's K sorted positions
  form a (T, K) table (ascending), and the combine gathers them and adds
  them in that order.  The dispatch's gather of the tokens (each token read
  K times) has the combine as its adjoint, so its backward sums the same
  way: a train step repeats bit for bit.
* **Drops.** A dropped entry reads an extra zero row (the buffer's and the
  experts' outputs' row E·C), not an out-of-range slot.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.sharding.ctx import current_ctx


# ---------------------------------------------------------------- dense FFN
def init_ffn(gen: torch.Generator, d_model: int, d_ff: int, kind: str,
             dtype: torch.dtype) -> dict[str, torch.Tensor]:
    p = {"w_in": dense_init(gen, d_model, d_ff, dtype),
         "w_out": dense_init(gen, d_ff, d_model, dtype)}
    if kind == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, dtype)
    return p


def apply_ffn(p: dict[str, torch.Tensor], x: torch.Tensor,
              kind: str) -> torch.Tensor:
    h = x @ p["w_in"]
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif kind == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(kind)
    return h @ p["w_out"]


# ---------------------------------------------------------------- MoE
def init_moe(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             kind: str, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """The router (f32) and (E, ...) stacks of per-expert matrices, each
    drawn as ``dense_init``."""
    def fresh(a, b):
        return torch.stack([dense_init(gen, a, b, dtype)
                            for _ in range(n_experts)])

    p = {"router": dense_init(gen, d_model, n_experts, torch.float32),
         "w_in": fresh(d_model, d_ff), "w_out": fresh(d_ff, d_model)}
    if kind == "swiglu":
        p["w_gate"] = fresh(d_model, d_ff)
    return p


def moe_capacity(n_tokens: int, n_experts: int, top_k: int,
                 factor: float) -> int:
    c = int(n_tokens * top_k * factor / n_experts)
    return max(8, ((c + 7) // 8) * 8)


# Dispatch groups: 1 = the global sort dispatch.  G > 1 runs the dispatch
# independently on G contiguous token groups, each with capacity/G; -1 is
# one group per dp shard: the installed ShardCtx's dp size (1 outside one).
MOE_GROUPS = 1


class _GatherRows(torch.autograd.Function):
    """y = x[rows] (R, d) from x (T, d), where ``table`` (T, K) lists, for
    each row of x, the K positions of ``rows`` that read it, ascending.
    The backward sums each row's K gradients in the table's order
    (:class:`_SumRows`), with no atomics."""

    @staticmethod
    def forward(ctx, x, rows, table):
        ctx.save_for_backward(rows, table)
        return x[rows]

    @staticmethod
    def backward(ctx, g):
        rows, table = ctx.saved_tensors
        return _SumRows.apply(g, table, rows), None, None


class _SumRows(torch.autograd.Function):
    """out[t] = 0 + c[table[t, 0]] + c[table[t, 1]] + ... (T, d), in the
    table's order; the adjoint of :class:`_GatherRows` (its backward is
    the gather ``g[rows]``)."""

    @staticmethod
    def forward(ctx, c, table, rows):
        ctx.save_for_backward(rows, table)
        out = torch.zeros((table.shape[0], c.shape[1]), dtype=c.dtype,
                          device=c.device)
        for j in range(table.shape[1]):
            out = out + c[table[:, j]]
        return out

    @staticmethod
    def backward(ctx, g):
        rows, table = ctx.saved_tensors
        return _GatherRows.apply(g, rows, table), None, None


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, the lowest
    index first among equal values (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_group(xt, probs, gate, choice, p, *, cap: int, top_k: int,
                    kind: str):
    """Sort-based fixed-capacity dispatch for one token group.  xt (T, d);
    probs (T, E); gate/choice (T, K).  Returns (out (T, d), aux)."""
    t, d = xt.shape
    e = p["w_in"].shape[0]
    tk = t * top_k
    dev = xt.device
    flat_expert = choice.reshape(-1)                            # (T·K,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(top_k)
    flat_gate = gate.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    se, st, sg = flat_expert[order], flat_token[order], flat_gate[order]
    # position within expert segment via searchsorted on the sorted ids
    starts = torch.searchsorted(se, torch.arange(e, device=dev))
    iota = torch.arange(tk, device=dev)
    pos_in_e = iota - starts[se]
    keep = pos_in_e < cap
    # an overflow entry takes slot E·C: the zero row
    slot = torch.where(keep, se * cap + pos_in_e, e * cap)
    # each token's K sorted positions, ascending (= ascending expert id)
    where = torch.empty_like(order)
    where[order] = iota
    table = torch.sort(where.reshape(t, top_k), dim=1).values

    xs = _GatherRows.apply(xt, st, table)                       # xt[st]
    # the buffer's slots -> sorted entries, the empty ones -> a zero row;
    # an overflow entry writes a slot of its own past E·C, cut off after
    # (one scatter of distinct indices: shape-static, no boolean index)
    src = torch.full((e * cap + tk,), tk, dtype=torch.int64, device=dev)
    src.scatter_(0, torch.where(keep, slot, e * cap + iota), iota)
    src = src[:e * cap]
    zero = xt.new_zeros((1, d))
    buf = torch.cat([xs, zero])[src].reshape(e, cap, d)

    h = torch.bmm(buf, p["w_in"])
    if kind == "swiglu":
        h = F.silu(torch.bmm(buf, p["w_gate"])) * h
    else:
        h = torch.square(F.relu(h))
    out_e = torch.bmm(h, p["w_out"]).reshape(e * cap, d)

    contrib = torch.cat([out_e, zero])[slot] * \
        (sg * keep).to(xt.dtype)[:, None]
    out = _SumRows.apply(contrib, table, st)

    # load-balance auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)
    ce = torch.mean(F.one_hot(choice[:, 0], e).to(torch.float32), dim=0)
    aux = e * torch.sum(me * ce)
    return out, aux


def apply_moe(p, x, *, top_k: int, capacity_factor: float, kind: str):
    """x (B, S, d) -> (out (B, S, d), aux load-balance loss).  With
    MOE_GROUPS = G > 1 the dispatch runs independently on G contiguous
    token groups, each with capacity/G."""
    b, s, d = x.shape
    t = b * s
    g = MOE_GROUPS
    if g == -1:                       # auto: one group per data shard
        ctx = current_ctx()
        g = ctx.dp_size if ctx is not None else 1
    if g < 1 or t % g != 0:
        g = 1
    e = p["w_in"].shape[0]
    cap = moe_capacity(t // g, e, top_k, capacity_factor)

    xt = x.reshape(g, t // g, d)
    logits = xt.to(torch.float32) @ p["router"]                 # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    gate, choice = _top_k(probs, top_k)                         # (G, Tg, K)
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)

    outs, auxs = [], []
    for i in range(g):
        o, a = _dispatch_group(xt[i], probs[i], gate[i], choice[i], p,
                               cap=cap, top_k=top_k, kind=kind)
        outs.append(o)
        auxs.append(a)
    return torch.stack(outs).reshape(b, s, d), torch.mean(torch.stack(auxs))
