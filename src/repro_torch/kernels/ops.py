"""Public wrappers around the kernels (the port of ``repro.kernels.ops``).

Same signatures and return conventions as the reference, minus its tile
and autotune knobs.  Each call dispatches on the tensor's device: a CUDA
tensor launches the hand-written kernel (or raises), a CPU tensor takes the
kernel's plain version.  There is no fallback from one to the other.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import aggregate as _ag
from repro_torch.kernels import floyd_warshall as _fw
from repro_torch.kernels import graph_fused as _gf
from repro_torch.kernels import krum as _kr
from repro_torch.kernels import pairwise_similarity as _ps
from repro_torch.kernels import solver as _sv
from repro_torch.kernels import window_attention as _wa

# name -> Kernel (each with its ``launches`` count), in main-path order
KERNELS = {
    "pairwise_similarity": _ps.SIM_KERNEL,
    "adjacency": _ps.ADJ_KERNEL,
    "fused_adjacency": _gf.KERNEL,
    "floyd_warshall": _fw.KERNEL,
    "greedy_argmax": _sv.ARGMAX_KERNEL,
    "swap_best_fused": _sv.SWAP_FUSED_KERNEL,
    "greedy_cells": _sv.ARGMAX_CELLS_KERNEL,
    "swap_cells": _sv.SWAP_CELLS_KERNEL,
    "swap_best": _sv.SWAP_GAIN_KERNEL,
    "memagg": _ag.KERNEL,
    "krum": _kr.KERNEL,
    "window_attention": _wa.KERNEL,
}


def reset_launches() -> None:
    for k in KERNELS.values():
        k.launches = 0


# the cell axis's kernels do a per-step kernel's work for every cell of a
# batch: a launch counts under its own name and under that kernel's
STANDS_FOR = {"greedy_cells": "greedy_argmax", "swap_cells": "swap_best_fused"}


def launches() -> dict[str, int]:
    out = {name: k.launches for name, k in KERNELS.items()}
    for name, per_step in STANDS_FOR.items():
        out[per_step] += out[name]
    return out


# ------------------------------------------------------------------- APSP
def floyd_warshall(h: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths of an (N, N) f32 adjacency (inf = no edge,
    0 diagonal, no negative entry)."""
    return _fw.floyd_warshall(h)


# ------------------------------------------------- similarity -> adjacency
def pairwise_similarity(u: torch.Tensor) -> torch.Tensor:
    """V = U Uᵀ for (N, d) features.  Returns (N, N) float32."""
    return _ps.similarity(u)


def similarity_to_adjacency(v: torch.Tensor, *, eps: float,
                            sigma2: float) -> torch.Tensor:
    """Raw similarity v (N, N) -> 3DG adjacency R: min-max normalize with
    lo/hi reduced from v on its device, 0 on the diagonal, exp(−Vn/σ²)
    where Vn ≥ eps, inf elsewhere."""
    v = v.to(torch.float32)
    stats = torch.stack([torch.min(v), torch.max(v)])
    return _ps.adjacency(v, stats, eps=eps, sigma2=sigma2)


def build_3dg_kernel(u: torch.Tensor, *, eps: float = 0.1,
                     sigma2: float = 0.01):
    """The STAGED kernel route: features -> V -> R -> H, one kernel per
    stage (V and R go through device memory).  Returns (V, R, H_raw);
    R is bitwise :func:`build_3dg_fused`'s."""
    v = pairwise_similarity(u)
    r = similarity_to_adjacency(v, eps=eps, sigma2=sigma2)
    return v, r, floyd_warshall(r)


def fused_adjacency(u: torch.Tensor, *, eps: float, sigma2: float,
                    clamp: bool = False) -> torch.Tensor:
    """Features u (N, d) -> 3DG adjacency R (N, N) in one fused kernel: V =
    U·Uᵀ (``clamp`` adds Eq. 11/12's max(·, 0)), min-max normalize, R = 0 on
    the diagonal, exp(−Vn/σ²) where Vn ≥ eps, inf elsewhere.  V never
    exists in device memory.  Row-normalize u beforehand for cosine."""
    return _gf.fused_adjacency(u, eps=eps, sigma2=sigma2, clamp=clamp)[0]


def build_3dg_fused(u: torch.Tensor, *, eps: float = 0.1,
                    sigma2: float = 0.01, clamp: bool = False):
    """The fused adjacency chained into Floyd–Warshall.  Returns
    (R (N, N), H_raw (N, N)); H_raw is uncapped (inf = disconnected)."""
    r = fused_adjacency(u, eps=eps, sigma2=sigma2, clamp=clamp)
    return r, floyd_warshall(r)


# ------------------------------------------------------------ FedGS solver
def greedy_argmax(diag: torch.Tensor, r: torch.Tensor, mask: torch.Tensor,
                  taken: torch.Tensor | None = None):
    """Masked argmax of the greedy gain ``diag + 2r`` over (N,): a lane is
    addable where ``mask`` is True and ``taken`` (when given: the clients
    already selected) is False, read by the kernel itself.  Returns 0-dim
    (best gain, index); all masked -> (−1e18, 0)."""
    return _sv.masked_argmax(diag, r, mask, taken)


def swap_best_fused(h: torch.Tensor, z: torch.Tensor, scale: float,
                    sel: torch.Tensor, valid: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor):
    """Q-free best swap: h (N, N), z (N,), scale = alpha/N, sel (M,) global
    row indices already clamped into range, valid (M,) real rows, a (M,) /
    b (N,) out/in-gain terms carrying the −1e18 sentinel.  Returns 0-dim
    (best delta, panel rank, column j)."""
    return _sv.swap_best_fused(h, z, scale, sel, valid, a, b)


def greedy_cells(h: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                 avail: torch.Tensor, s: torch.Tensor, r: torch.Tensor, *,
                 first: bool) -> None:
    """One greedy step of B FedGS cells at once, in place on their state s
    (B, N) bool and r (B, N) f32: h (N, N) shared or (B, N, N), z (B, N),
    scale (B,) alpha/N, avail (B, N); ``first`` starts the solve (s and r
    read as zero).  Each row is the per-step greedy step's bit for bit."""
    _sv.greedy_cells(h, z, scale, avail, s, r, first=first)


def swap_cells(h: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
               avail: torch.Tensor, s: torch.Tensor, r: torch.Tensor,
               m: int) -> None:
    """One best-swap sweep of B FedGS cells at once over their m-row panels,
    in place on s and r (arguments as :func:`greedy_cells`)."""
    _sv.swap_cells(h, z, scale, avail, s, r, m)


def swap_best(q: torch.Tensor, sel: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor):
    """Best swap over the selected rows of a MATERIALIZED Q: q (N, N), sel
    (M,) row indices already clamped into range, a (M,) / b (N,) out/in-gain
    terms carrying the −1e18 sentinel.  The kernel reads Q[sel] in place
    (the reference takes the gathered (M, N) panel; the winner is the
    same).  Returns 0-dim (best delta, panel rank, column j)."""
    return _sv.swap_gain(q, sel, a, b)


# --------------------------------------------------- robust server update
def memory_aggregate(mem: torch.Tensor, upd: torch.Tensor, sel: torch.Tensor,
                     valid: torch.Tensor, w: torch.Tensor):
    """The memory family's panel update, IN PLACE on ``mem``: rows
    ``sel[k]`` of the (N, P) panel take the (M, P) updates where ``valid``,
    then red = w · panel over the (N,) normalized weights.  Returns
    ``(mem, red (P,))``; the panel is bitwise the plain scatter's."""
    return _ag.memory_aggregate(mem, upd, sel, valid, w)


def krum_distances(x: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances D[i, j] = ‖x_i‖² + ‖x_j‖² − 2 x_i·x_j over
    the (m, P) flat update matrix.  The expansion can go slightly negative
    for near-identical rows; the Krum selection clamps at 0."""
    return _kr.krum_distances(x)


# -------------------------------------------------------- window attention
def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     window: int) -> torch.Tensor:
    """Causal sliding-window attention: q (B, S, Hq, D), k/v (B, S, Hkv, D)
    with Hkv dividing Hq (query head h reads KV head h // (Hq/Hkv)); query i
    attends to keys i − window < j ≤ i.  Returns (B, S, Hq, D) in q's dtype.
    Any S: the ragged edge is masked, nothing is padded."""
    return _wa.window_attention(q, k, v, window=window)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Full causal attention: the sliding-window kernel with window = S."""
    return window_attention(q, k, v, window=q.shape[1])
