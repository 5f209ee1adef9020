"""The 3DG pipeline (the port of ``repro.core.graph_device``).

    features U (N, d)
       │  dot_sim / cosine_sim            similarity source (Eq. 11/12)
       ▼
    similarity V (N, N)
       │  minmax01                        Appendix C [0, 1] normalization
       ▼
    normalized similarity Vn
       │  to_adjacency(eps, sigma2)       R_ij = exp(-Vn/σ²) | inf, diag 0
       ▼
    adjacency R (inf = no edge)
       │  apsp                            Floyd–Warshall shortest paths
       ▼
    distance matrix H (inf = disconnected)
       │  cap_and_normalize(scale)        finite cap + [0, 1] scale (Eq. 16 prep)
       ▼
    normalized H — what FedGS's QUBO consumes

Every stage is float32 on the input's device.  The similarity and the
adjacency are the staged kernels (``kernels/ops.pairwise_similarity`` and
``similarity_to_adjacency``) and APSP is the Floyd–Warshall kernel: on CUDA
they launch the hand-written kernels, on the CPU their plain versions run.
:func:`build_3dg` is staged on every device and returns Vn, as the
reference's ``backend="pallas"`` does.  :func:`build_h` takes the fused
kernel for a feature similarity (``kernels/ops.build_3dg_fused``:
similarity, stats and adjacency in one kernel, V never in device memory)
and the staged route for ``similarity="precomputed"``.  Both sum V in the
same op order (``kernels/ref.similarity_ref``), so the fused R is bitwise
the staged R.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.kernels import ops

# similarity sources: "dot" = U Uᵀ (oracle features), "cosine" = row-normalized
# dot (oracle kind="cosine"), "functional" = max(cos, 0) (Eq. 11/12),
# "precomputed" = input already is V
SIMILARITIES = ("dot", "cosine", "functional", "precomputed")


@dataclass(frozen=True)
class GraphConfig:
    """3DG build configuration."""
    eps: float = 0.1               # edge threshold on normalized similarity
    sigma2: float = 0.01           # paper's σ² in exp(-V/σ²)
    finite_cap_scale: float = 2.0  # disconnected pairs ↦ scale × max finite
    normalize: bool = True         # scale H to [0, 1] (DESIGN.md assumption #1)
    similarity: str = "dot"

    def __post_init__(self):
        if self.similarity not in SIMILARITIES:
            raise ValueError(f"similarity must be one of {SIMILARITIES}, "
                             f"not {self.similarity!r}")


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    # a 0-dim tensor on the operand's device: CUDA divides by it with IEEE
    # division, where a Python scalar divisor becomes a multiply by its
    # reciprocal (one bit off)
    return torch.full((), x, dtype=like.dtype, device=like.device)


# ------------------------------------------------------------------- stages
def dot_sim(u: torch.Tensor) -> torch.Tensor:
    """V = U Uᵀ: the similarity kernel on CUDA, its plain version (the same
    op order) on the CPU."""
    return ops.pairwise_similarity(u)


def _row_normalize(u: torch.Tensor) -> torch.Tensor:
    return u / torch.clamp_min(torch.linalg.vector_norm(u, dim=-1,
                                                        keepdim=True), 1e-12)


def cosine_sim(u: torch.Tensor, *, clamp: bool = True) -> torch.Tensor:
    """Row-normalized similarity; ``clamp`` gives Eq. 11/12's max(cos, 0)."""
    v = dot_sim(_row_normalize(u))
    return torch.clamp_min(v, 0.0) if clamp else v


def minmax01(v: torch.Tensor) -> torch.Tensor:
    """Min-max normalize similarities to [0, 1] (paper Appendix C)."""
    lo, hi = torch.min(v), torch.max(v)
    return (v - lo) / torch.clamp_min(hi - lo, 1e-12)


def to_adjacency(vn: torch.Tensor, *, eps: float = 0.1,
                 sigma2: float = 0.01) -> torch.Tensor:
    """Normalized similarity -> 3DG adjacency (inf = no edge, diag 0).

    The diagonal is set with ``where(eye, 0, ...)`` — never by multiplying
    with ``1 - eye``, which turns an inf no-edge entry into ``inf·0 = NaN``
    whenever a row's normalized self-similarity falls below eps."""
    n = vn.shape[-1]
    eye = torch.eye(n, dtype=torch.bool, device=vn.device)
    r = torch.where(vn >= eps, torch.exp(-vn / _scalar(sigma2, vn)),
                    torch.full_like(vn, float("inf")))
    return torch.where(eye, torch.zeros_like(r), r)


def apsp(r: torch.Tensor) -> torch.Tensor:
    """All-pairs shortest paths of the (N, N) adjacency: the Floyd–Warshall
    kernel on CUDA, its plain version on the CPU."""
    return ops.floyd_warshall(r.to(torch.float32))


def cap_and_normalize(h: torch.Tensor, *, scale: float = 2.0,
                      normalize: bool = True) -> torch.Tensor:
    """Replace inf distances (disconnected pairs) with scale × max finite
    distance, then optionally scale to [0, 1] by the true max, however tiny
    (DESIGN.md assumption log #1)."""
    finite = torch.isfinite(h)
    ninf = torch.full_like(h, float("-inf"))
    mx = torch.max(torch.where(finite, h, ninf))
    cap = scale * torch.where(torch.isfinite(mx), mx, torch.ones_like(mx))
    eye = torch.eye(h.shape[-1], dtype=torch.bool, device=h.device)
    out = torch.where(eye, torch.zeros_like(h),
                      torch.where(finite, h, cap.expand_as(h)))
    if normalize:
        hmax = torch.max(out)
        out = out / torch.where(hmax > 0, hmax, torch.ones_like(hmax))
    return out


# ----------------------------------------------------------------- pipeline
def _features(u: torch.Tensor, cfg: GraphConfig) -> torch.Tensor:
    u = u.to(torch.float32)
    return _row_normalize(u) if cfg.similarity in ("cosine",
                                                    "functional") else u


def _similarity(u_or_v: torch.Tensor, cfg: GraphConfig) -> torch.Tensor:
    if cfg.similarity == "precomputed":
        return u_or_v.to(torch.float32)
    v = dot_sim(_features(u_or_v, cfg))
    return torch.clamp_min(v, 0.0) if cfg.similarity == "functional" else v


def build_3dg(u_or_v: torch.Tensor, cfg: GraphConfig = GraphConfig()):
    """Features (N, d) — or raw similarity (N, N) with
    ``similarity="precomputed"`` — to ``(Vn, R, H_raw)``: the normalized
    similarity, the adjacency and the *uncapped* shortest-path matrix
    (inf = disconnected), on the input's device through the staged
    kernels."""
    v = _similarity(u_or_v, cfg)
    r = ops.similarity_to_adjacency(v, eps=cfg.eps, sigma2=cfg.sigma2)
    return minmax01(v), r, apsp(r)


def build_h(u_or_v: torch.Tensor, cfg: GraphConfig = GraphConfig()):
    """The one-call 3DG constructor: features (or similarity) -> finite,
    [0, 1]-normalized H, ready for ``fedgs_select``.  A feature similarity
    goes through the fused kernel; ``"precomputed"`` (V given, no
    features) through the staged route."""
    if cfg.similarity == "precomputed":
        _, _, h = build_3dg(u_or_v, cfg)
    else:
        _, h = ops.build_3dg_fused(_features(u_or_v, cfg), eps=cfg.eps,
                                   sigma2=cfg.sigma2,
                                   clamp=cfg.similarity == "functional")
    return cap_and_normalize(h, scale=cfg.finite_cap_scale,
                             normalize=cfg.normalize)
