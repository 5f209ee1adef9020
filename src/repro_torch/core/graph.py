"""3DG — the numpy face of the torch pipeline (the port of
``repro.core.graph``).  The graph math lives in
``repro_torch.core.graph_device``; this module keeps the host-side
conveniences: the similarity *sources*, numpy-in / numpy-out wrappers for
the engine and the graph-quality metric.  Every function that computes runs
on ``device``: CUDA unless the caller asks for the CPU (and raises when
there is no CUDA device and no ``device``).

Similarity sources:
  * ``oracle_similarity``        — true label-distribution / feature dot
                                   products
  * ``functional_similarity``    — Eq. 12: cosine of model outputs on a
                                   shared Gaussian probe batch
  * ``update_cosine_similarity`` — Eq. 11: cosine of raw model updates
  * ``repro_torch.core.sspp.secure_similarity_matrix`` — the dot products
                                   through the secure scalar product
                                   protocol (numpy; build its V with
                                   ``build_3dg(..., sim_kind="precomputed")``)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import graph_device as gd


def _tensor(a, device, who: str) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.float32),
                           device=resolve_device(device, who=who))


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


# ------------------------------------------------------------- similarities
def normalize_01(v: np.ndarray, *, device=None) -> np.ndarray:
    """Paper Appendix C: min-max normalize similarities to [0, 1]."""
    return _numpy(gd.minmax01(_tensor(v, device, "normalize_01")))


def oracle_similarity(features: np.ndarray, *, kind: str = "dot",
                      device=None) -> np.ndarray:
    """features (N, d): label-distribution vectors (or flat local-optimum
    params) -> normalized similarity."""
    u = _tensor(features, device, "oracle_similarity")
    v = gd.dot_sim(u) if kind == "dot" else gd.cosine_sim(u, clamp=False)
    return _numpy(gd.minmax01(v))


def update_cosine_similarity(updates: np.ndarray, *,
                             device=None) -> np.ndarray:
    """Eq. 11: V_ij = max(cos(Δθ_i, Δθ_j), 0).  updates (N, P) flattened."""
    return _numpy(gd.cosine_sim(_tensor(updates, device,
                                        "update_cosine_similarity")))


def functional_similarity(embeddings: np.ndarray, *,
                          device=None) -> np.ndarray:
    """Eq. 12: V_ij = max(cos(e_i, e_j), 0) where e_i = mean layer-l output
    of client i's model on the shared Gaussian probe batch."""
    return update_cosine_similarity(embeddings, device=device)


def probe_embeddings(embed_fn, client_params: dict,
                     probe: torch.Tensor) -> torch.Tensor:
    """Run each client model on the shared probe; mean output embedding.

    ``embed_fn(params, x)`` -> (M, B, dim) activations of the chosen layer
    (the output layer in the paper) for params stacked along a leading
    client axis (M, ...) and x (M, B, ...).  Returns (N, dim) on the
    params' device."""
    n = next(iter(client_params.values())).shape[0]
    x = probe.unsqueeze(0).expand(n, *probe.shape)
    with torch.no_grad():
        return torch.mean(embed_fn(client_params, x), dim=1)


# --------------------------------------------------------------- adjacency
def similarity_to_adjacency(v: np.ndarray, *, eps: float = 0.1,
                            sigma2: float = 0.01, device=None) -> np.ndarray:
    """Normalized V -> R per the paper (inf = no edge).  Diagonal is 0."""
    vn = _tensor(v, device, "similarity_to_adjacency")
    return _numpy(gd.to_adjacency(vn, eps=eps, sigma2=sigma2))


def shortest_paths(r: np.ndarray, *, device=None) -> np.ndarray:
    """APSP: the Floyd–Warshall kernel on CUDA, its plain version on the
    CPU (bitwise equal given the same R)."""
    return _numpy(gd.apsp(_tensor(r, device, "shortest_paths")))


def finite_cap(h: np.ndarray, scale: float = 2.0, *,
               device=None) -> np.ndarray:
    """Replace inf distances (disconnected pairs) with scale x max finite
    distance so the QUBO objective stays finite."""
    return _numpy(gd.cap_and_normalize(_tensor(h, device, "finite_cap"),
                                       scale=scale, normalize=False))


def build_3dg(features: np.ndarray, *, eps: float = 0.1, sigma2: float = 0.01,
              sim_kind: str = "dot", device=None):
    """features -> (V, R, H) as numpy (V the normalized similarity), built
    on ``device`` through the staged kernels.  ``sim_kind="precomputed"``
    takes a raw similarity (N, N) in place of the features."""
    cfg = gd.GraphConfig(eps=eps, sigma2=sigma2, similarity=sim_kind)
    v, r, h = gd.build_3dg(_tensor(features, device, "build_3dg"), cfg)
    return _numpy(v), _numpy(r), _numpy(h)


# --------------------------------------------------- graph-quality metrics
def edge_f1(r_pred: np.ndarray, r_true: np.ndarray) -> tuple[float, float, float]:
    """Precision/recall/F1 of predicted edges vs the oracle 3DG (Table 3)."""
    pred = np.isfinite(r_pred) & (~np.eye(len(r_pred), dtype=bool))
    true = np.isfinite(r_true) & (~np.eye(len(r_true), dtype=bool))
    tp = float(np.sum(pred & true))
    prec = tp / max(float(np.sum(pred)), 1e-12)
    rec = tp / max(float(np.sum(true)), 1e-12)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return prec, rec, f1
