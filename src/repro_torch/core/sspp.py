"""Secure Scalar Product Protocol (Du & Zhan 2002; paper Appendix D, Alg. 2).

Computes A·B between two clients' private feature vectors with the server as
the commodity/relay party.  The server never sees A or B — only masked
vectors and the blinded partial results v1, v2 whose sum is the product.

This is a faithful *simulation* of the message flow (all parties in-process);
the point is that the values visible to the server are exactly the protocol's
messages, which we assert leak nothing beyond the final dot product (see
tests/test_sspp.py for the reconstruction-infeasibility property check).

A verbatim numpy copy of ``repro.core.sspp``: the port keeps its own copy so
it imports nothing of the JAX package, and the same inputs and seed give
the same numbers in both packages.
"""
from __future__ import annotations

import numpy as np


class _Client:
    def __init__(self, feature: np.ndarray):
        self._u = np.asarray(feature, np.float64)   # private

    # --- protocol steps (only masked data leaves the client) -------------
    def mask(self, r: np.ndarray) -> np.ndarray:
        return self._u + r

    def partial_b(self, a_hat: np.ndarray, r_b: float, rng) -> tuple[float, float]:
        v2 = float(rng.normal(scale=10.0))
        u = float(a_hat @ self._u) + r_b - v2
        return u, v2

    def partial_a(self, u: float, r_a: float, ra_vec: np.ndarray,
                  b_hat: np.ndarray) -> float:
        return u - float(ra_vec @ b_hat) + r_a


def secure_dot(feat_a: np.ndarray, feat_b: np.ndarray, *, seed: int = 0,
               transcript: list | None = None) -> float:
    """Run the protocol between two clients; returns A·B.

    ``transcript`` (if given) collects every value the *server* observes, for
    leakage analysis in tests.
    """
    rng = np.random.default_rng(seed)
    a, b = _Client(feat_a), _Client(feat_b)
    d = len(feat_a)

    # 1. server (commodity role) generates correlated randomness
    ra_vec = rng.normal(size=d)
    rb_vec = rng.normal(size=d)
    r_a = float(rng.normal())
    r_b = float(ra_vec @ rb_vec) - r_a

    # 2-3. clients mask and upload
    a_hat = a.mask(ra_vec)
    b_hat = b.mask(rb_vec)

    # 4-7. blinded partials relayed via the server
    u, v2 = b.partial_b(a_hat, r_b, rng)
    v1 = a.partial_a(u, r_a, ra_vec, b_hat)

    if transcript is not None:
        transcript.extend([a_hat.copy(), b_hat.copy(), u, v1, v2])

    # 8. server combines
    return v1 + v2


def secure_similarity_matrix(features: np.ndarray, *, seed: int = 0) -> np.ndarray:
    """All-pairs dot-product similarity via SSPP (upper triangle runs the
    protocol; result is exact up to float error)."""
    feats = np.asarray(features, np.float64)
    n = len(feats)
    v = np.zeros((n, n))
    for i in range(n):
        v[i, i] = float(feats[i] @ feats[i])    # self-similarity is local
        for j in range(i + 1, n):
            v[i, j] = v[j, i] = secure_dot(feats[i], feats[j],
                                           seed=seed * 1_000_003 + i * n + j)
    return v
