"""Synthetic token streams for LM training (the port of
``repro.data.lm_stream``; numpy only, a copy held bitwise to the original).

A per-client order-1 Markov chain over the vocabulary gives each federated
client a distinct, *learnable* token distribution — the LM analogue of label
skew, so FedGS's 3DG has real structure to discover.
"""
from __future__ import annotations

import numpy as np


def client_transition(vocab: int, n_modes: int, rng, concentration: float = 0.3):
    """Sparse-ish row-stochastic transition with ``n_modes`` preferred targets
    per token (cheap to sample from)."""
    prefer = rng.integers(0, vocab, (vocab, n_modes))
    return prefer


def sample_stream(prefer: np.ndarray, length: int, rng,
                  p_follow: float = 0.85) -> np.ndarray:
    vocab, n_modes = prefer.shape
    out = np.empty(length, np.int32)
    tok = int(rng.integers(vocab))
    for i in range(length):
        out[i] = tok
        if rng.random() < p_follow:
            tok = int(prefer[tok, rng.integers(n_modes)])
        else:
            tok = int(rng.integers(vocab))
    return out


def token_batches(vocab: int, n_clients: int, tokens_per_client: int,
                  seq_len: int, seed: int = 0):
    """Returns tokens (N, n_seq, S+1) int32 — per-client sequence pools.
    batch = {tokens: seq[:, :-1], labels: seq[:, 1:]}."""
    rng = np.random.default_rng(seed)
    n_seq = tokens_per_client // (seq_len + 1)
    out = np.empty((n_clients, n_seq, seq_len + 1), np.int32)
    for k in range(n_clients):
        prefer = client_transition(vocab, n_modes=3, rng=rng)
        stream = sample_stream(prefer, n_seq * (seq_len + 1), rng)
        out[k] = stream.reshape(n_seq, seq_len + 1)
    return out
