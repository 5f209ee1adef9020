"""The paper's seven client-availability modes (FedGS, Table 1) as
probability tables, and the Bernoulli masks drawn from them.

The formulas are a frozen copy of the program's (``p_k(t)`` per mode; a
test holds the tables equal).  The draw is the benchmark's own: one numpy
generator per cell, all rounds at once, so set-up stays short at any
round count.  A round whose draw leaves every client out turns one on,
drawn uniformly (the program's force-one floor).

  IDL 1;  MDF n_k^b / max n^b (b 0.7);  LDF n_k^-b / max n^-b (b 0.7);
  YMF b min_i y_ki / max y + (1 - b) (b 0.9);
  YC  b 1[some label of k in the phase's band] + (1 - b) (b 0.9, T 20);
  LN  c_k / max c, c ~ LogNormal(0, ln 1/(1-b)) (b 0.5);
  SLN clip(p^LN (0.4 sin(2 pi (1 + t mod T) / T) + 0.5), 0, 1) (T 20)
"""
from __future__ import annotations

import numpy as np

MODES = ("IDL", "MDF", "LDF", "YMF", "YC", "LN", "SLN")


def probs_table(name: str, *, sizes, label_sets, num_labels: int = 10,
                seed: int = 0, period: int = 20) -> np.ndarray:
    """(period, N) float64 table: ``p(t) = table[t % period]``."""
    n = len(sizes)
    ns = np.asarray(sizes, float)
    if name == "IDL":
        return np.ones((1, n))
    if name == "MDF":
        return (ns ** 0.7 / np.max(ns ** 0.7))[None]
    if name == "LDF":
        inv = ns ** (-0.7)
        return (inv / np.max(inv))[None]
    if name == "YMF":
        gmax = max(max(s) for s in label_sets)
        beta = 0.9
        return np.array([beta * min(s) / max(gmax, 1) + (1 - beta)
                         for s in label_sets])[None]
    if name == "YC":
        beta, rows = 0.9, []
        for t in range(period):
            phase = (1 + t) / period
            rows.append([beta * float(any(
                y / num_labels <= phase and (phase < (y + 1) / num_labels
                                             or y + 1 == num_labels)
                for y in s)) + (1 - beta) for s in label_sets])
        return np.asarray(rows)
    if name in ("LN", "SLN"):
        rng = np.random.default_rng(seed)
        c = rng.lognormal(0.0, np.log(1.0 / 0.5), n)
        p = c / c.max()
        if name == "LN":
            return p[None]
        t = np.arange(period)[:, None]
        mod = 0.4 * np.sin(2 * np.pi * (1 + t) / period) + 0.5
        return np.clip(p[None] * mod, 0.0, 1.0)
    raise ValueError(f"unknown availability mode {name!r}")


def draw_masks(table: np.ndarray, rounds: int,
               rng: np.random.Generator) -> np.ndarray:
    """(rounds, N) bool masks, round t Bernoulli(table[t % period])."""
    period, n = table.shape
    p = table[np.arange(rounds) % period]
    masks = rng.random((rounds, n)) < p
    empty = np.flatnonzero(~masks.any(1))
    masks[empty, rng.integers(n, size=len(empty))] = True
    return masks
