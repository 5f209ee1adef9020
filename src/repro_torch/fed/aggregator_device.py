"""Eq. 18 FedAvg (the ``fedavg`` family of ``repro.fed.aggregator_device``).

Params are dicts of tensors; stacked params carry a leading client axis.
"""
from __future__ import annotations

import torch


def guard_zero_weight(avg: dict, prev: dict, total: torch.Tensor) -> dict:
    """Keep ``avg`` when any weight fired; fall back to the previous params
    on an all-zero round (assumption log #15)."""
    return {k: torch.where(total > 0, a, prev[k].to(a.dtype))
            for k, a in avg.items()}


def fedavg_combine(stacked_params: dict, weights: torch.Tensor,
                   prev_params: dict | None = None) -> dict:
    """``theta = sum_k w_k theta_k, w_k = n_k / sum n`` (Eq. 18).  With
    ``prev_params`` an all-zero-weight round returns the previous params."""
    total = torch.sum(weights)
    w = weights / torch.clamp_min(total, 1e-12)
    avg = {k: torch.tensordot(w.to(p.dtype), p, dims=([0], [0]))
           for k, p in stacked_params.items()}
    if prev_params is None:
        return avg
    return guard_zero_weight(avg, prev_params, total)
