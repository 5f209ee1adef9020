"""Faults planted underneath the timed path, to show that the comparison
deciding ``correct`` catches them (``tests/test_perfbench_faults.py`` on
the CPU; ``calibrate.py --fault-seeds`` on the card at the cell's size).
Each is a context manager that patches the program in this process and
restores it on exit."""
from __future__ import annotations

from contextlib import contextmanager


@contextmanager
def _patched(owner, name, new):
    old = getattr(owner, name)
    setattr(owner, name, new)
    try:
        yield
    finally:
        setattr(owner, name, old)


def state_unchanged():
    """Every round's server update is dropped: the carry keeps its weights."""
    from repro_torch.fed import scan_engine
    orig = scan_engine.ScanEngine._round

    def stuck(self, plan, carry, t):
        before = carry["params"]
        out = orig(self, plan, carry, t)
        carry["params"] = before
        return out

    return _patched(scan_engine.ScanEngine, "_round", stuck)


def half_batch():
    """FedAvg over the first half of each cell's slots only (the mean taken
    over the rest)."""
    import torch
    from repro_torch.fed import scan_engine
    orig = scan_engine.fedavg_cells

    def half(stacked, weights, prev):
        keep = torch.arange(weights.shape[-1], device=weights.device) < \
            weights.shape[-1] // 2
        return orig(stacked, weights * keep.to(weights), prev)

    return _patched(scan_engine, "fedavg_cells", half)


def altered_answer(call: int = 3):
    """The ``call``-th round's first cell selects another client in place of
    its first selected one."""
    import torch
    from repro_torch.fed import scan_engine
    orig = scan_engine.select_k
    calls = []

    def altered(s, k):
        calls.append(1)
        if len(calls) == call:
            s = s.clone()
            free = torch.nonzero(~s[0])
            if len(free):
                s[0, int(torch.nonzero(s[0])[0])] = False
                s[0, int(free[0])] = True
        return orig(s, k)

    return _patched(scan_engine, "select_k", altered)


@contextmanager
def _after_first_round(update):
    """The server update replaced by ``update(fedavg_cells, stacked,
    weights, prev)`` in every round of a segment but its first.  The round's
    eval reads the weights the replaced update gave, so the val_loss the
    program reports stays that of the weights it carries."""
    from repro_torch.fed import scan_engine
    eng, orig = scan_engine.ScanEngine, scan_engine.fedavg_cells
    seg, rnd = eng._segment, eng._round
    at = {}

    def segment(self, plan, carry, t0, seg_len):
        at["t0"] = t0
        return seg(self, plan, carry, t0, seg_len)

    def round_(self, plan, carry, t):
        at["t"] = t
        return rnd(self, plan, carry, t)

    def fedavg(stacked, weights, prev):
        if at["t"] > at["t0"]:
            return update(orig, stacked, weights, prev)
        return orig(stacked, weights, prev)

    with _patched(eng, "_segment", segment), _patched(eng, "_round", round_), \
            _patched(scan_engine, "fedavg_cells", fedavg):
        yield


def state_unchanged_late():
    """After a segment's first round, the server update returns the weights
    it was given: the carry stops advancing, its eval consistent."""
    return _after_first_round(lambda orig, stacked, weights, prev: prev)


def half_batch_late():
    """After a segment's first round, FedAvg over the first half of each
    cell's slots only."""
    import torch

    def half(orig, stacked, weights, prev):
        keep = torch.arange(weights.shape[-1], device=weights.device) < \
            weights.shape[-1] // 2
        return orig(stacked, weights * keep.to(weights), prev)

    return _after_first_round(half)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer,
          "state_unchanged_late": state_unchanged_late,
          "half_batch_late": half_batch_late}
