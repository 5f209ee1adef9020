"""Small utilities over the port's params (the port of
``repro.utils.tree``).

The port's params are flat dicts of tensors under dotted keys
(``blocks.attn.wq``); the functions also take nested dicts, lists and
tuples of tensors, the layout the reference's pytrees have.  The key path
handed to ``map_with_path``'s function is the reference's: a tuple of the
nested keys, a dotted key split at its dots.
"""
from __future__ import annotations

import math

import torch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def param_count(tree) -> int:
    """Total number of scalar parameters."""
    return sum(math.prod(x.shape) for x in _leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes of the leaves (tensors or anything with shape and a
    torch dtype)."""
    return sum(math.prod(x.shape) * x.dtype.itemsize for x in _leaves(tree))


def map_with_path(fn, tree, _path: tuple = ()):
    """Map ``fn(path, leaf)`` over the leaves, ``path`` the tuple of keys
    (a dotted key split at its dots, a sequence's positions as strings);
    returns the same structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, _path + tuple(str(k).split(".")))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, _path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(_path, tree)


def _map(fn, *trees):
    head = trees[0]
    if isinstance(head, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in head}
    if isinstance(head, (list, tuple)):
        return type(head)(_map(fn, *parts) for parts in zip(*trees))
    return fn(*trees)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares (the
    leaves' sums added in order, as the reference's Python ``sum``)."""
    total = 0
    for x in _leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def tree_add(a, b, scale_b=1.0):
    return _map(lambda x, y: x + scale_b * y, a, b)


def tree_scale(a, s):
    return _map(lambda x: x * s, a)


def tree_zeros_like(a):
    return _map(torch.zeros_like, a)
