"""Flat-npz checkpoints of nested trees (the port of
``repro.checkpoint.ckpt``), with a JSON metadata sidecar.

The format is the reference's, key for key, so either package reads the
other's files:
  * leaves under ``/``-joined key paths (a dict's keys as ``str``, a
    sequence's positions as ``0``, ``1``, ...);
  * bf16 leaves, which npz cannot hold, as their raw bits in uint16 under
    a ``%bf16``-suffixed key (torch's ``view(torch.int16)``; nothing here
    imports ``ml_dtypes``), loaded back as CPU ``torch.bfloat16`` tensors;
  * an EMPTY container ({} / [] / ()) under a ``%empty``-suffixed key whose
    int8 payload is its kind (0 dict, 1 list, 2 tuple), so structure
    without leaves survives.

Leaves may be torch tensors (read to host, one ``.cpu()`` each), numpy
arrays or scalars.  Files open with ``allow_pickle=False``: an object leaf
(``None``, say) cannot be written, so a caller maps it to an empty
container first.  ``load_checkpoint(path, like=...)`` rebuilds a template's
structure: int dict keys are looked up by their ``str``, a ``None`` in the
template comes back as ``None``, and a torch tensor in the template makes
the leaf a tensor of its dtype on its device.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

_EMPTY_KINDS = ({}, [], ())          # payload value indexes this tuple


def _bf16_bits(x) -> np.ndarray:
    """A bf16 tensor's or array's raw bits as a uint16 array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    return np.asarray(x).view(np.uint16)


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        if not tree:
            out[prefix[:-1] + "%empty"] = np.int8(0)
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        if not tree:
            out[prefix[:-1] + "%empty"] = np.int8(
                1 if isinstance(tree, list) else 2)
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, torch.Tensor) and tree.dtype == torch.bfloat16:
        out[prefix[:-1] + "%bf16"] = _bf16_bits(tree)
    elif isinstance(tree, torch.Tensor):
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    else:
        arr = np.asarray(tree)
        if arr.dtype == object:
            raise TypeError(f"checkpoint leaf {prefix[:-1]!r} is "
                            f"{type(tree).__name__}: an object leaf would "
                            f"need a pickle (map None to an empty "
                            f"container)")
        if arr.dtype.name == "bfloat16":
            out[prefix[:-1] + "%bf16"] = _bf16_bits(arr)
        else:
            out[prefix[:-1]] = arr
    return out


def _npz(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_checkpoint(path: str, tree, metadata: dict | None = None):
    """Write ``tree`` to ``path`` (``.npz`` appended if missing) and, with
    ``metadata``, a JSON sidecar beside it."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(_npz(path), **_flatten(tree))
    if metadata is not None:
        with open(os.path.splitext(path)[0] + ".json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def _bf16_tensor(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(bits).view(np.int16)).view(
        torch.bfloat16)


def load_checkpoint(path: str, like=None):
    """The nested dict of a checkpoint, or, with ``like`` (a template
    tree), that tree's structure with its dtypes (and, for tensor leaves,
    devices); a key the template has and the file lacks raises
    ``KeyError``, which callers read as an older format.  Without ``like``,
    numbered sequences come back as dicts keyed '0', '1', ... (the file
    records the kind of empty containers only)."""
    with np.load(_npz(path), allow_pickle=False) as z:
        flat, empties = {}, {}
        for k in z.files:
            if k.endswith("%bf16"):
                flat[k[:-len("%bf16")]] = _bf16_tensor(z[k])
            elif k.endswith("%empty"):
                empties[k[:-len("%empty")]] = int(z[k])
            else:
                flat[k] = z[k]
    if "" in empties:                # the whole tree is one empty container
        return type(_EMPTY_KINDS[empties[""]])()
    nested: dict = {}
    for k, v in flat.items():
        cur = nested
        parts = k.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = v
    for k, kind in empties.items():
        cur = nested
        parts = k.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = type(_EMPTY_KINDS[kind])()
    if like is None:
        return nested

    def rebuild(template, node):
        if template is None:
            return None
        if isinstance(template, dict):
            return {k: rebuild(v, node[str(k)]) for k, v in template.items()}
        if isinstance(template, (list, tuple)):
            vals = [rebuild(t, node[str(i)]) for i, t in enumerate(template)]
            return type(template)(vals)
        if isinstance(template, torch.Tensor):
            return torch.as_tensor(node).to(device=template.device,
                                            dtype=template.dtype)
        if isinstance(node, torch.Tensor):          # a bf16 leaf
            if getattr(template, "dtype", None) is not None and \
                    np.dtype(template.dtype).name == "bfloat16":
                return node.view(torch.int16).numpy().view(template.dtype)
            node = node.to(torch.float32).numpy()
        arr = np.asarray(node)
        return arr.astype(template.dtype) if hasattr(template, "dtype") \
            else arr

    return rebuild(like, nested)
