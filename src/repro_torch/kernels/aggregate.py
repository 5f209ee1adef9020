"""The memory aggregator's panel update: scatter the m sampled clients'
fresh updates into the (N, P) last-update panel, then reduce the panel with
the staleness weights, red = w · panel.

Replaces ``repro/kernels/aggregate.py`` ``_memagg_kernel`` /
``memagg_pallas`` with ``csrc/aggregate.cu``.  The TPU kernel's one-hot MXU
scatter becomes a direct row copy, so the panel is bitwise the plain
scatter's and a non-finite update entry lands in its own row only; the
reduction sums in a fixed order (8 strided row groups per column, then the
groups ascending), within f32 round-off of the plain ``tensordot`` and
bit-repeatable.  What bounds it on the card is bytes (the panel once each
way); at the main path's sizes, launch latency.

Both versions update the panel IN PLACE (the aggregator state owns it, and
an (N, P) copy per round is what the in-place update saves): the tensor
passed as ``mem`` is the panel returned.  :func:`memory_aggregate` launches
the kernel for CUDA tensors and takes the plain version only for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._build import I, P, Kernel, stream_of

KERNEL = Kernel("aggregate", "memagg_launch", [P, P, P, P, P, I, I, I, P, P])


def memory_scatter_reduce_ref(mem: torch.Tensor, upd: torch.Tensor,
                              sel: torch.Tensor, valid: torch.Tensor,
                              w: torch.Tensor):
    """Plain version (the reference's ref backend): the masked row scatter
    ``mem[sel] = where(valid, upd, mem[sel])``, in place, then one
    (N,)·(N, P) tensordot.  Returns (mem, red (P,))."""
    mem[sel] = torch.where(valid[:, None], upd, mem[sel])
    return mem, torch.tensordot(w, mem, dims=([0], [0]))


def _check(name, t, dtype, shape):
    if not t.is_cuda:
        raise ValueError(f"memory_aggregate_cuda: {name} is on {t.device}, "
                         "not CUDA")
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"memory_aggregate_cuda: {name} must be a "
                         f"contiguous {dtype} {shape}, got a "
                         f"{'' if t.is_contiguous() else 'strided '}"
                         f"{t.dtype} {tuple(t.shape)}")


def memory_aggregate_cuda(mem, upd, sel, valid, w):
    """The CUDA kernel, in place on ``mem``: mem (N, P) f32, upd (M, P) f32,
    sel (M,) int64 rows, valid (M,) bool (False slots and rows outside
    [0, N) are skipped), w (N,) f32.  Returns (mem, red (P,))."""
    if mem.dim() != 2:
        raise ValueError(f"memory_aggregate_cuda: mem is {mem.dim()}-D")
    n, p = mem.shape
    m = upd.shape[0] if upd.dim() == 2 else -1
    _check("mem", mem, torch.float32, (n, p))
    _check("upd", upd, torch.float32, (m, p))
    _check("sel", sel, torch.int64, (m,))
    _check("valid", valid, torch.bool, (m,))
    _check("w", w, torch.float32, (n,))
    red = torch.empty(p, dtype=torch.float32, device=mem.device)
    if p == 0:
        return mem, red
    with torch.cuda.device(mem.device):
        KERNEL(mem.data_ptr(), upd.data_ptr(), sel.data_ptr(),
               valid.data_ptr(), w.data_ptr(), n, p, m, red.data_ptr(),
               stream_of(mem))
    return mem, red


def memory_aggregate(mem: torch.Tensor, upd: torch.Tensor, sel: torch.Tensor,
                     valid: torch.Tensor, w: torch.Tensor):
    """Dispatch on the panel's device: CUDA launches the kernel, CPU takes
    the plain version.  Both update ``mem`` in place."""
    if mem.is_cuda:
        return memory_aggregate_cuda(mem, upd, sel, valid, w)
    if mem.device.type != "cpu":
        raise ValueError(f"memory_aggregate: no kernel for {mem.device}")
    return memory_scatter_reduce_ref(mem, upd, sel, valid, w)
