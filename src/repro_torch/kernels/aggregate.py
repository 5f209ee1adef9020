"""The memory aggregator's panel update: scatter the m sampled clients'
fresh updates into the (N, P) last-update panel, then reduce the panel with
the staleness weights, red = w · panel.

Replaces ``repro/kernels/aggregate.py`` ``_memagg_kernel`` /
``memagg_pallas`` with ``csrc/aggregate.cu``.  The TPU kernel's one-hot MXU
scatter becomes a direct row copy, so the panel is bitwise the plain
scatter's and a non-finite update entry lands in its own row only.  Each
block maps its rows to their slots itself and reads every row once, from
the updates where the row takes one and from the panel elsewhere, so the
copy and the sum proceed together.  The reduction sums in an order fixed by
the plan and the shape (each thread's rows ascending, then 8 row groups,
then, on the cluster plan, the slabs' sums), within f32 round-off of the
plain ``tensordot`` and bit-repeatable.  What bounds it on the card is
bytes (the panel once each way); at the main path's sizes, latency.

Plans (:func:`memagg_plan`, a pure function of the shape): ``small`` (one
launch over all N rows; up to :data:`SMALL_ROWS` rows) and ``cluster`` (N
cut into 2..16 slabs, the slabs of a column tile one thread block cluster
whose first block adds the others' sums through distributed shared
memory).  Neither keeps state outside its launch.  Both take any N: a
block's row map holds :data:`MAP_ROWS` rows, and a longer slab is taken in
windows of that many rows, in the same order.

Both versions update the panel IN PLACE (the aggregator state owns it, and
an (N, P) copy per round is what the in-place update saves): the tensor
passed as ``mem`` is the panel returned.  :func:`memory_aggregate` launches
the kernel for CUDA tensors and takes the plain version only for CPU
tensors.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import I, P, Kernel

KERNEL = Kernel("aggregate", "memagg_launch",
                [P, P, P, P, P, I, I, I, I, I, P, P])
PLANS = ("small", "cluster")                # csrc/aggregate.cu Mode
# the small plan up to this many rows (the crossover measured on an H100:
# chip_smoke.py's memagg plan rows)
SMALL_ROWS = 64
MAP_ROWS = 8192              # rows of one row map (csrc kMapRows)
CLUSTER_MOST = 16            # the cluster plan's slabs (blocks a cluster)
ROW_GROUPS = 8               # row groups per block (csrc kTY)
ROWS_IN_FLIGHT = 8           # rows a thread loads at once (csrc kU)


def memory_scatter_reduce_ref(mem: torch.Tensor, upd: torch.Tensor,
                              sel: torch.Tensor, valid: torch.Tensor,
                              w: torch.Tensor):
    """Plain version (the reference's ref backend): the masked row scatter
    ``mem[sel] = where(valid, upd, mem[sel])``, in place, then one
    (N,)·(N, P) tensordot.  As in the kernel, a slot whose row lies
    outside [0, N) is skipped (a silo rank's panel under ``psum`` gets
    the rows of other ranks' clients so).  Returns (mem, red (P,))."""
    take = valid & (sel >= 0) & (sel < mem.shape[0])
    keep = torch.nonzero(take).squeeze(1)
    mem[sel[keep]] = upd[keep]
    return mem, torch.tensordot(w, mem, dims=([0], [0]))


def memagg_plan(n: int, p: int, m: int) -> str:
    """The plan memory_aggregate_cuda takes for an (n, p) panel and m
    updates: the plan table's winner for the (n, p) tier where one is
    recorded (``autotune.resolve``; both plans take any n from 2), else
    :func:`memagg_heuristic`'s."""
    return autotune.resolve(
        "memory_aggregate", {"plan": memagg_heuristic(n, p, m)},
        takes=lambda q: q in memagg_plans(n, p, m), n=n, p=p)["plan"]


def memagg_heuristic(n: int, p: int, m: int) -> str:
    """``small`` (one launch, one block per column tile over all n rows)
    up to :data:`SMALL_ROWS` rows, ``cluster`` beyond."""
    return "small" if n <= SMALL_ROWS else "cluster"


def memagg_plans(n: int, p: int, m: int) -> list[str]:
    """Every plan that takes the shape when forced: ``small`` any n,
    ``cluster`` from 2 rows."""
    return ["small", "cluster"] if n >= 2 else ["small"]


def memagg_slab(n: int, p: int, plan: str) -> int:
    """Rows of one block.  ``small``: all n.  ``cluster``: n cut into as
    many slabs (2 to :data:`CLUSTER_MOST`) as give each thread one batch of
    :data:`ROWS_IN_FLIGHT` rows."""
    if plan == "small":
        return max(n, 1)
    batch = ROW_GROUPS * ROWS_IN_FLIGHT
    return -(-n // min(CLUSTER_MOST, max(2, -(-n // batch))))


def _why(mem, upd, sel, valid, w) -> str:
    """What memory_aggregate_cuda does not take, for its error message."""
    if mem.dim() != 2:
        return f"mem is {mem.dim()}-D"
    n, p = mem.shape
    m = sel.shape[0] if sel.dim() == 1 else -1
    for name, t, dtype, shape in (("mem", mem, torch.float32, (n, p)),
                                  ("upd", upd, torch.float32, (m, p)),
                                  ("sel", sel, torch.int64, (m,)),
                                  ("valid", valid, torch.bool, (m,)),
                                  ("w", w, torch.float32, (n,))):
        if not t.is_cuda:
            return f"{name} is on {t.device}, not CUDA"
        if t.device != mem.device:
            return f"{name} is on {t.device}, mem on {mem.device}"
        if t.dtype != dtype or tuple(t.shape) != shape or \
                not t.is_contiguous():
            return (f"{name} must be a contiguous {dtype} {shape}, got a "
                    f"{'' if t.is_contiguous() else 'strided '}"
                    f"{t.dtype} {tuple(t.shape)}")
    return "unsupported inputs"


# (n, p, plan asked for, None for the planned one) -> (plan index, slab)
_geometry: dict[tuple[int, int, str | None], tuple[int, int]] = {}


def memory_aggregate_cuda(mem, upd, sel, valid, w, *,
                          plan: str | None = None):
    """The CUDA kernel, in place on ``mem``: mem (N, P) f32, upd (M, P) f32,
    sel (M,) int64 rows, valid (M,) bool (False slots and rows outside
    [0, N) are skipped), w (N,) f32, all contiguous on one CUDA device.
    Returns (mem, red (P,)).  ``plan`` forces one of :data:`PLANS` that
    takes the shape (:func:`memagg_plans`), to time them against each
    other; None takes :func:`memagg_plan`'s.  The memory family calls it
    once a round, so its host path is short: one combined test of the
    inputs (the message is built only when it fails), no device context
    when the panel's device is the current one, the stream asked for by
    device index, the output by ``new_empty``."""
    dev = mem.get_device()
    shape = mem.shape
    m = sel.shape[0] if sel.dim() == 1 else -1
    if not (dev >= 0 and len(shape) == 2 and upd.get_device() == dev and
            sel.get_device() == dev and valid.get_device() == dev and
            w.get_device() == dev and mem.dtype == torch.float32 and
            upd.dtype == torch.float32 and sel.dtype == torch.int64 and
            valid.dtype == torch.bool and w.dtype == torch.float32 and
            upd.shape == (m, shape[1]) and valid.shape == (m,) and
            w.shape == (shape[0],) and mem.is_contiguous() and
            upd.is_contiguous() and sel.is_contiguous() and
            valid.is_contiguous() and w.is_contiguous()):
        raise ValueError("memory_aggregate_cuda: " +
                         _why(mem, upd, sel, valid, w))
    n, p = shape
    red = mem.new_empty(p)
    if p == 0:
        return mem, red
    geo = _geometry.get((n, p, plan))
    if geo is None:
        q = plan or memagg_plan(n, p, m)
        if q not in memagg_plans(n, p, m):
            raise ValueError(f"memory_aggregate_cuda: plan {q!r} does not "
                             f"take {n} rows")
        geo = _geometry[n, p, plan] = (PLANS.index(q), memagg_slab(n, p, q))
    if dev != torch.cuda.current_device():
        with torch.cuda.device(dev):
            return memory_aggregate_cuda(mem, upd, sel, valid, w, plan=plan)
    KERNEL(mem.data_ptr(), upd.data_ptr(), sel.data_ptr(), valid.data_ptr(),
           w.data_ptr(), n, p, m, *geo, red.data_ptr(),
           torch.cuda.current_stream(dev).cuda_stream)
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
