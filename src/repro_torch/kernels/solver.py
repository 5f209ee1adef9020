"""Kernels of the FedGS Eq. 16 solver: the greedy masked argmax, the
Q-free best-swap reduction and the best swap over a dense Q, each beside
its plain version.

Replaces ``repro/kernels/solver.py`` ``_masked_argmax_kernel`` /
``masked_argmax_pallas``, ``_swap_fused_kernel`` (+ ``_best_swap_update``)
/ ``swap_gain_fused_pallas`` and ``_swap_gain_kernel`` /
``swap_gain_pallas`` with ``csrc/solver.cu``.  The TPU kernels carry
a running (best, index) pair across a sequential grid; the CUDA kernels
fold packed (value, ~index) keys by max instead, which keeps the largest
value and its LOWEST index in any block order — the reference's first-max
tie-break.  Both are tiny per call, so at the main path's sizes they are
bound by launch latency, and at large N by the bytes of the H panels the
swap reads.  The greedy argmax runs one warp with shuffles only up to
128 entries and one block beyond (``masked_argmax_plan``), and masks
``mask & ~taken`` itself, so the greedy step hands it A_t and S and
launches no mask op of its own.  The Q-free swap runs a panel of at most
2,048 entries (the quickstart's 6 × 30) in one block with no scratch and
no atomics, and a larger one in 32 × 64 tiles that meet through a 16-byte state kept per
stream (and per CUDA-graph capture), zeroed once when made and again by the
kernel's last block, so no call needs a memset (``swap_best_fused_plan``).
The dense swap has the same two kinds of path (``swap_gain_plan``): one
block for a small panel (the vision solve's 10 × 100), else a grid of at
most four blocks per SM reading Q's rows with 16-byte loads, meeting in the
same per-stream state, which the fused 3DG adjacency shares
(:func:`grid_state`).
Q = sym(a·H) − diag(z) is never built: ``q_diag``/``q_row``
rebuild what the greedy pass needs, and the swap kernel rebuilds each Q
entry from H where it is consumed, with no FMA contraction (the op order
of ``repro/kernels/solver.py:60-80``).  The dense swap serves
``fedgs_solve``, whose caller hands over Q itself: it reads the selected
rows of Q in place.

The cell axis (:func:`greedy_cells`, :func:`swap_cells`): one launch does a
greedy step, or a sweep, of every FedGS cell of a batch at once, a block a
cell, in place on the cells' (B, N) state s and r, with the step's glue
(diag(Q), Q's rows, the sorted set S, the swap itself) inside the kernel:
m + ``max_sweeps`` launches a batch round.  They take panels that fit the
swap's small path (:func:`solve_cells_takes`).

The wrappers launch the kernel for CUDA tensors and take the plain version
only for CPU tensors.  They return 0-dim tensors on the input's device and
never sync with the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import F, I, L, P, Kernel, library, stream_of

NEG = -1e18         # the solver's masked-entry sentinel

ARGMAX_KERNEL = Kernel("solver", "masked_argmax_launch",
                       [P, P, P, P, I, I, P, P, P])
ARGMAX_PLANS = ("warp", "block")
ARGMAX_WARP_MOST = 128         # csrc kArgmaxWarpMost: the warp plan's most
SWAP_FUSED_KERNEL = Kernel("solver", "swap_best_launch",
                           [P, P, F, P, P, P, P, I, I, I, P, P, P, P, P])
SWAP_FUSED_PLANS = ("small", "tiled")
SWAP_GAIN_KERNEL = Kernel("solver", "swap_gain_launch",
                          [P, P, P, P, I, I, I, P, P, P, P, P])
SWAP_GAIN_PLANS = ("small", "grid")
SWAP_GAIN_SMALL_MOST = 8192    # entries the small path takes when forced
# the batched solve's steps: one launch is one greedy step (one sweep) of
# every cell (``ops.launches`` counts it under the per-step kernel's name too)
ARGMAX_CELLS_KERNEL = Kernel("solver", "masked_argmax_cells_launch",
                             [P, L, P, P, P, P, P, I, I, I, P])
SWAP_CELLS_KERNEL = Kernel("solver", "swap_best_cells_launch",
                           [P, L, P, P, P, P, P, I, I, I, P])
SWAP_TOL = 1e-9     # == core/sampler_device.SWAP_TOL
SWAP_SMALL = 2048   # == csrc/solver.cu kSwapSmall: the small swap's panel


# ----------------------------------------------------- factored-Q providers
def q_diag(h: torch.Tensor, z: torch.Tensor, a: float) -> torch.Tensor:
    """diag(Q) for Q = sym(a·H) − diag(z), without building Q:
    ``0.5·((a·H_kk − z_k) + (a·H_kk − z_k))``, the reference's op order."""
    t = a * torch.diagonal(h) - z
    return 0.5 * (t + t)


def q_row(h: torch.Tensor, z: torch.Tensor, a: float,
          k: torch.Tensor) -> torch.Tensor:
    """Row k of Q = sym(a·H) − diag(z), rebuilt in the reference's op order
    (``0.5·((a·H_kj − δz_k) + (a·H_jk − δz_k))``).  ``k`` is a 0-dim index
    tensor, so no host sync."""
    n = h.shape[0]
    k1 = k.reshape(1)
    zk = torch.index_select(z, 0, k1)
    zc = torch.where(torch.arange(n, device=h.device) == k1, zk,
                     torch.zeros_like(zk))
    t1 = a * torch.index_select(h, 0, k1)[0] - zc
    t2 = a * torch.index_select(h, 1, k1)[:, 0] - zc
    return 0.5 * (t1 + t2)


# ----------------------------------------------------------- masked argmax
def masked_argmax_plain(diag, r, mask, taken=None):
    if taken is not None:
        mask = mask & ~taken
    gain = diag + 2.0 * r
    gain = torch.where(mask, gain, torch.full_like(gain, NEG))
    gain = torch.where(torch.isnan(gain), torch.full_like(gain, NEG), gain)
    idx = torch.argmax(gain)
    return gain[idx], idx


def masked_argmax_cuda(diag, r, mask, taken=None, *, plan: str | None = None):
    """The CUDA kernel; ``plan`` forces the ``"warp"`` or the ``"block"``
    path, to time the two against each other; None takes
    :func:`masked_argmax_plan`'s (resolved once per n; a call looks its
    index up in a dict).  The
    inputs must already be contiguous (N,) tensors on one CUDA device,
    diag and r float32, mask and taken bool.  The greedy step calls it m
    times a solve, so its host path is short: it converts nothing, asks for
    the stream by device index, allocates its outputs with ``new_empty``,
    and enters the device's context only when that device is not the
    current one."""
    dev = diag.get_device()
    if dev < 0 or r.get_device() != dev or mask.get_device() != dev or \
            (taken is not None and taken.get_device() != dev):
        raise ValueError("masked_argmax_cuda takes CUDA tensors on one "
                         "device")
    if diag.dtype != torch.float32 or r.dtype != torch.float32 or \
            mask.dtype != torch.bool or \
            (taken is not None and taken.dtype != torch.bool):
        raise TypeError("masked_argmax_cuda takes float32 diag and r, bool "
                        "mask and taken")
    n = diag.numel()
    if diag.dim() != 1 or r.dim() != 1 or mask.dim() != 1 or \
            r.numel() != n or mask.numel() != n or \
            (taken is not None and (taken.dim() != 1 or taken.numel() != n)):
        raise ValueError(f"shapes {tuple(diag.shape)}, {tuple(r.shape)}, "
                         f"{tuple(mask.shape)} are not all (N,)")
    if not (diag.is_contiguous() and r.is_contiguous() and
            mask.is_contiguous() and (taken is None or taken.is_contiguous())):
        raise ValueError("masked_argmax_cuda takes contiguous tensors")
    val = diag.new_empty(())
    idx = diag.new_empty((), dtype=torch.int64)
    if plan is None:
        kind = _argmax_kinds.get(n)
        if kind is None:
            kind = _argmax_kinds[n] = ARGMAX_PLANS.index(
                masked_argmax_plan(n))
    else:
        kind = ARGMAX_PLANS.index(plan)
    args = (diag.data_ptr(), r.data_ptr(), mask.data_ptr(),
            None if taken is None else taken.data_ptr(), n, kind,
            val.data_ptr(), idx.data_ptr())
    if dev == torch.cuda.current_device():
        ARGMAX_KERNEL(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            ARGMAX_KERNEL(*args, torch.cuda.current_stream(dev).cuda_stream)
    return val, idx


# n -> the greedy argmax's plan, and its index for the launch
_argmax_plans: dict[int, str] = {}
_argmax_kinds: dict[int, int] = {}


def masked_argmax_plan(n: int) -> str:
    """The path masked_argmax_cuda takes for n entries: ``warp`` (one warp,
    shuffles only) or ``block`` — the plan table's winner for n's tier
    where it takes n (``autotune.resolve``), else
    :func:`masked_argmax_heuristic`'s, resolved once."""
    if n not in _argmax_plans:
        _argmax_plans[n] = autotune.resolve(
            "greedy_argmax", {"plan": masked_argmax_heuristic(n)},
            takes=lambda q: autotune.argmax_takes(q, n), n=n)["plan"]
    return _argmax_plans[n]


def masked_argmax_heuristic(n: int) -> str:
    """The path the C heuristic picks for n (``masked_argmax_plan_kind``)."""
    fn = library("solver").masked_argmax_plan_kind
    fn.argtypes, fn.restype = [I], ctypes.c_int
    return ARGMAX_PLANS[fn(n)]


def masked_argmax_warp_most() -> int:
    """The most entries for which masked_argmax_cuda takes the warp path."""
    fn = library("solver").masked_argmax_warp_most
    fn.argtypes, fn.restype = [], ctypes.c_int
    return int(fn())


def masked_argmax(diag: torch.Tensor, r: torch.Tensor, mask: torch.Tensor,
                  taken: torch.Tensor | None = None):
    """Greedy gain ``diag + 2r`` masked (lane not addable, or NaN -> −1e18)
    and arg-maxed over (N,): returns (best gain, first index reaching it).
    A lane is addable where ``mask`` is True and ``taken`` (when given) is
    False: the greedy step passes A_t and S, and the kernel reads both.
    With every lane masked: (−1e18, 0), as the reference."""
    if diag.is_cuda:
        return masked_argmax_cuda(diag, r, mask, taken)
    if diag.device.type != "cpu":
        raise ValueError(f"masked_argmax: no kernel for {diag.device}")
    return masked_argmax_plain(diag, r, mask, taken)


# -------------------------------------------------------- Q-free swap sweep
def swap_best_fused_plain(h, z, scale: float, sel, valid, a, b):
    n = h.shape[0]
    hs = torch.index_select(h, 0, sel)                    # (M, N)
    hts = torch.index_select(h, 1, sel).T                 # (M, N)
    zsel = torch.where(valid, torch.index_select(z, 0, sel),
                       torch.zeros((), dtype=z.dtype, device=z.device))
    selcol = torch.where(valid, sel, torch.full_like(sel, -1))
    cols = torch.arange(n, device=h.device)
    zc = torch.where(selcol[:, None] == cols[None, :], zsel[:, None],
                     torch.zeros((), dtype=z.dtype, device=z.device))
    t1 = scale * hs - zc
    t2 = scale * hts - zc
    q = 0.5 * (t1 + t2)
    delta = (a[:, None] + b[None, :]) - 2.0 * q
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, NEG), delta)
    flat = torch.argmax(delta.reshape(-1))
    return delta.reshape(-1)[flat], flat // n, flat % n


def swap_best_fused_cuda(h, z, scale: float, sel, valid, a, b, *,
                         plan: str | None = None):
    """The CUDA kernel; ``plan`` forces the ``"small"`` (at most 4,096
    entries) or the ``"tiled"`` path, to time the two against each other;
    None takes :func:`swap_best_fused_plan`'s.  The tiled path's blocks meet
    in the state :func:`grid_state` keeps for the current stream."""
    n, m = h.shape[0], sel.shape[0]
    if not all(t.is_cuda for t in (h, z, sel, valid, a, b)):
        raise ValueError("swap_best_fused_cuda takes CUDA tensors")
    if h.shape != (n, n) or z.shape != (n,) or b.shape != (n,) \
            or valid.shape != (m,) or a.shape != (m,):
        raise ValueError("swap_best_fused_cuda: shapes do not match (N, N), "
                         "(N,), (M,)")
    if not 0 < m * n < 2 ** 31:
        raise ValueError(f"swap_best_fused_cuda: panel {m} x {n} out of "
                         "range")
    hh = h.to(torch.float32).contiguous()
    zz = z.to(torch.float32).contiguous()
    ss = sel.to(torch.int64).contiguous()
    vv = valid.to(torch.bool).contiguous()
    aa = a.to(torch.float32).contiguous()
    bb = b.to(torch.float32).contiguous()
    best = torch.empty((), dtype=torch.float32, device=h.device)
    rank = torch.empty((), dtype=torch.int64, device=h.device)
    j = torch.empty((), dtype=torch.int64, device=h.device)
    kind = SWAP_FUSED_PLANS.index(plan or swap_best_fused_plan(m, n))
    with torch.cuda.device(h.device):
        stream = stream_of(hh)
        state = grid_state(h.device, stream) if kind else None
        SWAP_FUSED_KERNEL(hh.data_ptr(), zz.data_ptr(), scale, ss.data_ptr(),
                          vv.data_ptr(), aa.data_ptr(), bb.data_ptr(), m, n,
                          kind, None if state is None else state.data_ptr(),
                          best.data_ptr(), rank.data_ptr(), j.data_ptr(),
                          stream)
    return best, rank, j


# (C function, m, n) -> plan name
_plans: dict[tuple[str, int, int], str] = {}


def _plan(symbol: str, names: tuple[str, ...], m: int, n: int) -> str:
    if (symbol, m, n) not in _plans:
        fn = getattr(library("solver"), symbol)
        fn.argtypes, fn.restype = [I, I], ctypes.c_int
        _plans[symbol, m, n] = names[fn(m, n)]
    return _plans[symbol, m, n]


def swap_best_fused_plan(m: int, n: int) -> str:
    """The path swap_best_fused_cuda takes for an (m, N) panel: ``small``
    (one block, one launch) or ``tiled``."""
    return _plan("swap_best_plan_kind", SWAP_FUSED_PLANS, m, n)


# (m, n) -> the dense swap's resolved plan
_gain_plans: dict[tuple[int, int], str] = {}


def swap_gain_plan(m: int, n: int) -> str:
    """The path swap_gain_cuda takes for an (m, N) panel: ``small`` (one
    block, one launch) or ``grid`` — the plan table's winner for the (m,
    N) tier where it takes the panel (``autotune.resolve``), else
    :func:`swap_gain_heuristic`'s, resolved once."""
    if (m, n) not in _gain_plans:
        _gain_plans[m, n] = autotune.resolve(
            "swap_gain", {"plan": swap_gain_heuristic(m, n)},
            takes=lambda q: autotune.swap_gain_takes(q, m, n), m=m,
            n=n)["plan"]
    return _gain_plans[m, n]


def swap_gain_heuristic(m: int, n: int) -> str:
    """The path the C heuristic picks for an (m, N) panel
    (``swap_gain_plan_kind``)."""
    return _plan("swap_gain_plan_kind", SWAP_GAIN_PLANS, m, n)


# (device index, stream, capture id or 0) -> the grid paths' state
_grid_states: dict[tuple[int, int, int], torch.Tensor] = {}


def _capture_id(stream: int) -> int:
    """The id of the CUDA-graph capture under way on ``stream``, else 0."""
    if not torch.cuda.is_current_stream_capturing():
        return 0
    fn = library("solver").stream_capture_id
    fn.argtypes, fn.restype = [P], ctypes.c_ulonglong
    return int(fn(stream))


def grid_state(device: torch.device, stream: int) -> torch.Tensor:
    """The 16-byte state in which the blocks of one launch meet, for this
    stream: (key, arrival count) for the Q-free swap's tiled path and the
    dense swap's grid path, (~lo key, hi key, arrival count) for the fused
    3DG adjacency's tile pass (``graph_fused``).  It is zeroed once when
    made, on the stream, and left zero by every launch's last block, so
    calls in stream order share it with no memset, while calls on other
    streams, which may overlap, each have their own.  The three kernels
    share it safely for the same reason: two launches on one stream never
    overlap, and each leaves it zero.  A
    CUDA-graph capture gets a state of its own, made in the graph's memory
    (its one zeroing is a node of that graph), so two graphs replayed at
    once never share one.  A stream holds one capture at a time: a new
    capture on it drops the entry of the one before, whose graph keeps its
    memory."""
    key = (device.index, stream, _capture_id(stream))
    state = _grid_states.get(key)
    if state is None:
        for k in [k for k in _grid_states if k[:2] == key[:2] and k[2]]:
            del _grid_states[k]
        state = torch.zeros(2, dtype=torch.int64, device=device)
        _grid_states[key] = state
    return state


def swap_best_fused(h: torch.Tensor, z: torch.Tensor, scale: float,
                    sel: torch.Tensor, valid: torch.Tensor, a: torch.Tensor,
                    b: torch.Tensor):
    """Q-free best swap over the selected rows: h (N, N), z (N,), ``scale``
    = alpha/N (a float32 value), sel (M,) row indices in range, valid (M,)
    real rows, a (M,) / b (N,) out/in-gain terms carrying −1e18 on invalid
    entries.  delta = (a_s + b_j) − 2·Q[sel_s, j], NaN -> −1e18; returns
    (best delta, rank s, column j) of the lowest flat index s·N + j
    reaching the max.  H need not be symmetric."""
    if h.is_cuda:
        return swap_best_fused_cuda(h, z, scale, sel, valid, a, b)
    if h.device.type != "cpu":
        raise ValueError(f"swap_best_fused: no kernel for {h.device}")
    return swap_best_fused_plain(h, z, scale, sel, valid, a, b)


# --------------------------------------------------------- dense swap sweep
def swap_gain_plain(q, sel, a, b):
    n = q.shape[1]
    qs = torch.index_select(q, 0, sel)                    # (M, N)
    delta = (a[:, None] + b[None, :]) - 2.0 * qs
    delta = torch.where(torch.isnan(delta), torch.full_like(delta, NEG), delta)
    flat = torch.argmax(delta.reshape(-1))
    return delta.reshape(-1)[flat], flat // n, flat % n


def swap_gain_cuda(q, sel, a, b, *, plan: str | None = None):
    """The CUDA kernel; ``plan`` forces the ``"small"`` (at most
    :data:`SWAP_GAIN_SMALL_MOST` entries) or the ``"grid"`` path, to time
    the two against each other; None takes :func:`swap_gain_plan`'s.  The
    grid path's blocks meet in the state :func:`grid_state` keeps for the
    current stream."""
    n, m = q.shape[0], sel.shape[0]
    if not all(t.is_cuda for t in (q, sel, a, b)):
        raise ValueError("swap_gain_cuda takes CUDA tensors")
    if q.shape != (n, n) or a.shape != (m,) or b.shape != (n,):
        raise ValueError("swap_gain_cuda: shapes do not match (N, N), (M,), "
                         "(M,), (N,)")
    if not 0 < m * n < 2 ** 31:
        raise ValueError(f"swap_gain_cuda: panel {m} x {n} out of range")
    qq = q.to(torch.float32).contiguous()
    ss = sel.to(torch.int64).contiguous()
    aa = a.to(torch.float32).contiguous()
    bb = b.to(torch.float32).contiguous()
    best = torch.empty((), dtype=torch.float32, device=q.device)
    rank = torch.empty((), dtype=torch.int64, device=q.device)
    j = torch.empty((), dtype=torch.int64, device=q.device)
    kind = SWAP_GAIN_PLANS.index(plan or swap_gain_plan(m, n))
    with torch.cuda.device(q.device):
        stream = stream_of(qq)
        state = grid_state(q.device, stream) if kind else None
        SWAP_GAIN_KERNEL(qq.data_ptr(), ss.data_ptr(), aa.data_ptr(),
                         bb.data_ptr(), m, n, kind,
                         None if state is None else state.data_ptr(),
                         best.data_ptr(), rank.data_ptr(), j.data_ptr(),
                         stream)
    return best, rank, j


def swap_gain(q: torch.Tensor, sel: torch.Tensor, a: torch.Tensor,
              b: torch.Tensor):
    """Best swap over the selected rows of a dense Q: q (N, N), sel (M,)
    row indices in range, a (M,) / b (N,) out/in-gain terms carrying −1e18
    on invalid entries.  delta = (a_s + b_j) − 2·Q[sel_s, j], NaN -> −1e18;
    returns (best delta, rank s, column j) of the lowest flat index
    s·N + j reaching the max."""
    if q.is_cuda:
        return swap_gain_cuda(q, sel, a, b)
    if q.device.type != "cpu":
        raise ValueError(f"swap_gain: no kernel for {q.device}")
    return swap_gain_plain(q, sel, a, b)


# ------------------------------------------------------------ the cell axis
# The batched FedGS solve's two steps over B cells at once, in place on the
# state s (B, N) bool and r (B, N) f32: h is one (N, N) H shared by every
# cell or a (B, N, N) stack, z (B, N) the count penalty, scale (B,) float32
# alpha/N.  Each equals, row by row, the per-step route of
# ``core/sampler_device._solve_kernel`` (q_diag, q_row, greedy_argmax,
# the sort of S and swap_best_fused) bit for bit.
def _q_rows(h, z, scale, k):
    """Row k[c] of each cell's Q = sym(a·H) − diag(z), q_row's op order."""
    b, n = z.shape
    hb, cells = h.expand(b, n, n), torch.arange(b, device=z.device)
    kc = k[:, None]
    zc = torch.where(torch.arange(n, device=z.device) == kc,
                     torch.gather(z, 1, kc), torch.zeros((), device=z.device))
    a = scale[:, None]
    return 0.5 * ((a * hb[cells, k] - zc) + (a * hb[cells, :, k] - zc))


def _q_diags(h, z, scale):
    """diag(Q) of each cell, q_diag's op order: (B, N)."""
    t = scale[:, None] * torch.diagonal(h, dim1=-2, dim2=-1) - z
    return 0.5 * (t + t)


def greedy_cells_plain(h, z, scale, avail, s, r, *, first: bool):
    if first:
        s.zero_()
        r.zero_()
    neg = torch.full((), NEG, dtype=torch.float32, device=z.device)
    gain = _q_diags(h, z, scale) + 2.0 * r
    gain = torch.where(avail & ~s, gain, neg)
    gain = torch.where(torch.isnan(gain), neg, gain)
    k = torch.argmax(gain, dim=1)
    ok = torch.gather(gain, 1, k[:, None]) > NEG / 2            # (B, 1)
    s |= (torch.arange(z.shape[1], device=z.device) == k[:, None]) & ok
    r += torch.where(ok, _q_rows(h, z, scale, k),
                     torch.zeros((), device=z.device))


def swap_cells_plain(h, z, scale, avail, s, r, m: int):
    b, n = z.shape
    dev = z.device
    neg = torch.full((), NEG, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    iota = torch.arange(n, device=dev)
    diag = _q_diags(h, z, scale)
    out_term = -2.0 * r + diag
    in_term = 2.0 * r + diag
    sel = torch.sort(torch.where(s, iota, n), dim=1).values[:, :m]
    valid = sel < n
    selc = torch.clamp_max(sel, n - 1)
    a = torch.where(valid, torch.gather(out_term, 1, selc), neg)
    bb = torch.where(~s & avail, in_term, neg)
    hb = h.expand(b, n, n)
    cells = torch.arange(b, device=dev)[:, None]
    hs = hb[cells, selc]                                        # (B, m, N)
    hts = hb[cells, :, selc]                                    # (B, m, N)
    zsel = torch.where(valid, torch.gather(z, 1, selc), zero)
    selcol = torch.where(valid, selc, torch.full_like(selc, -1))
    zc = torch.where(selcol[:, :, None] == iota, zsel[:, :, None], zero)
    sc = scale[:, None, None]
    q = 0.5 * ((sc * hs - zc) + (sc * hts - zc))
    delta = (a[:, :, None] + bb[:, None, :]) - 2.0 * q
    delta = torch.where(torch.isnan(delta), neg, delta).reshape(b, m * n)
    flat = torch.argmax(delta, dim=1)
    best = torch.gather(delta, 1, flat[:, None])[:, 0]
    rank, j = flat // n, flat % n
    i = torch.gather(selc, 1, torch.clamp_max(rank, m - 1)[:, None])[:, 0]
    swap = (best > SWAP_TOL)[:, None]
    s2 = (s & (iota != i[:, None])) | (iota == j[:, None])
    r2 = r - _q_rows(h, z, scale, i) + _q_rows(h, z, scale, j)
    s.copy_(torch.where(swap, s2, s))
    r.copy_(torch.where(swap, r2, r))


def _cells_args(h, z, scale, avail, s, r):
    b, n = z.shape
    if not all(t.is_cuda for t in (h, z, scale, avail, s, r)):
        raise ValueError("the cell-axis kernels take CUDA tensors")
    if h.dtype != torch.float32 or z.dtype != torch.float32 or \
            scale.dtype != torch.float32 or r.dtype != torch.float32 or \
            avail.dtype != torch.bool or s.dtype != torch.bool:
        raise TypeError("the cell-axis kernels take float32 h, z, scale and "
                        "r, bool avail and s")
    if h.shape not in ((n, n), (b, n, n)) or scale.shape != (b,) or \
            avail.shape != (b, n) or s.shape != (b, n) or r.shape != (b, n):
        raise ValueError("the cell-axis kernels take h (N, N) or (B, N, N), "
                         "z, avail, s, r (B, N) and scale (B,)")
    if not all(t.is_contiguous() for t in (h, z, scale, avail, s, r)):
        raise ValueError("the cell-axis kernels take contiguous tensors")
    return (h.data_ptr(), 0 if h.dim() == 2 else n * n, z.data_ptr(),
            scale.data_ptr(), avail.data_ptr(), s.data_ptr(), r.data_ptr(),
            b)


def _launch(kernel, device, args):
    dev = device.index
    if dev == torch.cuda.current_device():
        kernel(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:
        with torch.cuda.device(dev):
            kernel(*args, torch.cuda.current_stream(dev).cuda_stream)


def greedy_cells_cuda(h, z, scale, avail, s, r, *, first: bool):
    """One greedy step of every cell, one launch (``masked_argmax_cells_
    kernel``, a block a cell); ``first`` starts the solve: s and r are
    read as zero and written whole."""
    _launch(ARGMAX_CELLS_KERNEL, z.device,
            (*_cells_args(h, z, scale, avail, s, r), z.shape[1], int(first)))


def swap_cells_cuda(h, z, scale, avail, s, r, m: int):
    """One best-swap sweep of every cell over its m-row panel, one launch
    (``swap_best_cells_kernel``); :func:`solve_cells_takes` must hold."""
    _launch(SWAP_CELLS_KERNEL, z.device,
            (*_cells_args(h, z, scale, avail, s, r), m, z.shape[1]))


def solve_cells_takes(m: int, n: int) -> bool:
    """Whether the cell-axis kernels take an m-row panel over N clients: 1
    <= m <= N and m·N within the Q-free swap's ``small`` plan (one block;
    the C launchers' ``solve_cells_take``).  Elsewhere (fedsim's (416,
    4096)) the solve runs the per-step kernels cell by cell."""
    return 1 <= m <= n and m * n <= SWAP_SMALL


def greedy_cells(h, z, scale, avail, s, r, *, first: bool) -> None:
    """One greedy step of every cell, in place on s and r (the CUDA kernel
    for CUDA tensors, its plain version on the CPU)."""
    if z.is_cuda:
        return greedy_cells_cuda(h, z, scale, avail, s, r, first=first)
    if z.device.type != "cpu":
        raise ValueError(f"greedy_cells: no kernel for {z.device}")
    return greedy_cells_plain(h, z, scale, avail, s, r, first=first)


def swap_cells(h, z, scale, avail, s, r, m: int) -> None:
    """One best-swap sweep of every cell, in place on s and r."""
    if z.is_cuda:
        return swap_cells_cuda(h, z, scale, avail, s, r, m)
    if z.device.type != "cpu":
        raise ValueError(f"swap_cells: no kernel for {z.device}")
    return swap_cells_plain(h, z, scale, avail, s, r, m)
