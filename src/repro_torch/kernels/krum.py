"""The Krum aggregator's pairwise squared-distance panel
D[i, j] = ‖x_i‖² + ‖x_j‖² − 2 x_i·x_j over the (m, P) flat update matrix.

Replaces ``repro/kernels/krum.py`` ``_krum_kernel`` / ``krum_pallas`` with
``csrc/krum.cu``, in IEEE f32 on the CUDA cores (never TF32), with the
epilogue ``(n_i + n_j) − 2g`` in the plain version's op order and no float
atomics, so a call repeats bit for bit.  Two plans, chosen in C from (m, P)
(:func:`krum_plan`):

* ``small`` (the main path's (6, 610), up to m = 210 there, and few pairs of
  rows up to P = 8,192): one launch and no scratch, one warp per upper pair
  i ≤ j folding x_i·x_i, x_j·x_j and x_i·x_j in one pass;
* ``split``: the Gram by the similarity's 32×32 tiles (``csrc/tile32.cuh``,
  here by FMA) with P split over blocks until the card fills, the partials
  in scratch, then a second launch that adds them in ascending order and
  applies the epilogue with n_i taken from the same sum of the Gram's
  diagonal.

Either way D is exactly symmetric with a zero diagonal, and agrees with the
plain version to f32 round-off (the sums over P run in another order); what
Krum decides from it, the chosen rows, is held bitwise.  What bounds it on
the card is the m·(m+1)·P operations of the symmetric Gram; at the main
path's m = 6, one launch.

:func:`krum_distances` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import autotune
from repro_torch.kernels._build import I, P, Kernel, library, stream_of

KERNEL = Kernel("krum", "krum_distances_launch", [P, I, I, I, P, P, P])
PLANS = ("small", "split")


def krum_pairwise_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version, the reference's op order:
    ``n2[:, None] + n2[None, :] − 2.0 · (x @ xᵀ)``."""
    x = x.to(torch.float32)
    n2 = torch.sum(x * x, dim=1)
    return n2[:, None] + n2[None, :] - 2.0 * (x @ x.T)


def krum_distances_cuda(x: torch.Tensor, *, plan: str | None = None
                        ) -> torch.Tensor:
    """The CUDA kernel: x (m, P) contiguous f32 on the card -> D (m, m).
    ``plan`` forces ``"small"`` or ``"split"`` (to time the two against each
    other); None takes :func:`krum_plan`'s."""
    if not x.is_cuda or x.dim() != 2:
        raise ValueError(f"krum_distances_cuda takes a 2-D CUDA tensor, got "
                         f"{x.dim()}-D on {x.device}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"krum_distances_cuda takes a contiguous float32 "
                         f"matrix, got {x.dtype}"
                         f"{'' if x.is_contiguous() else ' (strided)'}")
    m, p = x.shape
    d = torch.empty((m, m), dtype=torch.float32, device=x.device)
    if m == 0:
        return d
    if p == 0:
        return d.zero_()
    with torch.cuda.device(x.device):
        kind, nbytes = _plan(m, p, x.device.index, plan)
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=x.device) \
            if nbytes else None
        KERNEL(x.data_ptr(), m, p, kind,
               None if scratch is None else scratch.data_ptr(), d.data_ptr(),
               stream_of(x))
    return d


def krum_heuristic(m: int, p: int) -> str:
    """The plan the C heuristic picks for (m, P) (``krum_plan_kind``)."""
    fn = library("krum").krum_plan_kind
    fn.argtypes, fn.restype = [I, I], ctypes.c_int
    return PLANS[fn(m, p)]


def krum_plan(m: int, p: int) -> str:
    """The plan krum_distances_cuda takes for (m, P) on the current
    device: the plan table's winner for the (m, P) tier where it takes the
    shape (``autotune.resolve``), else the heuristic
    (``krum_plan_kind``)."""
    return PLANS[_plan(m, p, torch.cuda.current_device(), None)[0]]


_plans: dict[tuple, tuple[int, int]] = {}


def _plan(m: int, p: int, device_index, plan: str | None) -> tuple[int, int]:
    """The kernel's plan for (m, P), or the one forced, and its scratch
    bytes on the device (they depend on the SM count), asked and resolved
    once."""
    key = (m, p, device_index, plan)
    if key not in _plans:
        nbytes = library("krum").krum_scratch_bytes
        nbytes.argtypes, nbytes.restype = [I, I, I], ctypes.c_longlong
        if plan is None:
            plan = autotune.resolve(
                "krum_pairwise", {"plan": krum_heuristic(m, p)},
                takes=lambda q: autotune.krum_takes(q, m, p), m=m,
                p=p)["plan"]
        kind = PLANS.index(plan)
        _plans[key] = (kind, int(nbytes(m, p, kind)))
    return _plans[key]


def krum_distances(x: torch.Tensor) -> torch.Tensor:
    """Dispatch on the tensor's device: CUDA launches the kernel, CPU takes
    the plain version."""
    if x.is_cuda:
        return krum_distances_cuda(x)
    if x.device.type != "cpu":
        raise ValueError(f"krum_distances: no kernel for {x.device}")
    return krum_pairwise_ref(x)
