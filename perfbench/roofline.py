"""Operations, bytes and bound times of the port's kernels, with one H100
SXM's published peaks (NVIDIA's data sheet, dense, at its 700 W limit).
Bytes count each input read once and each output written once.

A frozen copy of the formulas the port's kernel table states (PERF.md's
kernel table; ``chip_smoke.py``'s ``bound``), so a later change to the
program cannot move the yardstick.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12


def bound_s(nbytes: float, ops: float,
            peak: float = PEAK_F32_OPS_PER_S) -> float:
    """The least time the chip could take: bytes or operations."""
    return max(nbytes / PEAK_BYTES_PER_S, ops / peak)


def greedy_argmax(n: int) -> float:
    """B3 with A_t and S read by the kernel: diag, r (f32), the two masks,
    (value, index) written; 4 N operations."""
    return bound_s(n * (4 + 4 + 1 + 1) + 12, 4 * n)


def swap_best_fused(m: int, n: int) -> float:
    """B4: H's m selected rows and columns, z, a, b, sel, valid; three
    scalars out; 10 m N operations."""
    return bound_s(2 * 4 * m * n + 4 * n + 4 * m + 8 * m + m + 4 * m + 20,
                   10 * m * n)


def similarity(n: int, d: int) -> float:
    return bound_s(4 * (n * d + n * n), n * (n + 1) * d)


def floyd_warshall(n: int) -> float:
    return bound_s(8 * n * n, 2 * n ** 3)


def memagg(n: int, p: int, m: int) -> float:
    return bound_s(4 * (m * p + n * p + n + p) + 9 * m, 2 * n * p)


def share(ctx: dict, part: str, bound: float):
    """bound over the mean device time of the traced kernels whose name
    holds ``part``, in %; None where none ran."""
    durs = [(e - s) / 1e6 for name, s, e in ctx["trace"]["device"]
            if part in name]
    if not durs:
        return None
    return 100.0 * bound / (sum(durs) / len(durs))
