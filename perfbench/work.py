"""The yardstick's arithmetic: the card's peaks and the work of the fit's
two kernels, counted from shapes.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W: 67
TFLOP/s in float32 outside the tensor cores, 3.35 TB/s of HBM3. The counts
follow the per-call bounds of the kernel table in ``PERF.md``: an E-step
row reads its d features and its weight once and does 8dK operations (the
matmul identity's two products, then the responsibility-weighted sums of x
and x²); a Lloyd-sweep row reads the same bytes and does 2dK + d. The
benchmark counts only the rows that hold data: padding is work a kernel
need not do.
"""
from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def estep_work(rows: float, d: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one E-step over ``rows`` rows."""
    return 8.0 * rows * d * k, rows * (d + 1) * 4.0


def sweep_work(rows: float, d: int, k: int) -> tuple[float, float]:
    """(operations, bytes) of one Lloyd sweep over ``rows`` rows."""
    return rows * (2.0 * d * k + d), rows * (d + 1) * 4.0


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the card could take for this work: the larger of its
    operations at the f32 peak and its bytes at the HBM peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S)
