"""The yardstick's work counts give the kernel table's bounds (PERF.md,
"Every Pallas kernel of the repo, and its port"): ``estep_stats`` 0.01259
ms and ``kmeans_sweep_stats`` 0.00437 ms for one call at 20 clients of
7,320 rows, d = 24, K = 30 (the table counts padded rows; the benchmark
hands the count only the rows that carry weight)."""
import pytest

from perfbench import work

ROWS = 20 * 7320


def test_estep_bound():
    flops, nbytes = work.estep_work(ROWS, 24, 30)
    assert work.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        0.01259, abs=5e-6)
    assert flops / work.PEAK_F32_FLOPS > nbytes / work.PEAK_BYTES_PER_S


def test_sweep_bound():
    flops, nbytes = work.sweep_work(ROWS, 24, 30)
    assert work.least_seconds(flops, nbytes) * 1e3 == pytest.approx(
        0.00437, abs=5e-6)
    assert nbytes / work.PEAK_BYTES_PER_S > flops / work.PEAK_F32_FLOPS
