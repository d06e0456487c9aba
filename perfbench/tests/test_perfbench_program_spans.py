"""The harness's trace reader against the program's own spans
(``repro_torch.tracing``): with the span names among its labels,
``read_trace`` counts no span's marker on the device timeline as device
work, and still sees the fit's kernels. The cases need a card (``cuda``);
on one they run with

    PYTHONPATH=src python -m pytest -q -m cuda perfbench/tests/test_perfbench_program_spans.py
"""
import numpy as np
import pytest

from perfbench import harness

PATHS = ("fedgen", "dem")


def _split(rows: int = 20000, clients: int = 4, d: int = 8, k: int = 3):
    """A padded split drawn from one planted mixture; the last client is
    short, so padding exists."""
    from repro_torch.core.partition import ClientSplit
    rng = np.random.default_rng(7)
    mus = rng.normal(0.0, 4.0, (k, d))
    sizes = np.full(clients, rows, np.int64)
    sizes[-1] = rows - rows // 5
    data = np.zeros((clients, rows, d), np.float32)
    mask = np.zeros((clients, rows), np.float32)
    for c, n in enumerate(sizes):
        y = rng.integers(0, k, n)
        data[c, :n] = mus[y] + rng.normal(0.0, 0.6, (n, d))
        mask[c, :n] = 1.0
    return ClientSplit(data, mask, sizes, np.zeros((clients, 1), np.int64))


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_span_markers_are_not_device_work(path, card):
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from repro_torch import tracing
    from repro_torch.api import DEM, FedGenGMM
    from repro_torch.core.config import FitConfig

    cfg = FitConfig(device="cuda", max_iter=40)
    runner = (FedGenGMM(k_clients=3, k_global=3, h=1400, config=cfg)
              if path == "fedgen" else DEM(3, config=cfg))
    split = _split()
    runner.run(split, seed=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function("window"), tracing.recording() as rec:
            runner.run(split, seed=2)
            torch.cuda.synchronize()
    assert rec.spans
    got = harness.read_trace(prof, ("window",) + tracing.SPAN_NAMES)
    assert got["busy_s"] > 0.0
    assert not set(got["kernel_s"]) & set(tracing.SPAN_NAMES)
    assert any("kernel" in name for name in got["kernel_s"])
