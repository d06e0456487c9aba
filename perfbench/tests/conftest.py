"""Shared fixtures of the benchmark's CPU tests: the repository root on
``sys.path`` (for ``perfbench``) beside ``src`` (for the program), and a
cell cut to a few thousand rows."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

# rows of each cell's configuration in the CPU tests
SMALL_ROWS = {"smd-k10": 6000}


@pytest.fixture
def small_cell():
    """``small_cell(workload)``: the cell as loaded, its configuration cut
    to ``SMALL_ROWS`` rows, each client padded to the largest."""
    from perfbench import harness

    def make(workload: str):
        cell = harness.load_cell(workload)
        cell.config["rows"] = SMALL_ROWS[cell.config["name"]]
        cell.config["pad_rows"] = 0
        return cell
    return make


@pytest.fixture
def card():
    """A CUDA card, or a skip."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
