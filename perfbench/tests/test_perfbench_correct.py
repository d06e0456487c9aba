"""``correct`` at a size a test run holds, on the CPU: a run of the
program comes out correct; a run with a fault planted under the timed path
comes out not correct (the harness's look for a card skipped, the rest of
the run driven); and the control, the plain pipeline in the program's
place at TF32, fails the cell's limits. The same control on the card is
marked ``cuda``."""
import time

import pytest
import torch

from perfbench import check, data, faults, harness, reference as ref

CELLS = ["smd-k10.oneshot", "smd-k10.dem"]


def _run(cell, seed=2**31 + 101):
    return harness.run_cell(cell, seed, 0.05, False, time.perf_counter(),
                            device="cpu", require_card=False)


@pytest.mark.parametrize("workload", CELLS)
def test_a_sound_run_is_correct(small_cell, workload):
    out = _run(small_cell(workload))
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_is_not_correct(small_cell, workload, fault):
    with faults.planted(fault):
        out = _run(small_cell(workload))
    assert not out["correct"], out["checks"]


def _control(cell, device, seed=7):
    import importlib
    entry = importlib.import_module(
        f"perfbench.entries.{cell.traffic['entry']}")
    runner = entry.Runner(cell.config, cell.traffic, str(device))
    split = data.make_split(cell.config, seed)
    form = runner.plain(torch.as_tensor(split.data, device=device),
                        torch.as_tensor(split.mask, device=device),
                        split.sizes, cell.config, seed,
                        ref.Precision("tf32"))
    nums = runner.numbers(form, check.client_rows(split, device), split)
    return check.decide(nums, cell.limits)


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(small_cell, workload):
    ok, table = _control(small_cell(workload), torch.device("cpu"))
    assert not ok, table


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct_on_the_card(small_cell, workload, card):
    ok, table = _control(small_cell(workload), card)
    assert not ok, table
