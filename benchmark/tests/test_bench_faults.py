"""``correct`` comes out false with the timed path broken underneath (one
planted fault at a time, the whole run driven but the look for a card),
and for the control: the plain reference at the next precision below the
configuration's, in the program's place."""
import pytest
import torch

import calibrate
import faults
from bmk.check import judge
from bmk.spec import Cell
from conftest import run_cell
from precision import lowered


@pytest.mark.parametrize("workload,fault", [
    ("sage-reddit-train", f) for f in faults.TRAIN] + [
    ("gatv2-reddit-infer", f) for f in faults.INFER])
def test_fault_fails(tiny_root, workload, fault):
    mode = "train" if "train" in workload else "infer"
    with faults.plant(mode, fault):
        rc, line, err = run_cell(tiny_root, workload)
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
    if fault == "window_state_unchanged":  # only the replayed group fails
        bad = {k for k, c in line["checks"].items()
               if not c["value"] <= c["limit"]}
        assert bad and all(k.startswith("replay.") for k in bad), bad


@pytest.mark.parametrize("workload", ["sage-reddit-train",
                                      "gatv2-reddit-infer"])
def test_control_fails(tiny_root, workload):
    cell = Cell(tiny_root, workload)
    nums, = calibrate.readings(cell, 5, torch.device("cpu"),
                               [lowered(cell.cfg)])
    ok, checks = judge(nums, cell.limits())
    assert not ok, checks
