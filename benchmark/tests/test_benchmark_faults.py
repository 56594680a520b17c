"""The comparison fails what it must: the control (the reference with its products'
operands in fp8 e4m3 in the program's place) and the faults of a training step,
each planted underneath the timed path of a whole run, with the look for a card
skipped. At this tiny size the sound program (f32) reads nought to rounding, so
the tiny cell's limits are tight; the card's own readings set the real cells'."""

import os
import time

import pytest

import calibrate
import tiny
from harness import check, runner
from harness.cells import load_cell

REPO = tiny.REPO
SEED = 2 ** 31 + 4242


def _cell(tmp_path, phase):
    path, name = tiny.add_tiny_cell(str(tmp_path), phase, amp=False, native=False)
    return load_cell(path, name, os.path.join(str(tmp_path), "benchmark"))


@pytest.mark.parametrize("fault", calibrate.FAULTS)
def test_a_fault_underneath_makes_correct_false(tmp_path, fault):
    cell = _cell(tmp_path, "mutual")
    with calibrate.planted(fault):
        line = runner.run_cell(cell, REPO, SEED, 0.5, False, "cpu", time.time_ns())
    assert line["correct"] is False
    checks = line["checks"]
    assert [k for k, c in checks.items() if c["value"] > c["limit"]]
    if fault == "frozen_state":
        assert checks["delta"]["value"] == pytest.approx(1.0)
    if fault == "frozen_ema":
        assert checks["teacher_delta"]["value"] == pytest.approx(1.0)
        assert checks["delta"]["value"] <= checks["delta"]["limit"]
    if fault == "altered_batch":
        assert checks["batch"]["value"] > 2
    if fault == "wrong_lr":
        assert checks["delta_median"]["value"] > 0.1


@pytest.mark.parametrize("phase", ["burnin", "mutual"])
def test_the_control_fails_the_limits(tmp_path, phase):
    cell = _cell(tmp_path, phase)
    res = runner.run_program(cell, REPO, SEED, 0.5, False, "cpu", time.time_ns())
    ref = runner.run_reference(cell, res["p0"], res["trees"], SEED, "cpu", res["start_iter"])
    ctl = runner.run_reference(cell, res["p0"], res["trees"], SEED, "cpu", res["start_iter"],
                               control=True)
    checks = check.judge(check.compare(ctl, ref, cell.limits), cell.limits)
    assert not check.passed(checks)
    assert checks["rpn_first"]["value"] > 10 * cell.limits["rpn_first"]
    assert checks["rpn_out_first"]["value"] > 100 * cell.limits["rpn_out_first"]
