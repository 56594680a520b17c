"""The plain reference against the port at a tiny size: in f32, with PIL decoding on
both sides, the reference repeats the program's first three iterations (batches,
teacher detections, every metric, the first step's RPN head outputs, first gradient,
the change of every leaf of the student and the teacher) to rounding."""

import os
import time

import pytest

import tiny
from harness import check, runner
from harness.cells import load_cell

REPO = tiny.REPO


@pytest.mark.parametrize("phase,base", [("mutual", "pt_vgg16_c2f"), ("burnin", "pt_vgg16_c2f"),
                                        ("mutual", "pt_vgg16_k2c")])
def test_reference_repeats_the_program_in_f32(tmp_path, phase, base):
    path, name = tiny.add_tiny_cell(str(tmp_path), phase, amp=False, native=False, base=base)
    cell = load_cell(path, name, os.path.join(str(tmp_path), "benchmark"))
    seed = 2 ** 31 + 77
    res = runner.run_program(cell, REPO, seed, 0.5, False, "cpu", time.time_ns())
    ref = runner.run_reference(cell, res["p0"], res["trees"], seed, "cpu", res["start_iter"])
    names = [n for n in check.NUMBERS if phase == "mutual" or n not in check.MUTUAL_ONLY]
    numbers = check.compare(res["capture"], ref, names)
    assert numbers["batch"] == 0
    assert numbers["loss"] < 1e-6
    assert numbers["rpn_first"] < 1e-6 and numbers["rpn_out_first"] < 1e-6
    assert numbers["grad"] < 1e-5 and numbers["delta"] < 1e-5
    assert numbers["grad_cos_median"] < 1e-6
    if phase == "mutual":
        assert numbers["pseudo_miss"] == 0 and numbers["teacher_delta"] < 1e-5
        assert len(ref.dets) == 3
    assert [sorted(m) for m in res["capture"].metrics] == [sorted(m) for m in ref.metrics]
    for p, r in zip(res["capture"].metrics, ref.metrics):
        for k in r:
            assert abs(p[k] - r[k]) <= 1e-6 * max(1.0, abs(r[k])), k
