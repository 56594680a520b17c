"""A configuration brings its own reference and work counts as new files: the harness
finds them by the names in its configuration file, and the two VGG16
configurations, which name none, keep the reference of ``reference/vgg16.py`` (the
detector of ``reference/model.py`` and the steps of ``reference/step.py``) and the
counts of ``harness/counts.py``. The RPN head's
outputs are kept and compared level by level, for a head with one feature map or
several."""

import hashlib
import json
import os
import time

import pytest
import torch

import tiny
from harness import check, counts, runner, tree
from harness.cells import BENCH_DIR, bench_module, load_cell

REPO = tiny.REPO
SKIP = (".cache", "__pycache__")


def _hashes(bench: str):
    out = {}
    for root, dirs, files in os.walk(bench):
        dirs[:] = [d for d in dirs if d not in SKIP]
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, bench)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_a_second_architecture_joins_as_files_alone(tmp_path):
    dest = str(tmp_path)
    path, base = tiny.add_tiny_cell(dest, "mutual", amp=False, native=False)
    bench = os.path.join(dest, "benchmark")
    before = _hashes(bench)
    with open(path) as f:
        spec_before = json.load(f)

    name = tiny.add_tiny_architecture(dest, base)
    cell = load_cell(path, name, bench)
    assert cell.config["reference"] == "tiny_marked"
    # a later mutual cell reads every per-layer metric that the mutual cells read
    assert [m["name"] for m in cell.per_layer] == [
        m["name"] for m in load_cell(path, base, bench).per_layer]
    assert "teacher_ms" in [m["name"] for m in cell.per_layer]
    line = runner.run_cell(cell, REPO, 2 ** 31 + 2024, 1.0, True, "cpu", time.time_ns())

    # the configuration's own modules, from the copy, did the work
    ref = bench_module(bench, "reference", "tiny_marked")
    work = bench_module(bench, "harness", "tiny_marked_counts")
    assert ref.__file__ == os.path.join(bench, "reference", "tiny_marked.py")
    assert ref.BUILT == ["Detector"]
    assert work.CALLS == ["iteration_flops", "kernel_launches"]
    assert line["correct"] is True and set(line["checks"]) == set(cell.limits)
    # step_mfu follows the new counts: three times the VGG16 FLOPs of an iteration
    c, tr = cell.config, cell.config["train"]
    hw = [tree.stored_hw(c["datasets"][s]["hw"], "train", c["input"]["min_size_train"][0],
                         c["input"]["max_size_train"]) for s in ("label", "unlabel")]
    flops = work.iteration_flops(c["arch"], "mutual", tr["img_per_batch_label"],
                                 tr["img_per_batch_unlabel"], *hw)["total"]
    assert flops == 3 * counts.iteration_flops(c["arch"], "mutual", tr["img_per_batch_label"],
                                               tr["img_per_batch_unlabel"], *hw)["total"]
    want = 100.0 * flops * line["attempted"] / line["device"]["window_s"] / counts.H100_BF16_FLOPS
    assert line["metrics"]["step_mfu"]["value"] == pytest.approx(want, rel=1e-3)
    # and k1_roofline reads its launches from them: twice the VGG16 least times
    k1 = work.kernel_launches(c["arch"], "mutual", 2, 2, c["input"]["canvas_wide"])["k1"]
    assert k1 == [2 * t for t in counts.kernel_launches(c["arch"], "mutual", 2, 2,
                                                        c["input"]["canvas_wide"])["k1"]]
    res = {"iterations": 3, "window_s": 1.0, "data_wait_s": 0.0, "stages": None,
           "trace": {"kernels": {"roi_align_fwd_kernel": [1e-3, 3 * len(k1)]}, "window_s": 1.0,
                     "busy_s": 0.5}}
    got = runner.per_layer(cell, res)["k1_roofline"]["value"]
    assert got == pytest.approx(100.0 * 3 * sum(k1) / 1e-3)

    # no file that was in the copy changed; BENCHMARK.json only gained entries
    after = _hashes(bench)
    assert {k: after[k] for k in before} == before
    assert sorted(set(after) - set(before)) == sorted([
        os.path.join("configs", "tiny_marked.json"),
        os.path.join("harness", "tiny_marked_counts.py"),
        os.path.join("limits", "tiny_marked_cell.json"),
        os.path.join("reference", "tiny_marked.py")])
    with open(path) as f:
        spec_after = json.load(f)
    for key, entries in spec_before.items():
        if isinstance(entries, list):
            assert spec_after[key][:len(entries)] == entries
        else:
            assert spec_after[key] == entries


# the VGG16 figures as harness/counts.py gave them before configurations could name
# their own counts
VGG_FLOPS = {"c2f_mutual": {"teacher": 8967677132800, "student_forward": 23072785121280,
                            "student_backward": 33166493122560, "total": 65206955376640},
             "k2c_mutual": {"teacher": 8963548364800, "student_forward": 19319379271680,
                            "student_backward": 27875387277312, "total": 56158314913792}}
VGG_LAUNCHES = {"k1": [0.000495057232238806, 0.0004150482913432836],
                "k2": [0.0004150482913432836]}


@pytest.mark.parametrize("workload", ["c2f_mutual", "k2c_mutual"])
def test_the_vgg16_configurations_keep_their_reference_and_counts(workload, monkeypatch):
    cell = load_cell(os.path.join(REPO, "BENCHMARK.json"), workload)
    assert "reference" not in cell.config and "counts" not in cell.config
    ref = runner.reference_of(cell)
    model = bench_module(BENCH_DIR, "reference", "model")
    step = bench_module(BENCH_DIR, "reference", "step")
    assert ref.__file__ == os.path.join(BENCH_DIR, "reference", "vgg16.py")
    assert model.__file__ == os.path.join(BENCH_DIR, "reference", "model.py")
    assert (ref.Arch, ref.Detector, ref.exact, ref.fp8_e4m3) == (
        model.Arch, model.PTDetector, model._exact, model.fp8_e4m3)
    assert (ref.build_state, ref.burnin_step, ref.mutual_step) == (
        step.build_state, step.burnin_step, step.mutual_step)
    assert set(runner.REFERENCE_NAMES) == set(ref.__all__) <= set(vars(ref))

    work = runner.counts_of(cell)
    assert work.__file__ == os.path.join(BENCH_DIR, "harness", "counts.py")
    seen = {}

    def capture(ctx):
        seen.update(ctx)
        return None

    res = {"iterations": 1, "window_s": 1.0, "trace": None, "stages": None}
    cell.per_layer = [{"name": "probe", "unit": "%"}]
    monkeypatch.setattr(runner, "metric_reader", lambda bench_dir, name: capture)
    runner.per_layer(cell, res)
    assert seen["flops_per_iter"] == VGG_FLOPS[workload]["total"]
    assert seen["launches"] == VGG_LAUNCHES
    assert [x.hex() for x in seen["launches"]["k1"]] == [x.hex() for x in VGG_LAUNCHES["k1"]]


def test_a_reference_module_that_lacks_a_name_is_refused(tmp_path):
    path, base = tiny.add_tiny_cell(str(tmp_path), "mutual", amp=False, native=False)
    name = tiny.add_tiny_architecture(str(tmp_path), base, name="tiny_short")
    bench = os.path.join(str(tmp_path), "benchmark")
    with open(os.path.join(bench, "reference", "tiny_short.py"), "a") as f:
        f.write("\ndel mutual_step\n")
    cell = load_cell(path, name, bench)
    with pytest.raises(AttributeError, match="mutual_step"):
        runner.reference_of(cell)


# ------------------------------------------------------- RPN outputs by level
def _hooked(outputs):
    cap = check.Capture()
    hook = check.record_rpn(cap)
    for out in outputs:
        hook(None, None, out)
    return cap


def _levels(gen, shapes):
    return [torch.randn(s, generator=gen) for s in shapes]


def test_rpn_outputs_kept_and_compared_level_by_level():
    gen = torch.Generator().manual_seed(5)
    shapes_obj = [(2, 300), (2, 75), (2, 20)]
    shapes_del = [(2, 300, 4), (2, 75, 4), (2, 20, 4)]
    calls = [(_levels(gen, shapes_obj), _levels(gen, shapes_del)) for _ in range(2)]
    ref = _hooked(calls)
    assert [[t.shape for t in x] for x in ref.rpn1[0]] == [
        [torch.Size(s) for s in shapes_obj], [torch.Size(s) for s in shapes_del]]
    # level 2 of the deltas off by 10% in both calls, level 0 of objectness by 1%
    bent = [([o[0] * 1.01, o[1], o[2]], [d[0], d[1], d[2] * 1.1]) for o, d in calls]
    prog = _hooked(bent)
    assert check.rpn_out_gap(prog, ref) == pytest.approx(0.1)
    assert check.rpn_out_gap(ref, ref) == 0.0
    # a level missing or of another size reads inf
    assert check.rpn_out_gap(_hooked([(o[:2], d) for o, d in calls]), ref) == float("inf")
    short = [([o[0][:, :-1], o[1], o[2]], d) for o, d in calls]
    assert check.rpn_out_gap(_hooked(short), ref) == float("inf")


def test_flat_rpn_outputs_read_as_one_level_and_as_before():
    gen = torch.Generator().manual_seed(6)
    calls = [(torch.randn(2, 50, generator=gen), torch.randn(2, 50, 8, generator=gen))
             for _ in range(3)]
    ref = _hooked(calls)
    assert all(len(x) == 1 for c in ref.rpn1 for x in c)
    bent = [(o + 0.01 * torch.randn(o.shape, generator=gen), d * 1.02) for o, d in calls]
    prog = _hooked(bent)
    # the single-level gap: each output over all calls and images
    worst = 0.0
    for i in range(2):
        p = torch.cat([c[i].flatten() for c in bent]).double()
        r = torch.cat([c[i].flatten() for c in calls]).double()
        worst = max(worst, float((p - r).norm() / r.norm()))
    assert check.rpn_out_gap(prog, ref) == worst
    assert check.rpn_out_gap(prog, _hooked(calls[:2])) == float("inf")
