"""The port's bench entry, roofline and lever sweep against the JAX package's scripts.

- ``probabilisticteacher_torch.bench``: its config equals the one ``bench.py``'s
  ``build`` makes, key by key; its batches are ``bench.py``'s draws byte for byte;
  one smoke mutual step from JAX's weights and JAX's draws against JAX's jitted
  step (rtol 1e-4, ``test_torch_train_step.py``'s tolerance) on every metric but the
  RPN's anchor matching, and on the total loss less the RPN's losses. At the smoke
  shapes the RPN's anchors (128-512 px) contain most of ``bench.py``'s 8-16 px
  boxes, so a box's best anchors tie in real numbers and rounding picks the tie
  set: JAX's jitted and op-by-op runs of this very step already disagree on the
  supervised RPN's positive anchors (47.25 and 48.75 per image), and the port
  equals the op-by-op one, for every data seed tried (0-11), so no seed avoids it
  as ``test_torch_train_step.py``'s does. The RPN's losses are held at tie-free
  shapes by ``test_torch_train_step.py`` and ``test_torch_train_losses.py``, and
  this step's supervised RPN against JAX's op-by-op run by
  ``test_torch_bench_eager.py``.
  ``bench.py`` builds its state over every device of its mesh, and this test
  process has 8 virtual CPU devices (``conftest.py``), which the smoke batch of 2
  does not divide: the JAX side is built on a one-device mesh;
- the worker's windows, their extension and median, and the 4 B images rule, on a
  fake clock; the orchestrator exits non-zero with no record when a child crashes,
  prints no JSON or hangs past its time limit (fake children, real processes);
  without ``--smoke`` and with no card, every mode raises before it measures
  (``--smoke`` end to end is ``test_torch_bench_smoke.py``);
- ``roofline``: the per-block counts equal ``scripts/roofline.py``'s at four
  canvases, and its printout the script's;
- ``lever_sweep``: the JAX script's combinations, a record of its own, and a failed
  combination recorded with its error (no value) and a non-zero exit.
"""

import contextlib
import importlib.util
import io
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

import bench as jbench
from probabilisticteacher_torch import bench, lever_sweep, roofline
from probabilisticteacher_torch.weights import params_from_jax
from torch_jax_draws import mutual_draws

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE_BUDGETS = (32, 16, 8, 8, 4)


def _script(name):
    spec = importlib.util.spec_from_file_location(f"_script_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_build():
    """``bench.py``'s smoke ``build`` on one device, with the config it made and the
    arrays it placed."""
    from probabilisticteacher_tpu import parallel
    from probabilisticteacher_tpu.modeling.detector import Arch

    placed, cfgs = [], []
    mp = pytest.MonkeyPatch()
    make_mesh, shard_batch, from_cfg = parallel.make_mesh, parallel.shard_batch, Arch.from_cfg

    def shard(mesh, tree):
        placed.append(jax.tree.map(np.asarray, tree))
        return shard_batch(mesh, tree)

    def capture(cfg):
        cfgs.append(cfg.clone())
        return from_cfg(cfg)

    mp.setattr(parallel, "make_mesh", lambda: make_mesh(jax.devices()[:1]))
    mp.setattr(parallel, "shard_batch", shard)
    mp.setattr(Arch, "from_cfg", staticmethod(capture))
    try:
        mutual, state, batches = jbench.build(2, (48, 96), 11, False, SMOKE_BUDGETS)
    finally:
        mp.undo()
    return {"mutual": mutual, "state": state, "batches": batches, "placed": placed,
            "cfg": cfgs[0]}


def _flat(node, prefix=""):
    out = {}
    for k, v in node.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = list(v) if isinstance(v, (list, tuple)) else v
    return out


# ------------------------------------------------------------------ parity with bench.py
def test_cfg_matches_bench_py_key_by_key(jax_build):
    want = _flat(jax_build["cfg"])
    got = _flat(bench.bench_cfg(2, 11, False, SMOKE_BUDGETS))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == want[k], k
    # and a lever's settings land where bench.py puts them
    lever = _flat(bench.bench_cfg(8, 16, True, (4000, 2000, 512, 512, 100), "hybrid", 6000,
                                  1000, 2048))
    assert (lever["MODEL.RPN.NMS_IMPL"], lever["UNSUPNET.TEACHER_PRE_NMS_TOPK"],
            lever["UNSUPNET.TEACHER_POST_NMS_TOPK"], lever["UNSUPNET.TEACHER_NMS_CANDIDATES"],
            lever["MODEL.RPN.PRE_NMS_TOPK_TRAIN"]) == ("hybrid", 6000, 1000, 2048, 4000)


def test_batches_are_bench_py_draws(jax_build):
    (limg, lgt), uimg = jax_build["placed"][:2], jax_build["placed"][2]
    d = bench.draw_batches(2, (48, 96))
    for got, want in ((d["limg"], limg.image), (d["uimg"], uimg.image), (d["hw"], limg.image_hw),
                      (d["hw"], uimg.image_hw), (d["boxes"], lgt.boxes),
                      (d["classes"], lgt.classes)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    assert d["limg"].dtype == np.uint8 and bool(np.all(lgt.valid))
    _, _, (tl, tgt, tu), _ = bench.build(bench.bench_cfg(2, 11, False, SMOKE_BUDGETS), (48, 96),
                                         torch.device("cpu"))
    assert tl.image.dtype == torch.uint8 and torch.equal(tu.image, torch.from_numpy(d["uimg"]))
    assert bool(tgt.valid.all()) and tuple(tgt.boxes.shape) == (2, bench.GT_PER_IMAGE, 4)


# the RPN's anchor matcher at the smoke shapes: every anchor (128-512 px) contains most
# of the 8-16 px boxes, so a box's best anchors tie in real numbers and the rounding of
# the anchors' areas picks the tie set; XLA's fused step and the op-by-op arithmetic
# (the port's, and JAX's own without jit) pick different ones for every data seed
RPN_MATCHED = ("loss_rpn_cls_sup", "loss_rpn_loc_sup", "loss_rpn_cls_unsup",
               "loss_rpn_loc_unsup", "rpn/num_pos_anchors_sup", "rpn/num_neg_anchors_sup")


def port_smoke_step(jax_build, key):
    """The port's smoke mutual step from the JAX state's weights and JAX's draws under
    ``key``: the state after it and its metrics as floats."""
    cfg = bench.bench_cfg(2, 11, False, SMOKE_BUDGETS)
    mutual, state, (limg, lgt, uimg), _ = bench.build(cfg, (48, 96), torch.device("cpu"))
    weights = params_from_jax(jax.tree.map(np.asarray, jax_build["state"].student),
                              state.student.arch)
    state.student.load_state_dict(weights)
    state.teacher.load_state_dict(weights)
    arch = state.student.arch
    anchors = (48 // 16) * (96 // 16) * len(arch.anchor_sizes) * len(arch.anchor_aspects)
    rows = SMOKE_BUDGETS[1] + bench.GT_PER_IMAGE
    state, tm = mutual(state, limg, lgt, uimg, mutual_draws(key, 0, 2, 2, anchors, rows))
    return state, {k: float(v) for k, v in tm.items()}


def test_smoke_mutual_step_matches_jax(jax_build):
    """Every metric the RPN's anchor matcher does not decide, and the total loss less
    the RPN's losses, within rtol 1e-4 of JAX's jitted step; the RPN's sampled anchors
    per image equal in number. (The RPN's losses against JAX's op-by-op step:
    ``test_torch_bench_eager.py``.)"""
    key = jax.random.key(0)
    jl, jgt, ju = jax_build["batches"]
    state, tm = port_smoke_step(jax_build, key)      # before the jitted step donates
    _, jm = jax_build["mutual"](jax_build["state"], jl, jgt, ju, key)
    jm = {k: float(v) for k, v in jm.items()}
    assert set(tm) == set(jm)
    for k in set(jm) - set(RPN_MATCHED) - {"total_loss"}:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-6, err_msg=k)

    def roi_total(m):
        return m["total_loss"] - sum(m[k] for k in RPN_MATCHED if k.startswith("loss"))

    np.testing.assert_allclose(roi_total(tm), roi_total(jm), rtol=1e-4, atol=1e-6)
    sampled = [m["rpn/num_pos_anchors_sup"] + m["rpn/num_neg_anchors_sup"] for m in (tm, jm)]
    assert sampled[0] == sampled[1]
    assert all(np.isfinite(tm[k]) and tm[k] > 0 for k in RPN_MATCHED)
    assert state.step == 1


# ------------------------------------------------------------------ the worker's timing
class _FakeCard:
    """A clock that advances by each step's duration, and a log of the calls."""

    def __init__(self, step_s):
        self.t = 0.0
        self.step_s = list(step_s)
        self.calls = []

    def clock(self):
        return self.t

    def step(self):
        n = sum(c[0] == "step" for c in self.calls)
        self.t += self.step_s[n]
        self.calls.append(("step", n))
        return n

    def fetch(self, n):
        self.calls.append(("fetch", n))

    def sync(self):
        self.calls.append(("sync",))


def test_windows_fetch_one_step_behind_and_take_the_median():
    card = _FakeCard([0.1] * 6)
    ws = bench.time_windows(card.step, card.fetch, card.sync, 3, 2, 6, 300.0, 64,
                            clock=card.clock, monotonic=card.clock)
    assert ws == pytest.approx([640.0, 640.0])
    assert card.calls[:8] == [("step", 0), ("step", 1), ("fetch", 0), ("step", 2), ("fetch", 1),
                              ("fetch", 2), ("sync",), ("step", 3)]
    rec = bench.throughput_record([600.0, 640.0, 700.0], 16, 12.0, "card", (608, 1216), 16, True)
    assert rec["value"] == 640.0 and rec["windows"] == [600.0, 640.0, 700.0]
    assert rec["step_ms"] == pytest.approx(4 * 16 / 640.0 * 1e3)
    assert (rec["window_min"], rec["window_max"]) == (600.0, 700.0)
    assert rec["spread"] == round(100 / 640, 3)
    flops = roofline.iteration(608, 1216, 16)["flops"]
    assert rec["conv_tflop_per_iter"] == round(flops / 1e12, 3)
    assert rec["conv_mfu"] == pytest.approx(flops / 0.1 / 989e12, abs=1e-4)
    cpu = bench.throughput_record([5.0], 2, 1.0, "cpu", (48, 96), 11, False)
    assert cpu["conv_mfu"] is None and cpu["spread"] == 0.0 and cpu["value"] == 5.0


@pytest.mark.parametrize("steps,budget,expect", [
    ([0.1, 0.105], 300.0, 2),              # within 20% of their median: no more windows
    ([0.1, 0.2] + [0.2] * 4, 300.0, 6),    # 67% apart: more, up to 2 + 4
    ([0.1, 0.2], 0.0, 2),                  # apart, but no budget left
    ([0.1], 300.0, 1),                     # one window is never extended
], ids=["agree", "spread", "no_budget", "one_window"])
def test_windows_extend_while_they_spread(steps, budget, expect):
    card = _FakeCard(steps)
    ws = bench.time_windows(card.step, card.fetch, card.sync, 1, min(2, len(steps)), 6, budget,
                            8, clock=card.clock, monotonic=card.clock)
    assert ws == pytest.approx([8 / s for s in steps[:expect]])


# ------------------------------------------------------------------ the orchestrator
_FAKE_CHILD = r"""
import json, os, sys, time
mode, argv = os.environ["FAKE_BENCH"], sys.argv[1:]
warm = argv[argv.index("--iters") + 1] == "2"
role = "e2e" if "--e2e" in argv else ("warm" if warm else "worker")
fail_role, how = mode.split(":")
if role == fail_role:
    if how == "crash":
        sys.exit(3)
    if how == "garbage":
        print("[bench] all went well, honest")
        sys.exit(0)
    if how == "hang":
        time.sleep(120)
rec = {"value": 100.0, "compile_s": 5.0 if role == "worker" else 1.5, "batch": 2,
       "data_time_share": 0.25, "step_ms": 80.0, "step_alone_ms": 60.0}
print(json.dumps(rec))
"""


def _orchestrate(monkeypatch, capfd, mode, extra=()):
    monkeypatch.setattr(bench, "CHILD", [sys.executable, "-c", _FAKE_CHILD])
    monkeypatch.setenv("FAKE_BENCH", mode)
    rc = bench.main(["--smoke", "--data-root", "unused", "--attempt-timeout-s", "3"] + list(extra))
    return rc, capfd.readouterr().out


@pytest.mark.parametrize("mode", ["worker:crash", "worker:garbage", "worker:hang",
                                  "warm:crash", "e2e:hang", "e2e:garbage"])
def test_orchestrator_fails_without_a_record(monkeypatch, capfd, mode):
    rc, out = _orchestrate(monkeypatch, capfd, mode)
    assert rc != 0
    assert '"value"' not in out and out.strip() == ""


def test_orchestrator_merges_the_warm_start_and_e2e(monkeypatch, capfd):
    rc, out = _orchestrate(monkeypatch, capfd, "none:none")
    assert rc == 0
    rec = json.loads(out.strip().splitlines()[-1])
    assert rec["compile_s"] == 5.0 and rec["compile_warm_s"] == 1.5
    assert rec["e2e"] == {"value": 100.0, "data_time_share": 0.25, "step_ms": 80.0,
                          "step_alone_ms": 60.0, "batch": 2}
    rc, out = _orchestrate(monkeypatch, capfd, "e2e:crash", ["--skip-e2e"])
    assert rc == 0 and "e2e" not in json.loads(out.strip().splitlines()[-1])


def test_without_smoke_every_mode_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "CHILD", ["false"])      # no child may start
    for argv in ([], ["--worker"], ["--e2e", "--data-root", "unused"]):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            bench.main(argv)


# ------------------------------------------------------------------ roofline
@pytest.mark.parametrize("hw", [(608, 1216), (608, 1344), (480, 992), (48, 96)])
def test_roofline_counts_equal_the_script(hw):
    want = _script("roofline").conv_flops_per_image(*hw)
    assert roofline.conv_flops_per_image(*hw) == want


def test_roofline_prints_what_the_script_prints(monkeypatch):
    script = _script("roofline")
    argv = ["--canvas", "608x1344", "--batch", "16", "--peak-tfs", "989", "--eff", "0.5,0.8",
            "--measured-step-ms", "345"]
    monkeypatch.setattr(sys, "argv", ["roofline.py"] + argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        script.main()
    want = buf.getvalue().strip().splitlines()
    r = roofline.iteration(608, 1344, 16, peak_tfs=989, eff=(0.5, 0.8))
    got = roofline.report(r, 345).splitlines()
    assert got[:3] == want[:3] and got[3].startswith(want[3])
    assert r["flops"] / 1e12 == pytest.approx(67.73, abs=5e-3)
    assert roofline.conv_mfu(r["flops"], 345.0) == pytest.approx(0.1985, abs=1e-4)


# ------------------------------------------------------------------ lever sweep
def test_sweep_has_the_scripts_combos_and_its_own_record():
    assert lever_sweep.COMBOS == _script("lever_sweep").COMBOS
    assert os.path.abspath(lever_sweep.OUT) != os.path.abspath(
        os.path.join(REPO, "docs", "lever_sweep_r3.json"))
    with pytest.raises(ValueError, match="JAX package's record"):
        lever_sweep.sweep(out_path=os.path.join(REPO, "docs", "lever_sweep_r3.json"))


def test_sweep_records_a_failed_combo_with_its_error(monkeypatch, tmp_path, capsys):
    def spawn(args, timeout_s):
        if "hybrid" in args:
            raise bench.ChildFailed("--worker ...: exit 1")
        return {"value": 150.0, "windows": [150.0]}

    monkeypatch.setattr(bench, "spawn_worker", spawn)
    out = tmp_path / "sweep.json"
    monkeypatch.setattr(lever_sweep, "OUT", str(out))
    rc = lever_sweep.main(["baseline_exact", "hybrid", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc != 0
    assert rec["baseline_exact"]["value"] == 150.0
    assert "value" not in rec["hybrid"] and "exit 1" in rec["hybrid"]["error"]
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == {
        "baseline_exact": 150.0, "hybrid": None}
    # a second run measures every combination it is asked for again and writes only
    # its own records: nothing of the first run is reprinted as a result
    ran = []

    def spawn_again(args, timeout_s):
        ran.append(list(args))
        return {"value": 140.0}

    monkeypatch.setattr(bench, "spawn_worker", spawn_again)
    assert lever_sweep.main(["baseline_exact", "--out", str(out)]) == 0
    assert ran == [list(lever_sweep.WORKER_ARGS)]
    assert json.loads(out.read_text()).keys() == {"baseline_exact"}
    assert json.loads(out.read_text())["baseline_exact"]["value"] == 140.0
