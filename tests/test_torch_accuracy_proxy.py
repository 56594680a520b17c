"""The port's accuracy-proxy runner, ``python -m probabilisticteacher_torch.accuracy_proxy``.

- (a) each campaign stage resolves to the config the JAX runs recorded
  (``docs/proxy_runs/source_only`` and ``pt_from_source``) on every key both have,
  except the paths, the device and the checkpoint period (listed in ``EXEMPT``);
- (b) a micro campaign on the CPU: the proxy at 8 + 8 training and 4 + 4 val images
  of 128 x 256, the micro overrides of ``tests/torch_micro.py``, stage 1 (4
  source-only iterations) then stage 2 (3 burn-in + 1 mutual) from its final
  checkpoint, each stage a ``train_net`` process (TensorBoard kept out by a
  ``sitecustomize``, as in ``test_torch_cli.py``). It holds the metric keys to the
  JAX runs', stage 2's start to stage 1's final weights bit for bit, the teacher
  copy at ``BURN_UP_STEP``, and ``summarize``/``compare``/``bands`` on the JAX
  package's own ``metrics.json``;
- (c) the archive writes under its root (``docs/proxy_runs_torch/`` by default)
  and nowhere else, never into ``docs/proxy_runs/``.
"""

import argparse
import json
import os
import sys

import pytest
import torch
import yaml

from probabilisticteacher_torch import accuracy_proxy as ap
from probabilisticteacher_torch import train_net
from probabilisticteacher_torch.engine.trainer import PTrainer
from probabilisticteacher_torch.solver import auto_scale_config
from torch_micro import micro_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_RUNS = os.path.join(REPO, "docs", "proxy_runs")
# keys that may differ from the JAX record: where the run lives, the device, and the
# checkpoint period (the two records predate the JAX runner's move from 1000 to 500;
# source_only_s101 and run_r record 500, held below)
EXEMPT = {"OUTPUT_DIR", "MODEL.WEIGHTS", "MODEL.DEVICE", "SOLVER.CHECKPOINT_PERIOD"}
# what the runner sets itself; the rest of the micro overrides shrink the model
RUNNER_KEYS = {"OUTPUT_DIR", "UNSUPNET.BURN_UP_STEP", "UNSUPNET.EMA_KEEP_RATE",
               "SOLVER.MAX_ITER", "SOLVER.CHECKPOINT_PERIOD", "TEST.EVAL_PERIOD",
               "SOLVER.IMG_PER_BATCH_LABEL", "SOLVER.IMG_PER_BATCH_UNLABEL",
               "DATASETS.TRAIN_LABEL", "DATASETS.TRAIN_UNLABEL", "DATASETS.TEST"}
ITERS, BURN = 4, 3


def _flat(d, pre=""):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(_flat(v, pre + k + "."))
        else:
            out[pre + k] = list(v) if isinstance(v, tuple) else v
    return out


def _resolved(argv):
    cfg = train_net.load_config(train_net.parse_args(argv)).clone()
    return _flat(yaml.safe_load(auto_scale_config(cfg).dump()))


def _recorded(run):
    with open(os.path.join(JAX_RUNS, run, "config.yaml")) as f:
        return _flat(yaml.safe_load(f))


@pytest.mark.parametrize("stage,run", [(1, "source_only"), (2, "pt_from_source")])
def test_stage_config_matches_the_jax_record(stage, run):
    args = ap.build_parser(campaign=True).parse_args([])
    ns = ap.stage_args(args, stage, os.path.join(ap.WORK, "source_only"))
    mine, jax = _resolved(ap.train_argv(ns)), _recorded(run)
    shared = set(mine) & set(jax)
    assert len(shared) >= 140
    diff = {k: (mine[k], jax[k]) for k in shared - EXEMPT if mine[k] != jax[k]}
    assert not diff
    assert mine["MODEL.DEVICE"] == "cuda"              # the card unless MODEL.DEVICE cpu
    assert mine["SOLVER.CHECKPOINT_PERIOD"] == 500 == _recorded(
        ("source_only_s101", "run_r")[stage - 1])["SOLVER.CHECKPOINT_PERIOD"]
    if stage == 2:
        assert mine["MODEL.WEIGHTS"].endswith(os.path.join("source_only", "model_0003000"))
    else:
        assert mine["MODEL.WEIGHTS"] == ""


def _micro_overrides():
    opts = micro_opts("unused", "l", "u", "v")
    pairs = [(k, v) for k, v in zip(opts[::2], opts[1::2]) if k not in RUNNER_KEYS]
    return [x for kv in pairs for x in kv] + ["SOLVER.CHECKPOINT_PERIOD", str(BURN)]


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    root = tmp_path_factory.mktemp("proxy")
    site = root / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(
        "import sys\nsys.modules['torch.utils.tensorboard'] = None\n")
    args = ap.build_parser(campaign=True).parse_args(
        ["--iters", str(ITERS), "--burn", str(BURN), "--eval-period", "2", "--batch", "2",
         "--n-train", "8", "--n-val", "4", "--hw", "128", "256",
         "--data", str(root / "data"), "--out-root", str(root / "runs"),
         "--archive", str(root / "docs" / "proxy_runs_torch")] + _micro_overrides())
    mp = pytest.MonkeyPatch()
    mp.setenv("PYTHONPATH", os.pathsep.join([str(site), REPO]))
    mp.setenv("OMP_NUM_THREADS", "2")
    try:
        result = ap.campaign(args)
    finally:
        mp.undo()
    return argparse.Namespace(root=root, args=args, result=result,
                              s1=ap.stage_args(args, 1), s2=ap.stage_args(
                                  args, 2, str(root / "runs" / "source_only")))


def _eval_keys(rec):
    return {k for k in rec if "AP" in k}


def _last(run):
    return ap.read_records(run)[-1]


def test_micro_campaign_writes_the_jax_runs_keys(campaign):
    s1, s2 = _last(campaign.s1.out), _last(campaign.s2.out)
    assert s1["iteration"] == s2["iteration"] == ITERS - 1
    for key in (ap.FOGGY_STUDENT, ap.CITY_STUDENT):
        assert key in s1 and 0.0 <= s1[key] <= 100.0
    for key in ("mAP50", "mAP50_student", "num_pseudo_boxes"):
        assert key in s2
    # every eval key of a stage is one the JAX run of that stage wrote, and back
    assert _eval_keys(s1) == _eval_keys(_last(os.path.join(JAX_RUNS, "source_only")))
    assert _eval_keys(s2) == _eval_keys(_last(os.path.join(JAX_RUNS, "pt_from_source")))
    for run in (campaign.s1.out, campaign.s2.out):
        assert [e for e, _ in ap.evals(run)] == [2]    # the eval at 4 follows the last write
        with open(os.path.join(run, "config.yaml")) as f:
            assert yaml.safe_load(f)["MODEL"]["DEVICE"] == "cpu"


def _ckpt(run, it):
    return torch.load(os.path.join(run, f"model_{it:07d}"), map_location="cpu",
                      weights_only=True)


def _equal(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def test_stage_two_starts_from_stage_one_and_copies_the_teacher(campaign, tmp_path,
                                                                 monkeypatch):
    final1 = _ckpt(campaign.s1.out, ITERS)
    # stage 2's command, in this process: MODEL.WEIGHTS loads stage 1's final student
    # and teacher bit for bit
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    argv = ap.train_argv(campaign.s2) + ["OUTPUT_DIR", str(tmp_path)]
    trainer = PTrainer(train_net.load_config(train_net.parse_args(argv)))
    trainer.resume_or_load(resume=False)
    assert trainer.start_iter == 0
    assert _equal(trainer.state.student.state_dict(), final1["student"])
    assert _equal(trainer.state.teacher.state_dict(), final1["teacher"])
    # through the CLI: the teacher is untouched by burn-in (checkpoint at BURN_UP_STEP)
    # and, in the first mutual step, is the student of the boundary bit for bit
    at_burn, after = _ckpt(campaign.s2.out, BURN), _ckpt(campaign.s2.out, BURN + 1)
    assert at_burn["step"] == BURN and after["step"] == BURN + 1
    assert _equal(at_burn["teacher"], final1["teacher"])
    assert not _equal(at_burn["student"], final1["student"])
    assert _equal(after["teacher"], at_burn["student"])
    with open(os.path.join(campaign.s2.out, "log.txt")) as f:
        assert f"Loaded weights from {campaign.s2.weights}" in f.read()


def test_summarize_compare_and_bands_read_the_jax_record(campaign, capsys):
    ap.summarize(os.path.join(JAX_RUNS, "source_only"))
    rows = capsys.readouterr().out.splitlines()
    assert rows[0].split()[:2] == ["iter", "teacher"] and len(rows) > 100
    table = ap.compare(campaign.s2.out, os.path.join(JAX_RUNS, "pt_from_source"))
    assert "jax:pt_from_source" in table and "78.41" in table    # JAX's teacher at 2750
    assert ap.compare(os.path.join(JAX_RUNS, "source_only"),
                      os.path.join(JAX_RUNS, "source_only_s101")).count("94.13") == 1
    # the bands on the JAX runs read the numbers the campaign is judged beside
    jax = ap.bands(os.path.join(JAX_RUNS, "source_only"), os.path.join(JAX_RUNS, "run_r"))
    assert all(jax[b]["pass"] for b in ("S1a", "S1b", "S2a", "S2b")) and not jax["collapsed"]
    assert jax["S1b"]["foggyval_student_mean_from_1000"] == pytest.approx(50.3586, abs=1e-4)
    assert jax["S2a"]["teacher_peak"] == pytest.approx(87.0360, abs=1e-4)
    # the micro campaign's verdicts: every band read and judged (the micro model is
    # far from the bands' numbers)
    verdict = campaign.result["bands"]
    assert set(verdict) == {"S1a", "S1b", "S2a", "S2b", "collapsed"}
    assert all(isinstance(verdict[b]["pass"], bool) for b in ("S1a", "S1b", "S2a", "S2b"))
    with open(os.path.join(campaign.args.archive, "campaign.json")) as f:
        saved = json.load(f)
    assert saved["bands"]["S1b"]["evals"] == 0 and set(saved["stages"]) == {"1", "2"}
    for stats in (saved["stages"]["1"]["stats"], saved["stages"]["2"]["stats"]):
        assert stats["wall_s"] > 0 and stats["eval_images"] > 0 and stats["peak_gib"] is None


def test_archive_mirrors_each_stage_under_its_root_only(campaign):
    root = campaign.args.archive
    found = sorted(os.path.relpath(os.path.join(d, f), root)
                   for d, _, files in os.walk(root) for f in files)
    assert found == ["campaign.json", "pt_from_source/config.yaml",
                     "pt_from_source/metrics.json", "source_only/config.yaml",
                     "source_only/metrics.json"]
    for ns in (campaign.s1, campaign.s2):
        for fname in ("metrics.json", "config.yaml"):
            with open(os.path.join(ns.out, fname), "rb") as a, \
                    open(os.path.join(root, os.path.basename(ns.out), fname), "rb") as b:
                assert a.read() == b.read()
    # nothing of the campaign landed in the repo's docs/
    assert not os.path.exists(os.path.join(JAX_RUNS, "pt_from_source", "campaign.json"))


def _tree(path):
    return sorted(os.path.join(d, f) for d, _, files in os.walk(path) for f in files)


def test_archive_writes_complete_lines_and_never_shrinks_a_curve(tmp_path):
    run = tmp_path / "runs" / "r1"
    run.mkdir(parents=True)
    (run / "config.yaml").write_text("SEED: 1\n")
    (run / "metrics.json").write_text('{"iteration": 0}\n{"iteration": 20}\n{"itera')
    root = tmp_path / "docs" / "proxy_runs_torch"
    before = _tree(tmp_path)
    assert ap.archive_run(str(run), str(root)) == str(root / "r1")
    assert (root / "r1" / "metrics.json").read_text() == '{"iteration": 0}\n{"iteration": 20}\n'
    new = set(_tree(tmp_path)) - set(before)
    assert new == {str(root / "r1" / "metrics.json"), str(root / "r1" / "config.yaml")}
    # a fresh run under the same name: the longer curve moves aside, nothing is lost
    (run / "metrics.json").write_text('{"iteration": 0}\n')
    ap.archive_run(str(run), str(root))
    assert (root / "r1" / "metrics.json").read_text() == '{"iteration": 0}\n'
    assert (root / "r1" / "metrics.json.1").read_text().count("\n") == 2
    assert set(_tree(tmp_path)) - set(before) - new == {str(root / "r1" / "metrics.json.1")}


def test_archive_refuses_the_jax_record(tmp_path):
    run = tmp_path / "pt_from_source"
    run.mkdir()
    (run / "metrics.json").write_text('{"iteration": 0}\n')
    record_before = _tree(JAX_RUNS)
    assert ap.ARCHIVE_ROOT == os.path.join(REPO, "docs", "proxy_runs_torch")
    assert ap.build_parser().parse_args([]).archive == ap.ARCHIVE_ROOT
    for root in (JAX_RUNS, os.path.join(JAX_RUNS, "sub")):
        with pytest.raises(ValueError, match="JAX package's record"):
            ap.archive_run(str(run), root)
    # a run asked to archive there stops before it makes data or starts a child
    args = ap.build_parser().parse_args(["--archive", JAX_RUNS, "--out", str(run),
                                         "--data", str(tmp_path / "data")])
    with pytest.raises(ValueError, match="JAX package's record"):
        ap.run(args, launch=lambda *a: pytest.fail("the child was started"))
    assert not (tmp_path / "data").exists()
    assert _tree(JAX_RUNS) == record_before
