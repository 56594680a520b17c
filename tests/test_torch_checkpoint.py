"""Port checkpoints: save/resume round trips, weight imports and ``Predictor(checkpoint_path=...)``.

- ``save_checkpoint`` / ``load_checkpoint`` restore teacher, student, the
  optimizer's momentum and update count, and the step bit for bit; the ``keep``
  rotation, the ``last_checkpoint`` marker, named saves, weights-only loads and
  shape-mismatch skipping behave as in the JAX package's ``checkpoint.py``;
- ``load_vgg_caffe`` on a synthetic torchvision-layout ``.npz`` and ``.pth`` equals
  ``params_from_jax`` of JAX's ``load_vgg_caffe``, bit for bit;
- ``load_detectron2_weights`` on a synthetic EnsembleTSModel ``.pth`` (detectron2
  names and layouts, as ``tests/test_d2_import.py`` builds them, learnable anchors
  included) equals ``params_from_jax`` of JAX's import bit for bit, and ``detect``
  with the imported weights equals ``detect`` with those weights assigned directly
  (the JAX test's check); a checkpoint written from JAX-initialised weights gives
  JAX's detections through both importers (the limits of
  ``tests/test_torch_detector.py``);
- ``Predictor(checkpoint_path=...)`` takes the teacher unless asked for the student.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.checkpoint import load_vgg_caffe as jload_vgg_caffe
from probabilisticteacher_tpu.d2_import import load_detectron2_weights as jload_d2
from probabilisticteacher_tpu.engine.steps import TrainState as JTrainState
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch import checkpoint as ckpt
from probabilisticteacher_torch import d2_import
from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.engine.steps import TrainState, create_train_state
from probabilisticteacher_torch.modeling.backbone import VGG_STAGES
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.predictor import Predictor
from probabilisticteacher_torch.solver import ClippedSGD
from probabilisticteacher_torch.structures import ImageBatch
from probabilisticteacher_torch.weights import params_from_jax

TINY = dict(num_classes=3, vgg_depth=11, fc_dim=16, rpn_pre_nms_topk=(150, 240),
            rpn_post_nms_topk=(40, 64), detections_per_image=12, learnable_anchors=True,
            anchor_init_wh=((48.0, 24.0), (32.0, 32.0), (24.0, 48.0), (64.0, 64.0)))


def _state(seed=0, steps=2):
    """A tiny CPU TrainState whose teacher differs from its student and whose
    optimizer has taken ``steps`` updates (non-zero momentum)."""
    student = PTDetector(Arch(**TINY), device="cpu")
    student.init(seed)
    opt = ClippedSGD(student.parameters(), lambda c: 0.01 * (c + 1), momentum=0.9,
                     weight_decay=1e-4)
    state = create_train_state(student, opt)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in student.parameters():
            p.grad = torch.randn(p.shape, generator=g)
        opt.step()
        state.step += 1
    with torch.no_grad():
        for p in state.teacher.parameters():
            p.add_(0.5)
    return state


def _sd_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def _opt_equal(a: ClippedSGD, b: ClippedSGD):
    sa, sb = a.state_dict(), b.state_dict()
    assert sa["count"] == sb["count"]
    assert sa["param_groups"] == sb["param_groups"]
    assert sa["state"].keys() == sb["state"].keys() and len(sa["state"]) > 0
    for i in sa["state"]:
        assert torch.equal(sa["state"][i]["trace"], sb["state"][i]["trace"]), i


def test_round_trip_bit_for_bit(tmp_path):
    state = _state(steps=3)
    path = ckpt.save_checkpoint(str(tmp_path), state)
    assert os.path.basename(path) == "model_0000003"
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    fresh = _state(seed=1, steps=0)
    assert ckpt.load_checkpoint(path, fresh) is fresh
    assert fresh.step == 3
    _sd_equal(fresh.student.state_dict(), state.student.state_dict())
    _sd_equal(fresh.teacher.state_dict(), state.teacher.state_dict())
    _opt_equal(fresh.optimizer, state.optimizer)
    # the resumed optimizer continues the schedule where the saved one stopped
    assert fresh.optimizer.count == 3


def test_resume_continues_identically(tmp_path):
    """Two more updates after a round trip equal two more updates without one."""
    a = _state(steps=2)
    path = ckpt.save_checkpoint(str(tmp_path), a)
    b = ckpt.load_checkpoint(path, _state(seed=4, steps=0))
    for st in (a, b):
        g = torch.Generator().manual_seed(9)
        for _ in range(2):
            for p in st.student.parameters():
                p.grad = torch.randn(p.shape, generator=g)
            st.optimizer.step()
    _sd_equal(a.student.state_dict(), b.student.state_dict())
    _opt_equal(a.optimizer, b.optimizer)


def test_keep_rotation_marker_and_named_saves(tmp_path):
    out = str(tmp_path / "run")
    state = _state(steps=0)
    for s in (1, 2, 3, 4):
        state.step = s
        ckpt.save_checkpoint(out, state, keep=2)
    kept = sorted(d for d in os.listdir(out) if d.startswith("model_"))
    assert kept == ["model_0000003", "model_0000004"]
    assert ckpt.latest_checkpoint(out).endswith("model_0000004")
    best = ckpt.save_checkpoint(out, state, keep=0, name="model_best")
    assert os.path.isfile(best)
    with open(os.path.join(out, "last_checkpoint")) as f:
        assert f.read() == "model_0000004"
    assert not [d for d in os.listdir(out) if d.endswith(".tmp")]
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_load_weights_only_and_student_only(tmp_path, monkeypatch):
    state = _state(steps=2)
    path = ckpt.save_checkpoint(str(tmp_path / "run"), state)
    fresh = _state(seed=1, steps=1)
    trace_before = fresh.optimizer.state_dict()
    ckpt.load_weights(path, fresh)
    _sd_equal(fresh.student.state_dict(), state.student.state_dict())
    _sd_equal(fresh.teacher.state_dict(), state.teacher.state_dict())
    assert fresh.step == 1 and fresh.optimizer.count == 1     # weights only
    for i, s in trace_before["state"].items():
        assert torch.equal(fresh.optimizer.state_dict()["state"][i]["trace"], s["trace"])
    other = _state(seed=2, steps=0)
    teacher0 = {k: v.clone() for k, v in other.teacher.state_dict().items()}
    monkeypatch.chdir(tmp_path)                               # a relative path loads too
    ckpt.load_weights(os.path.relpath(path, str(tmp_path)), other, student_only=True)
    _sd_equal(other.student.state_dict(), state.student.state_dict())
    _sd_equal(other.teacher.state_dict(), teacher0)


def test_shape_mismatch_keeps_init(tmp_path):
    state = _state(steps=0)
    path = ckpt.save_checkpoint(str(tmp_path), state)
    other = PTDetector(Arch(**{**TINY, "num_classes": 5}), device="cpu")
    other.init(7)
    cls0 = other.predictor.cls_score.weight.detach().clone()
    ckpt.load_weights(path, TrainState(0, other, PTDetector(other.arch, device="cpu"), None))
    assert torch.equal(other.predictor.cls_score.weight, cls0)
    assert torch.equal(other.backbone.block1_conv1.weight, state.student.backbone.block1_conv1.weight)


# ------------------------------------------------------------------ VGG import
def _torchvision_vgg(depth, seed):
    rng = np.random.RandomState(seed)
    raw, idx, cin = {}, 0, 3
    for channels in VGG_STAGES[depth]:
        for cout in channels:
            raw[f"features.{idx}.weight"] = rng.randn(cout, cin, 3, 3).astype(np.float32)
            raw[f"features.{idx}.bias"] = rng.randn(cout).astype(np.float32)
            cin = cout
            idx += 2
        idx += 1
    raw["classifier.0.weight"] = rng.randn(4, 4).astype(np.float32)   # ignored
    return raw


@pytest.mark.parametrize("ext", ["npz", "pth"])
def test_load_vgg_caffe_matches_jax(tmp_path, ext):
    arch_j, arch_t = JArch(**TINY), Arch(**TINY)
    params = jax.tree.map(np.asarray, JDetector(arch_j).init(jax.random.key(0), (64, 64)))
    raw = _torchvision_vgg(11, seed=3)
    path = str(tmp_path / f"vgg.{ext}")
    if ext == "npz":
        np.savez(path, **raw)
    else:
        torch.save({k: torch.from_numpy(v) for k, v in raw.items()}, path)
    want = params_from_jax(jax.tree.map(np.asarray, jload_vgg_caffe(params, path)), arch_t)
    got = ckpt.load_vgg_caffe(params_from_jax(params, arch_t), path)
    _sd_equal(got, want)
    np.testing.assert_array_equal(got["backbone.block2_conv1.weight"].numpy(),
                                  raw["features.3.weight"])
    with pytest.raises(FileNotFoundError):
        ckpt.load_vgg_caffe(got, str(tmp_path / "missing.npz"))


# ------------------------------------------------------------ detectron2 import
def _d2_state_dict(arch: Arch, num_anchors: int, seed: int):
    """detectron2-named torch weights for ``arch``, scaled so activations stay
    moderate (fan-in normal), and objectness/class weights scaled up so that
    scores are not near ties."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        return torch.from_numpy((rng.randn(*shape) * scale / np.sqrt(fan_in)).astype(np.float32))

    sd, cin = {}, 3
    for b, channels in enumerate(VGG_STAGES[arch.vgg_depth], start=1):
        for c, cout in enumerate(channels, start=1):
            sd[f"backbone.vgg_block{b}.0.conv{c}.weight"] = t(cout, cin, 3, 3, scale=1.4)
            sd[f"backbone.vgg_block{b}.0.conv{c}.bias"] = t(cout, scale=0.1)
            cin = cout
    a, k, f, p = num_anchors, arch.num_classes, arch.fc_dim, arch.pooler_resolution
    sd["proposal_generator.rpn_head.conv.weight"] = t(512, 512, 3, 3, scale=1.4)
    sd["proposal_generator.rpn_head.conv.bias"] = t(512, scale=0.1)
    sd["proposal_generator.rpn_head.objectness_logits.weight"] = t(a, 512, 1, 1, scale=3)
    sd["proposal_generator.rpn_head.objectness_logits.bias"] = t(a)
    sd["proposal_generator.rpn_head.anchor_deltas.weight"] = t(a * 8, 512, 1, 1, scale=0.1)
    sd["proposal_generator.rpn_head.anchor_deltas.bias"] = t(a * 8, scale=0.1)
    sd["roi_heads.box_head.fc1.weight"] = t(f, 512 * p * p, scale=1.4)
    sd["roi_heads.box_head.fc1.bias"] = t(f, scale=0.1)
    sd["roi_heads.box_head.fc2.weight"] = t(f, f, scale=1.4)
    sd["roi_heads.box_head.fc2.bias"] = t(f, scale=0.1)
    sd["roi_heads.box_predictor.cls_score.weight"] = t(k + 1, f, scale=4)
    sd["roi_heads.box_predictor.cls_score.bias"] = t(k + 1)
    sd["roi_heads.box_predictor.bbox_pred.weight"] = t(k * 8, f, scale=0.1)
    sd["roi_heads.box_predictor.bbox_pred.bias"] = t(k * 8, scale=0.1)
    sd["proposal_generator.anchor_generator.anchor_0"] = torch.from_numpy(
        np.asarray(arch.anchor_init_wh, np.float32) * rng.uniform(0.8, 1.2, (a, 1)).astype(
            np.float32))
    sd["pixel_mean"] = torch.zeros(3, 1, 1)                    # ignored buffers
    sd["pixel_std"] = torch.ones(3, 1, 1)
    return sd


@pytest.fixture(scope="module")
def ensemble(tmp_path_factory):
    arch_t = Arch(**TINY)
    student, teacher = (_d2_state_dict(arch_t, len(TINY["anchor_init_wh"]), s) for s in (3, 4))
    full = {f"module.modelStudent.{k}": v for k, v in student.items()}
    full.update({f"module.modelTeacher.{k}": v for k, v in teacher.items()})
    path = str(tmp_path_factory.mktemp("d2") / "ensemble.pth")
    torch.save({"model": full, "iteration": 29999}, path)
    return path, student


def test_d2_import_matches_jax(ensemble):
    path, _ = ensemble
    arch_j, arch_t = JArch(**TINY), Arch(**TINY)
    jdet = JDetector(arch_j)
    params = jdet.init(jax.random.key(0), (64, 64))
    jstate = jload_d2(path, JTrainState(jnp.asarray(0), params, jax.tree.map(jnp.copy, params),
                                        ()))
    state = TrainState(0, PTDetector(arch_t, device="cpu"), PTDetector(arch_t, device="cpu"),
                       None)
    assert d2_import.is_d2_checkpoint(path)
    d2_import.load_detectron2_weights(path, state)
    for got, want in ((state.student, jstate.student), (state.teacher, jstate.teacher)):
        _sd_equal(got.state_dict(), params_from_jax(jax.tree.map(np.asarray, want), arch_t))
    assert not torch.equal(state.student.anchor_wh, state.teacher.anchor_wh)

    # detect with the imported weights == detect with params_from_jax of JAX's
    # import, bit for bit, and differs from the init's (the JAX test's check)
    direct = PTDetector(arch_t, device="cpu")
    direct.load_state_dict(params_from_jax(jax.tree.map(np.asarray, jstate.teacher), arch_t))
    init = PTDetector(arch_t, device="cpu")
    init.init(0)
    rng = np.random.RandomState(0)
    img = ImageBatch(torch.from_numpy(rng.randint(0, 255, (2, 64, 96, 3)).astype(np.float32)),
                     torch.tensor([[64.0, 96.0], [50.0, 80.0]]))
    with torch.no_grad():
        got, want, base = (m.detect(img) for m in (state.teacher, direct, init))
    assert got.valid.any()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert not torch.equal(got.scores, base.scores)


def _jax_to_d2(params) -> dict:
    """A JAX param tree written back in detectron2's names and layouts (the inverse
    of JAX's ``d2_to_params``)."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))

    sd = {}
    for name, p in params["backbone"].items():
        b, c = name[len("block"):].split("_conv")
        sd[f"backbone.vgg_block{b}.0.conv{c}.weight"] = t(p["kernel"].transpose(3, 2, 0, 1))
        sd[f"backbone.vgg_block{b}.0.conv{c}.bias"] = t(p["bias"])
    for ours, theirs in (("conv", "conv"), ("objectness", "objectness_logits"),
                         ("deltas", "anchor_deltas")):
        p = params["rpn_head"][ours]
        sd[f"proposal_generator.rpn_head.{theirs}.weight"] = t(p["kernel"].transpose(3, 2, 0, 1))
        sd[f"proposal_generator.rpn_head.{theirs}.bias"] = t(p["bias"])
    for name, p in params["box_head"].items():
        k = p["kernel"]
        if name == "fc1":                    # (P*P*C, F) HWC rows -> (F, C*P*P)
            q = 7
            k = k.reshape(q, q, -1, k.shape[1]).transpose(3, 2, 0, 1).reshape(k.shape[1], -1)
        else:
            k = k.T
        sd[f"roi_heads.box_head.{name}.weight"] = t(k)
        sd[f"roi_heads.box_head.{name}.bias"] = t(p["bias"])
    for name, p in params["predictor"].items():
        sd[f"roi_heads.box_predictor.{name}.weight"] = t(p["kernel"].T)
        sd[f"roi_heads.box_predictor.{name}.bias"] = t(p["bias"])
    sd["proposal_generator.anchor_generator.anchor_0"] = t(params["anchor_wh"])
    return sd


def test_d2_import_detect_matches_jax(tmp_path):
    """A detectron2 checkpoint written from JAX-initialised weights (objectness and
    class weights scaled up as in ``tests/test_torch_detector.py``) gives the same
    detections through both importers: masks and classes equal, boxes within 1e-3,
    scores within 1e-4 (that test's limits)."""
    arch_j, arch_t = JArch(**TINY), Arch(**TINY)
    jdet = JDetector(arch_j)
    params = jax.tree.map(np.asarray, jdet.init(jax.random.key(1), (64, 96)))
    params["rpn_head"]["objectness"]["kernel"] = params["rpn_head"]["objectness"]["kernel"] * 30
    params["predictor"]["cls_score"]["kernel"] = params["predictor"]["cls_score"]["kernel"] * 40
    params["predictor"]["bbox_pred"]["kernel"] = params["predictor"]["bbox_pred"]["kernel"] * 10
    path = str(tmp_path / "student.pth")
    torch.save({"model": _jax_to_d2(params)}, path)
    init = jdet.init(jax.random.key(0), (64, 96))
    jstate = jload_d2(path, JTrainState(jnp.asarray(0), init, jax.tree.map(jnp.copy, init), ()))
    jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jstate.student), params)
    state = TrainState(0, PTDetector(arch_t, device="cpu"), PTDetector(arch_t, device="cpu"),
                       None)
    d2_import.load_detectron2_weights(path, state)

    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (2, 64, 96, 3)).astype(np.float32)
    img[:, 20:44, 30:70] = rng.randint(0, 255, 3)    # a flat object
    hw = np.array([(64, 96), (50, 80)], np.float32)
    img[1, 50:] = 0
    img[1, :, 80:] = 0
    want = jax.jit(jdet.detect)(jstate.teacher, JImageBatch(jnp.asarray(img), jnp.asarray(hw)))
    with torch.no_grad():
        got = state.teacher.detect(ImageBatch(torch.from_numpy(img), torch.from_numpy(hw)))
    v = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), v)
    assert v.any()
    np.testing.assert_array_equal(got.classes.numpy()[v], np.asarray(want.classes)[v])
    np.testing.assert_allclose(got.boxes.numpy()[v], np.asarray(want.boxes)[v], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.scores.numpy()[v], np.asarray(want.scores)[v], rtol=0,
                               atol=1e-4)


def test_d2_fc1_flatten_matches_torch():
    """The port's fc1 over the HWC flatten of the pooled block equals the torch
    Linear over detectron2's CHW flatten."""
    torch.manual_seed(1)
    c, p, f = 24, 7, 16
    lin = torch.nn.Linear(c * p * p, f)
    x = torch.randn(3, c, p, p)
    w = torch.from_numpy(d2_import._fc1_weight(lin.weight.detach().numpy(), p))
    with torch.no_grad():
        want = lin(x.flatten(1))
        got = torch.nn.functional.linear(x.permute(0, 2, 3, 1).flatten(1), w, lin.bias)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_d2_student_only_report_and_mismatch(tmp_path, ensemble):
    _, student_sd = ensemble
    path = str(tmp_path / "student.pth")
    torch.save(student_sd, path)
    arch = Arch(**TINY)
    state = TrainState(0, PTDetector(arch, device="cpu"), PTDetector(arch, device="cpu"), None)
    d2_import.load_detectron2_weights(path, state)
    _sd_equal(state.student.state_dict(), state.teacher.state_dict())
    flat = d2_import.read_checkpoint_file(path)
    s, t = d2_import.split_ensemble(flat)
    assert t is None
    other = PTDetector(Arch(**{**TINY, "num_classes": 5}), device="cpu")
    new, report = d2_import.d2_to_params(s, other.state_dict())
    skipped = {k for k, _, _ in report["incorrect_shapes"]}
    assert skipped == {f"roi_heads.box_predictor.{n}.{w}" for n in ("cls_score", "bbox_pred")
                       for w in ("weight", "bias")}
    assert set(report["missing"]) == {
        f"predictor.{n}.{w}" for n in ("cls_score", "bbox_pred") for w in ("weight", "bias")}
    assert report["unexpected"] == []
    assert torch.equal(new["predictor.cls_score.weight"], other.predictor.cls_score.weight)


# ------------------------------------------------------------------- Predictor
def _predictor_cfg():
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.VGG.DEPTH", "11",
        "MODEL.ROI_BOX_HEAD.FC_DIM", "16", "SOLVER.AMP.ENABLED", "False",
        "MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
        "MODEL.ANCHOR_GENERATOR.ANCHOR", repr((TINY["anchor_init_wh"],)),
        "INPUT.CANVAS.WIDE", "(64, 96)", "INPUT.CANVAS.TALL", "(96, 64)",
        "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96"])
    assert dataclasses.asdict(Arch.from_cfg(cfg))["fc_dim"] == TINY["fc_dim"]
    return cfg


def test_predictor_loads_teacher_by_default(tmp_path, ensemble):
    state = _state(steps=1)
    path = ckpt.save_checkpoint(str(tmp_path), state)
    cfg = _predictor_cfg()
    _sd_equal(Predictor(cfg, checkpoint_path=path, device="cpu").detector.state_dict(),
              state.teacher.state_dict())
    _sd_equal(Predictor(cfg, checkpoint_path=path, use_teacher=False,
                        device="cpu").detector.state_dict(), state.student.state_dict())
    d2_path, _ = ensemble
    d2 = TrainState(0, PTDetector(Arch(**TINY), device="cpu"),
                    PTDetector(Arch(**TINY), device="cpu"), None)
    d2_import.load_detectron2_weights(d2_path, d2)
    _sd_equal(Predictor(cfg, checkpoint_path=d2_path, device="cpu").detector.state_dict(),
              d2.teacher.state_dict())
    out = Predictor(cfg, checkpoint_path=path, device="cpu")(
        np.random.RandomState(0).randint(0, 255, (64, 96, 3)).astype(np.uint8))
    assert set(out) == {"boxes", "scores", "classes"}
