"""Port parity for evaluation: the COCO and VOC evaluators, and ``evaluate_detections``.

- ``cocoeval.COCOEvaluator`` and the VOC evaluator of the port give the JAX
  package's metrics on the same detections, within 1e-12: the 50-image x 8-class
  fixture of ``tests/test_cocoeval_fixture.py`` (crowds, difficult GTs, area
  ranges, score ties) and the hand cases of ``tests/test_evaluation.py``;
- slice level: ``evaluate_detections`` with the JAX detector and params, and with
  the port's ``PTDetector`` and ``params_from_jax`` weights, over the same val
  tree and loader. Detections: valid masks and classes equal, boxes within 1e-3,
  scores within 1e-4 (the limits of ``tests/test_torch_detector.py``); metrics
  within 1e-4 absolute. The GT is the JAX detector's own top detections, so that
  the metrics are not all zero. Anchors are sized to the 48 x 96 canvas (16-64
  px, as the detector test's are): the convolutions of XLA and oneDNN differ by
  ~2e-6 of the features, and a 512 px anchor turns that into ~1e-3 px of a box.
"""


import jax
import numpy as np
import pytest

from probabilisticteacher_tpu import cocoeval as jcoco
from probabilisticteacher_tpu import evaluation as jeval
from probabilisticteacher_tpu.config import get_cfg as jget_cfg
from probabilisticteacher_tpu.data.datasets import load_voc_instances
from probabilisticteacher_tpu.data.loader import EvalLoader as JEvalLoader
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch import cocoeval as tcoco
from probabilisticteacher_torch import evaluation as teval
from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.data.loader import EvalLoader
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.weights import params_from_jax
from synthetic_data import CLASSES, make_voc_dataset
from test_cocoeval_fixture import CLASSES as COCO_CLASSES
from test_cocoeval_fixture import build_fixture
from torch_micro import micro_opts

EXACT = 1e-12
BOX_ATOL, SCORE_ATOL, METRIC_ATOL = 1e-3, 1e-4, 1e-4


def _same_metrics(got, want, atol):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= atol, (k, got[k], v)


def _feed(ev, gts, dts, n_images=50, crowd=True):
    for img in range(n_images):
        g = [r for r in gts if r[0] == img]
        kw = {"iscrowd": [r[4] for r in g]} if crowd else {}
        ev.add_ground_truth(img, np.asarray([r[2] for r in g], np.float32).reshape(-1, 4),
                            np.asarray([r[1] for r in g]),
                            difficult=np.asarray([r[3] for r in g], bool), **kw)
        d = [r for r in dts if r[0] == img]
        ev.add_detections(img, np.asarray([r[2] for r in d], np.float32).reshape(-1, 4),
                          np.asarray([r[3] for r in d]), np.asarray([r[1] for r in d]))
    return ev.evaluate()


def test_coco_fixture_matches_jax():
    gts, dts = build_fixture()
    want = _feed(jcoco.COCOEvaluator(COCO_CLASSES), gts, dts)
    got = _feed(tcoco.COCOEvaluator(COCO_CLASSES), gts, dts)
    _same_metrics(got, want, EXACT)
    assert got["bbox/AP50"] > 0


def test_voc_fixture_matches_jax():
    gts, dts = build_fixture()
    want = _feed(jeval.DetectionEvaluator(COCO_CLASSES, "voc"), gts, dts, crowd=False)
    got = _feed(teval.DetectionEvaluator(COCO_CLASSES, "voc"), gts, dts, crowd=False)
    _same_metrics(got, want, EXACT)
    assert got["mAP50"] > 0


# the hand cases of tests/test_evaluation.py: (gt [(img, boxes, classes, difficult)],
# dets [(img, boxes, scores, classes)])
HAND_CASES = {
    "two_classes": ([("a", [[10, 10, 50, 50], [60, 60, 90, 90]], [0, 1], None),
                     ("b", [[0, 0, 30, 30]], [0], None)],
                    [("a", [[10, 10, 50, 50]], [0.9], [0]), ("b", [[0, 0, 30, 30]], [0.8], [0]),
                     ("a", [[0, 0, 5, 5]], [0.7], [1])]),
    "duplicate_fp": ([("a", [[10, 10, 50, 50]], [0], None)],
                     [("a", [[10, 10, 50, 50], [11, 11, 51, 51]], [0.9, 0.8], [0, 0])]),
    "difficult": ([("a", [[10, 10, 50, 50], [60, 60, 90, 90]], [0, 0], [False, True])],
                  [("a", [[10, 10, 50, 50], [60, 60, 90, 90]], [0.9, 0.8], [0, 0])]),
    "fp_first": ([("a", [[10, 10, 60, 60]], [0], None)],
                 [("a", [[200, 200, 250, 250], [10, 10, 60, 60]], [0.9, 0.8], [0, 0])]),
}


@pytest.mark.parametrize("style", ["voc", "coco"])
@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_hand_cases_match_jax(case, style):
    gts, dts = HAND_CASES[case]
    out = []
    for mod in (jeval, teval):
        ev = mod.DetectionEvaluator(["car", "person"], style=style)
        for img, boxes, classes, diff in gts:
            ev.add_ground_truth(img, np.asarray(boxes), np.asarray(classes),
                                None if diff is None else np.asarray(diff))
        for img, boxes, scores, classes in dts:
            ev.add_detections(img, np.asarray(boxes), np.asarray(scores), np.asarray(classes))
        out.append(ev.evaluate())
    _same_metrics(out[1], out[0], EXACT)


def test_voc_ap_matches_jax():
    rng = np.random.RandomState(0)
    for _ in range(20):
        rec = np.sort(rng.rand(12))
        prec = rng.rand(12)
        for use_07 in (True, False):
            assert teval._voc_ap(rec, prec, use_07) == jeval._voc_ap(rec, prec, use_07)


# ------------------------------------------------------------------ slice level
def _scaled(params):
    p = jax.tree.map(np.asarray, params)
    p["rpn_head"]["objectness"]["kernel"] = p["rpn_head"]["objectness"]["kernel"] * 30
    p["predictor"]["cls_score"]["kernel"] = p["predictor"]["cls_score"]["kernel"] * 40
    p["predictor"]["bbox_pred"]["kernel"] = p["predictor"]["bbox_pred"]["kernel"] * 10
    return p


def test_evaluate_detections_matches_jax(tmp_path):
    root = make_voc_dataset(str(tmp_path / "val"), "val", num_images=4, seed=2)
    dicts = load_voc_instances(root, "val", CLASSES)
    opts = micro_opts(tmp_path, "l", "u", "v") + ["MODEL.ANCHOR_GENERATOR.SIZES",
                                                   "((16, 32, 64),)"]
    jcfg, tcfg = jget_cfg(), get_cfg()
    jcfg.merge_from_list(opts)
    tcfg.merge_from_list(opts)
    jcfg.TEST.IMS_PER_BATCH = tcfg.TEST.IMS_PER_BATCH = 2
    jdet = JDetector(JArch.from_cfg(jcfg))
    params_np = _scaled(jdet.init(jax.random.key(0), tuple(jcfg.INPUT.CANVAS.WIDE)))
    params = jax.tree.map(jax.numpy.asarray, params_np)
    arch = Arch.from_cfg(tcfg)
    tdet = PTDetector(arch, device="cpu")
    tdet.load_state_dict(params_from_jax(params_np, arch))

    seen_j, seen_t = [], []
    jdetect = jax.jit(jdet.detect)

    def jfn(p, images):
        out = jdetect(p, images)
        seen_j.append(jax.tree.map(np.asarray, out))
        return out

    tdetect = tdet.detect

    def tfn(images):
        out = tdetect(images)
        seen_t.append(out)
        return out

    tdet.detect = tfn
    # GT: the JAX detector's top 3 detections per image, in original coordinates
    batches = list(JEvalLoader(jcfg, dicts))
    gt_dicts = []
    for b in batches:
        d = jfn(params, JImageBatch(b["image"], b["image_hw"]))
        for j, image_id in enumerate(b["image_id"]):
            if image_id is None:
                continue
            v = np.asarray(d.valid[j])
            boxes = np.asarray(d.boxes[j])[v][:3] / b["scale"][j]
            classes = np.asarray(d.classes[j])[v][:3]
            gt_dicts.append({"image_id": image_id, "annotations": [
                {"bbox": bx.tolist(), "category_id": int(c)} for bx, c in zip(boxes, classes)]})
    seen_j.clear()
    assert sum(len(g["annotations"]) for g in gt_dicts) > 0

    want = jeval.evaluate_detections(jdet, params, JEvalLoader(jcfg, dicts), CLASSES,
                                     jit_fn=jfn, gt_dicts=gt_dicts)
    got = teval.evaluate_detections(tdet, EvalLoader(tcfg, dicts), CLASSES, gt_dicts=gt_dicts)
    assert len(seen_j) == len(seen_t) == 2
    for jd, td in zip(seen_j, seen_t):
        np.testing.assert_array_equal(td.valid.numpy(), jd.valid)
        v = jd.valid
        assert v.any()
        np.testing.assert_array_equal(td.classes.numpy()[v], jd.classes[v])
        np.testing.assert_allclose(td.boxes.numpy()[v], jd.boxes[v], rtol=0, atol=BOX_ATOL)
        np.testing.assert_allclose(td.scores.numpy()[v], jd.scores[v], rtol=0, atol=SCORE_ATOL)
    _same_metrics(got, want, METRIC_ATOL)
    assert want["mAP50"] > 0
