"""Port parity for the inference slice: JAX ``PTDetector`` vs the PyTorch port on the CPU.

A tiny architecture (VGG-11, learnable anchors, small proposal budgets, f32) is
initialised in JAX; its params go to the port through ``weights.params_from_jax``.
The same seeded images then go through both packages:

- ``features``, ``rpn_predict`` and ``roi_predict``: rtol/atol 1e-4;
- ``detect`` and ``pseudo_labels``, with JAX on ``NMS_IMPL greedy`` (the blocked
  solver) and on ``pallas`` (the scan kernel, interpret mode): valid masks and
  classes equal, boxes within 1e-3, scores within 1e-4, logits and sigma 1e-4;
- the port's ``_roi_inference`` fed JAX's own proposals, so that a near tie in the
  RPN cannot hide a fault downstream;
- ``Predictor`` on a raw image against the JAX ``Predictor`` with the same params.

The objectness and class-score weights are scaled up from their small initial
values so that scores spread out instead of sitting in near ties, and the box-delta
weights so that detections move off their proposals; both packages get the same
scaled weights. bf16 is held on the card by ``chip_smoke.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu import config as jcfg
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.predictor import Predictor as JPredictor
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch import config as tcfg
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.predictor import Predictor
from probabilisticteacher_torch.structures import ImageBatch, Proposals
from probabilisticteacher_torch.weights import params_from_jax

TINY = dict(
    num_classes=3, vgg_depth=11, rpn_pre_nms_topk=(150, 240), rpn_post_nms_topk=(40, 64),
    detections_per_image=12, fc_dim=32, learnable_anchors=True,
    anchor_init_wh=((48.0, 24.0), (32.0, 32.0), (24.0, 48.0), (64.0, 64.0)),
)
CANVAS = (64, 96)
RTOL = ATOL = 1e-4


def _scaled(params):
    p = jax.tree.map(np.asarray, params)
    p["rpn_head"]["objectness"]["kernel"] = p["rpn_head"]["objectness"]["kernel"] * 30
    p["predictor"]["cls_score"]["kernel"] = p["predictor"]["cls_score"]["kernel"] * 40
    p["predictor"]["bbox_pred"]["kernel"] = p["predictor"]["bbox_pred"]["kernel"] * 10
    return p


@pytest.fixture(scope="module")
def pair():
    arch_j, arch_t = JArch(**TINY), tcfg.Arch(**TINY)
    jdet = JDetector(arch_j)
    params_np = _scaled(jdet.init(jax.random.key(0), CANVAS))
    tdet = PTDetector(arch_t, device="cpu")
    tdet.load_state_dict(params_from_jax(params_np, arch_t))
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (2, *CANVAS, 3)).astype(np.float32)
    img[:, 20:44, 30:70] = rng.randint(0, 255, 3)    # a flat object
    hw = np.array([CANVAS, (50, 80)], np.float32)
    img[1, 50:] = 0
    img[1, :, 80:] = 0
    jb = JImageBatch(jnp.asarray(img), jnp.asarray(hw))
    tb = ImageBatch(torch.from_numpy(img), torch.from_numpy(hw))
    params = jax.tree.map(jnp.asarray, params_np)
    return jdet, params, params_np, tdet, jb, tb


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol)


def _assert_detections(got, want):
    v = _np(want.valid)
    np.testing.assert_array_equal(_np(got.valid), v)
    assert v.any()
    if hasattr(want, "classes"):
        np.testing.assert_array_equal(_np(got.classes)[v], _np(want.classes)[v])
        _close(_np(got.scores)[v], _np(want.scores)[v], rtol=0, atol=1e-4)
    _close(_np(got.boxes)[v], _np(want.boxes)[v], rtol=0, atol=1e-3)
    _close(_np(got.logits)[v], _np(want.logits)[v])
    _close(_np(got.sigma)[v], _np(want.sigma)[v])


def test_weights_fill_every_port_parameter(pair):
    _, _, params_np, tdet, _, _ = pair
    sd = params_from_jax(params_np, tdet.arch)
    assert set(sd) == set(tdet.state_dict())
    # fc1 keeps the JAX kernel's HWC row order: weight is just its transpose
    np.testing.assert_array_equal(sd["box_head.fc1.weight"].numpy(),
                                  params_np["box_head"]["fc1"]["kernel"].T)


def test_features_rpn_and_roi_predict(pair):
    jdet, params, _, tdet, jb, tb = pair
    with torch.no_grad():
        f_t = tdet.features(tb)
        f_j = jdet.features(params, jb)
        _close(f_t, f_j, rtol=RTOL, atol=ATOL * float(np.abs(_np(f_j)).max()))
        feat = torch.tensor(np.asarray(f_j))   # same input to both heads
        obj_t, d_t = tdet.rpn_predict(feat)
        obj_j, d_j = jdet.rpn_predict(params, f_j)
        _close(obj_t, obj_j)
        _close(d_t, d_j)
        _close(tdet.anchors(feat.shape[1], feat.shape[2]),
               jdet.anchors(params, feat.shape[1], feat.shape[2]))
        rng = np.random.RandomState(1)
        xy = rng.uniform(-10, 90, (2, 30, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(4, 50, (2, 30, 2))], -1).astype(np.float32)
        s_t, p_t = tdet.roi_predict(feat, torch.from_numpy(boxes))
        s_j, p_j = jdet.roi_predict(params, f_j, jnp.asarray(boxes))
        _close(s_t, s_j)
        _close(p_t, p_j)


@pytest.mark.parametrize("impl", ["greedy", "pallas"])
def test_detect_and_pseudo_labels(pair, impl):
    jdet, params, _, tdet, jb, tb = pair
    jdet = JDetector(dataclasses.replace(jdet.arch, rpn_nms_impl=impl))
    _assert_detections(tdet.detect(tb), jax.jit(jdet.detect)(params, jb))
    _assert_detections(tdet.pseudo_labels(tb), jax.jit(jdet.pseudo_labels)(params, jb))


@pytest.mark.parametrize("candidates", [-1, 50])
def test_roi_inference_from_jax_proposals(pair, candidates):
    jdet, params, _, tdet, jb, tb = pair
    a = jdet.arch
    f_j = jdet.features(params, jb)
    obj, deltas = jdet.rpn_predict(params, f_j)
    anchors = jdet.anchors(params, f_j.shape[1], f_j.shape[2])
    props = jdet.predict_proposals(anchors, obj, deltas, jb.image_hw, training=True,
                                   grid_hw=f_j.shape[1:3], budget=None)
    want = jdet._roi_inference(params, f_j, props, jb.image_hw, nms_candidates=candidates)
    tprops = Proposals(*(torch.tensor(np.asarray(x)) for x in props))
    with torch.no_grad():
        got = tdet._roi_inference(torch.tensor(np.asarray(f_j)), tprops, tb.image_hw,
                                  nms_candidates=candidates)
        # the port's own proposals from the same RPN outputs match JAX's too
        tp = tdet.predict_proposals(torch.tensor(np.asarray(anchors)),
                                    torch.tensor(np.asarray(obj)),
                                    torch.tensor(np.asarray(deltas)), tb.image_hw, True)
    _assert_detections(got, want)
    np.testing.assert_array_equal(_np(tp.valid), _np(props.valid))
    v = _np(props.valid)
    _close(_np(tp.boxes)[v], _np(props.boxes)[v], rtol=0, atol=1e-3)
    _close(_np(tp.logits)[v], _np(props.logits)[v])
    assert a.rpn_post_nms_topk[1] == tp.boxes.shape[1]


def test_predictor_matches_jax_predictor(pair):
    _, _, params_np, _, _, _ = pair
    opts = ["MODEL.ROI_HEADS.NUM_CLASSES", "3", "MODEL.VGG.DEPTH", "11",
            "MODEL.ROI_BOX_HEAD.FC_DIM", "32", "SOLVER.AMP.ENABLED", "False",
            "MODEL.ANCHOR_GENERATOR.NAME", "DifferentiableAnchorGenerator",
            "MODEL.ANCHOR_GENERATOR.ANCHOR", repr((TINY["anchor_init_wh"],)),
            "MODEL.RPN.PRE_NMS_TOPK_TEST", "150", "MODEL.RPN.POST_NMS_TOPK_TEST", "40",
            "TEST.DETECTIONS_PER_IMAGE", "12", "INPUT.CANVAS.WIDE", repr(CANVAS),
            "INPUT.CANVAS.TALL", repr(CANVAS[::-1]),
            "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "96",
            "DATALOADER.NATIVE", "False"]
    cj, ct = jcfg.get_cfg(), tcfg.get_cfg()
    cj.merge_from_list(opts)
    ct.merge_from_list(opts)
    rng = np.random.RandomState(2)
    image = rng.randint(0, 255, (40, 72, 3)).astype(np.uint8)   # resized to 53 x 96
    want = JPredictor(cj, params=jax.tree.map(jnp.asarray, params_np))(image)
    got = Predictor(ct, jax_params=params_np, device="cpu")(image)
    assert len(want["scores"]) > 0
    np.testing.assert_array_equal(got["classes"], want["classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["boxes"], want["boxes"], rtol=0, atol=1e-3)
