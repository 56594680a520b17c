"""Port parity for the opt-in levers, JAX vs the PyTorch port on the CPU.

- ``maxpool_keep`` and ``maxpool_nms_select`` on score grids with planted ties and
  rows that are -inf throughout: keep masks, indices and valid masks exactly equal
  (every tied maximum is kept; the selection takes the lower index first among
  ties, as ``jax.lax.top_k`` does);
- ``predict_proposals`` under every ``MODEL.RPN.NMS_IMPL`` (``greedy``,
  ``maxpool``, ``maxpool_train``, ``hybrid``), with the default anchor generator
  and with learnable anchors, from the same RPN outputs: valid masks equal, boxes
  within 1e-6 of their magnitude, scores within 1e-5 relative (an ulp of the
  sigmoid differs between XLA and PyTorch); the anchor sets hold both
  channels that the hybrid prefilter may thin (min side >= stride /
  (1 - sqrt(2t / (1 + t))), 173 px at t = 0.7) and channels it must leave alone;
- ``detect`` and ``pseudo_labels`` end to end under each lever, and
  ``pseudo_labels`` with the teacher's budgets (``TEACHER_PRE/POST_NMS_TOPK``) and
  candidate prefilter (``TEACHER_NMS_CANDIDATES``) set: valid masks and classes
  equal, boxes within 1e-3, scores, logits and sigma within 1e-4 (the tolerances of
  ``tests/test_torch_detector.py``);
- ``MODEL.BACKBONE.REMAT``: the student's losses and every parameter gradient
  bit-identical with the conv stack checkpointed and without;
- ``grad_zero`` and ``grad_reverse`` against ``jax.vjp`` of the JAX functions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.ops import grad as jgrad
from probabilisticteacher_tpu.ops import maxpool_nms as jmp
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch.config import Arch
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.ops import grad as tgrad
from probabilisticteacher_torch.ops import maxpool_nms as tmp
from probabilisticteacher_torch.structures import GroundTruth, ImageBatch, PseudoLabels
from probabilisticteacher_torch.weights import params_from_jax
from torch_jax_draws import student_draws

LEVERS = ["maxpool", "maxpool_train", "hybrid"]
BIG = ((256.0, 180.0), (200.0, 200.0))             # safe channels for the hybrid prefilter
BASE = dict(num_classes=3, vgg_depth=11, rpn_pre_nms_topk=(150, 240),
            rpn_post_nms_topk=(40, 64), detections_per_image=12, fc_dim=32)
ANCHOR_SETS = {
    "fixed": dict(anchor_sizes=(32.0, 64.0, 256.0), anchor_aspects=(0.5, 1.0, 2.0)),
    "learnable": dict(learnable_anchors=True,
                      anchor_init_wh=((48.0, 24.0), (32.0, 32.0), (24.0, 48.0)) + BIG),
}
CANVAS = (64, 96)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ maxpool ops
def _tied_scores(seed, n=3, h=5, w=7, a=3):
    """bf16-quantised scores (many ties), a plateau, one all -inf image and one -inf
    anchor channel."""
    rng = np.random.RandomState(seed)
    s = rng.randn(n, h, w, a).astype(np.float32)
    s = np.array(jnp.asarray(s, jnp.bfloat16).astype(jnp.float32))
    s[0, 1:4, 2:5, 1] = 2.5                 # a 3 x 3 plateau of tied maxima
    s[0, 0, 0, :] = 3.0                     # ties across the anchors of one location
    s[1] = -np.inf                          # an image with nothing
    s[2, :, :, 2] = -np.inf                 # a channel with nothing
    return s


@pytest.mark.parametrize("cross_anchor", [True, False])
@pytest.mark.parametrize("pool", [3, 5])
def test_maxpool_keep_matches_jax(pool, cross_anchor):
    s = _tied_scores(0)
    want = np.stack([np.asarray(jmp.maxpool_keep(jnp.asarray(x), pool, cross_anchor))
                     for x in s])
    got = _np(tmp.maxpool_keep(torch.from_numpy(s), pool, cross_anchor))
    np.testing.assert_array_equal(got, want)
    if pool == 3 and not cross_anchor:
        assert want[0, 1:4, 2:5, 1].all()                      # every tied maximum kept
    assert want[1].all()                                       # -inf >= -inf everywhere


@pytest.mark.parametrize("post", [8, 40])
def test_maxpool_nms_select_matches_jax(post):
    s = _tied_scores(1)
    n, h, w, a = s.shape
    flat = s.reshape(n, -1)
    want = [jmp.maxpool_nms_select(jnp.asarray(x), (h, w), a, post) for x in flat]
    idx, valid = tmp.maxpool_nms_select(torch.from_numpy(flat), (h, w), a, post)
    np.testing.assert_array_equal(_np(idx), np.stack([np.asarray(i) for i, _ in want]))
    np.testing.assert_array_equal(_np(valid), np.stack([np.asarray(v) for _, v in want]))
    assert not _np(valid)[1].any()               # the all -inf image selects nothing
    np.testing.assert_array_equal(_np(idx)[1], np.arange(post))   # lower index first


# ------------------------------------------------------------------ detector
def _scaled(params):
    p = jax.tree.map(np.asarray, params)
    p["rpn_head"]["objectness"]["kernel"] = p["rpn_head"]["objectness"]["kernel"] * 30
    p["predictor"]["cls_score"]["kernel"] = p["predictor"]["cls_score"]["kernel"] * 40
    p["predictor"]["bbox_pred"]["kernel"] = p["predictor"]["bbox_pred"]["kernel"] * 10
    return p


@pytest.fixture(scope="module", params=list(ANCHOR_SETS))
def pair(request):
    kw = {**BASE, **ANCHOR_SETS[request.param]}
    jdet = JDetector(JArch(**kw))
    params_np = _scaled(jdet.init(jax.random.key(0), CANVAS))
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (2, *CANVAS, 3)).astype(np.float32)
    img[:, 20:44, 30:70] = rng.randint(0, 255, 3)    # a flat object
    hw = np.array([CANVAS, (50, 80)], np.float32)
    img[1, 50:] = 0
    img[1, :, 80:] = 0
    params = jax.tree.map(jnp.asarray, params_np)
    f_j = jdet.features(params, JImageBatch(jnp.asarray(img), jnp.asarray(hw)))
    rpn = (jdet.anchors(params, f_j.shape[1], f_j.shape[2]),
           *jdet.rpn_predict(params, f_j), tuple(f_j.shape[1:3]))
    return kw, params, params_np, img, hw, rpn


def _detectors(pair, **arch):
    kw, params, params_np, img, hw, _ = pair
    jarch, tarch = JArch(**{**kw, **arch}), Arch(**{**kw, **arch})
    tdet = PTDetector(tarch, device="cpu")
    tdet.load_state_dict(params_from_jax(params_np, tarch))
    return (JDetector(jarch), params, JImageBatch(jnp.asarray(img), jnp.asarray(hw)),
            tdet, ImageBatch(torch.from_numpy(img), torch.from_numpy(hw)))


@pytest.mark.parametrize("impl,training", [("greedy", True), ("maxpool", False),
                                           ("maxpool_train", True), ("maxpool_train", False),
                                           ("hybrid", True), ("hybrid", False)])
def test_predict_proposals_matches_jax(pair, impl, training):
    jdet, params, jb, tdet, tb = _detectors(pair, rpn_nms_impl=impl)
    anchors, obj, deltas, grid_hw = pair[-1]
    want = jax.jit(jdet.predict_proposals, static_argnames=("training", "grid_hw"))(
        anchors, obj, deltas, jb.image_hw, training=training, grid_hw=grid_hw)
    got = tdet.predict_proposals(torch.tensor(np.asarray(anchors)), torch.tensor(np.asarray(obj)),
                                 torch.tensor(np.asarray(deltas)), tb.image_hw, training,
                                 grid_hw=grid_hw)
    v = _np(want.valid)
    np.testing.assert_array_equal(_np(got.valid), v)
    assert v.sum(-1).min() > 0
    scale = np.abs(_np(want.boxes)[v]).max()
    np.testing.assert_allclose(_np(got.boxes)[v], _np(want.boxes)[v], rtol=0, atol=1e-6 * scale)
    np.testing.assert_allclose(_np(got.logits)[v], _np(want.logits)[v], rtol=1e-5, atol=1e-6)
    if impl == "hybrid":
        # the prefilter thinned some channels and left others whole
        a = tdet.arch
        q = np.sqrt(2 * a.rpn_nms_thresh / (1 + a.rpn_nms_thresh))
        cell = np.asarray(anchors).reshape(*grid_hw, tdet.A, 4)[0, 0]
        side = np.minimum(cell[:, 2] - cell[:, 0], cell[:, 3] - cell[:, 1])
        safe = side >= a.stride / (1 - q)
        assert safe.any() and not safe.all()


def _assert_detections(got, want):
    v = _np(want.valid)
    np.testing.assert_array_equal(_np(got.valid), v)
    assert v.any()
    if hasattr(want, "classes"):
        np.testing.assert_array_equal(_np(got.classes)[v], _np(want.classes)[v])
        np.testing.assert_allclose(_np(got.scores)[v], _np(want.scores)[v], rtol=0, atol=1e-4)
    np.testing.assert_allclose(_np(got.boxes)[v], _np(want.boxes)[v], rtol=0, atol=1e-3)
    for field in ("logits", "sigma"):
        np.testing.assert_allclose(_np(getattr(got, field))[v], _np(getattr(want, field))[v],
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("pair", ["learnable"], indirect=True)
@pytest.mark.parametrize("impl", LEVERS)
def test_detect_and_pseudo_labels_under_levers(pair, impl):
    jdet, params, jb, tdet, tb = _detectors(pair, rpn_nms_impl=impl)
    _assert_detections(tdet.detect(tb), jax.jit(jdet.detect)(params, jb))
    _assert_detections(tdet.pseudo_labels(tb), jax.jit(jdet.pseudo_labels)(params, jb))


@pytest.mark.parametrize("impl", ["greedy", "hybrid"])
def test_teacher_budgets_match_jax(pair, impl):
    jdet, params, jb, tdet, tb = _detectors(pair, rpn_nms_impl=impl, teacher_pre_nms_topk=100,
                                            teacher_post_nms_topk=24, teacher_nms_candidates=60)
    _assert_detections(tdet.pseudo_labels(tb), jax.jit(jdet.pseudo_labels)(params, jb))


# ------------------------------------------------------------------ REMAT
def test_remat_gradients_are_bit_identical():
    """The fused student pass with the trainable conv stack checkpointed and without
    (FREEZE_AT 2 of a VGG-11: blocks 3-5 are recomputed in the backward)."""
    kw = dict(num_classes=3, vgg_depth=11, rpn_pre_nms_topk=(32, 32),
              rpn_post_nms_topk=(16, 16), rpn_batch_per_image=8, roi_batch_per_image=8,
              detections_per_image=4, unsup_roi_budget=8, fc_dim=16, learnable_anchors=True,
              rpn_min_size=2.0, anchor_init_wh=((24.0, 12.0), (16.0, 16.0), (12.0, 24.0)))
    h = w = 48
    rng = np.random.RandomState(0)
    img = torch.from_numpy(rng.randint(0, 255, (4, h, w, 3)).astype(np.float32))
    img[:, 8:30, 8:30] = 128.0                            # flat: tied max-pool windows
    hw = torch.tensor([[48.0, 48.0], [40.0, 44.0]] * 2)
    xy = rng.uniform(0, 24, (4, 3, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 16, (4, 3, 2))], -1).astype(np.float32)
    gt = GroundTruth(torch.from_numpy(boxes), torch.from_numpy(rng.randint(0, 3, (4, 3))).int(),
                     torch.ones(4, 3, dtype=torch.bool))
    pseudo = PseudoLabels(gt.boxes[:2], torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32)),
                          torch.from_numpy(rng.randn(2, 3, 4).astype(np.float32)),
                          gt.valid[:2])
    draws = student_draws(jax.random.key(3), 4, 2, (h // 16) * (w // 16) * 3, 16 + 3)
    results = []
    for remat in (False, True):
        det = PTDetector(Arch(**kw, remat_backbone=remat), device="cpu")
        det.init(seed=1)
        sup, unsup = det.student_losses(ImageBatch(img[:4], hw), gt, ImageBatch(img[:2], hw[:2]),
                                        pseudo, draws)
        losses = {**{k + "_sup": v for k, v in sup.items()},
                  **{k + "_unsup": v for k, v in unsup.items()}}
        sum(v for k, v in losses.items() if k.startswith("loss")).backward()
        results.append((losses, {k: p.grad for k, p in det.named_parameters()
                                 if p.grad is not None}))
    (l0, g0), (l1, g1) = results
    assert det.backbone.remat and l0.keys() == l1.keys() and g0.keys() == g1.keys()
    assert "backbone.block3_conv1.weight" in g1 and "backbone.block2_conv1.weight" not in g1
    for k in l0:
        assert torch.equal(l0[k], l1[k]), k
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


# ------------------------------------------------------------------ grad utilities
@pytest.mark.parametrize("alpha", [0.1, 2.5])
def test_grad_utilities_match_jax_vjp(alpha):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5).astype(np.float32)
    g = rng.randn(3, 5).astype(np.float32)
    for jfn, tfn in ((jgrad.grad_zero, tgrad.grad_zero),
                     (lambda v: jgrad.grad_reverse(v, alpha),
                      lambda v: tgrad.grad_reverse(v, alpha))):
        y_j, vjp = jax.vjp(jfn, jnp.asarray(x))
        (dx_j,) = vjp(jnp.asarray(g))
        xt = torch.from_numpy(x).requires_grad_(True)
        y_t = tfn(xt)
        dx_t = (torch.autograd.grad(y_t, xt, torch.from_numpy(g))[0] if y_t.requires_grad
                else torch.zeros_like(xt))           # grad_zero cuts the graph
        np.testing.assert_array_equal(_np(y_t), np.asarray(y_j))
        np.testing.assert_array_equal(_np(dx_t), np.asarray(dx_j))
