"""Port parity for the training losses: every loss key and every parameter gradient
of ``supervised_losses``, ``unsupervised_losses`` and ``student_losses`` (fused, and
its split branch when the combined batch is not a multiple of 8), JAX
``jax.value_and_grad`` vs the port's autograd, on the CPU in f32.

The architecture is the TINY one of ``tests/test_engine.py`` with learnable anchors
and a proposal min size of 2 px: without it, proposals a fraction of a pixel tall
survive, and ``get_deltas`` against them (weights 10, 10, 5, 5) turns the ~1e-6
relative difference between XLA's and oneDNN's convolutions into 1e-3 of the box
head's gradient. JAX params reach the port through ``params_from_jax``, and the
JAX sampling draws are replayed into the port.

Tolerances: losses rtol 1e-5; sampling statistics equal; every gradient within
1e-4 of the largest entry of that parameter's JAX gradient. Parameters that JAX
gives a zero gradient (the frozen stem; ``anchor_wh`` outside the unsupervised
RPN loss) get none in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.structures import GroundTruth as JGroundTruth
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_tpu.structures import PseudoLabels as JPseudoLabels
from probabilisticteacher_torch.config import Arch
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.structures import GroundTruth, ImageBatch, PseudoLabels
from probabilisticteacher_torch.weights import params_from_jax
from torch_jax_draws import loss_draws, student_draws

TINY = dict(num_classes=3, vgg_depth=11, rpn_pre_nms_topk=(32, 32), rpn_post_nms_topk=(16, 16),
            rpn_batch_per_image=8, roi_batch_per_image=8, detections_per_image=4,
            unsup_roi_budget=8, fc_dim=16, learnable_anchors=True, rpn_min_size=2.0,
            anchor_init_wh=((24.0, 12.0), (16.0, 16.0), (12.0, 24.0)))
H = W = 48
N, G = 4, 3
ANCHORS = (H // 16) * (W // 16) * 3
ROWS = TINY["rpn_post_nms_topk"][1] + G      # proposals + appended ground truth


@pytest.fixture(scope="module")
def setup():
    jdet = JDetector(JArch(**TINY))
    params = jdet.init(jax.random.key(0), (H, W))
    tdet = PTDetector(Arch(**TINY), device="cpu")
    tdet.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params), Arch(**TINY)))
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (N, H, W, 3)).astype(np.float32)
    hw = np.array([[48, 48], [40, 44], [48, 48], [36, 48]], np.float32)
    boxes = np.zeros((N, G, 4), np.float32)
    for i in range(N):
        for j in range(G):
            x1, y1 = rng.uniform(0, 24, 2)
            boxes[i, j] = [x1, y1, x1 + rng.uniform(4, 16), y1 + rng.uniform(4, 16)]
    cls = rng.randint(0, 3, (N, G)).astype(np.int32)
    valid = np.ones((N, G), bool)
    valid[1, 2] = False                          # a padded ground-truth row
    jb = JImageBatch(jnp.asarray(img), jnp.asarray(hw))
    tb = ImageBatch(torch.from_numpy(img), torch.from_numpy(hw))
    jgt = JGroundTruth(jnp.asarray(boxes), jnp.asarray(cls), jnp.asarray(valid))
    tgt = GroundTruth(torch.from_numpy(boxes), torch.from_numpy(cls), torch.from_numpy(valid))
    # the teacher's pseudo-labels from the JAX detector, given to both sides
    pl = jax.jit(jdet.pseudo_labels)(params, jb)
    assert np.asarray(pl.valid).any()
    tpl = PseudoLabels(*(torch.from_numpy(np.array(x)) for x in pl))
    return jdet, params, tdet, jb, tb, jgt, tgt, pl, tpl


def _total(*dicts):
    return sum(v for d in dicts for k, v in d.items() if k.startswith("loss"))


def _compare(want_losses, got_losses, want_grads, tdet, anchor_grad):
    for wl, gl in zip(want_losses, got_losses):
        assert set(wl) == set(gl)
        for k in wl:
            w, g = float(wl[k]), float(gl[k].detach())
            if k.startswith("loss"):
                np.testing.assert_allclose(g, w, rtol=1e-5, err_msg=k)
            else:
                assert g == w, (k, g, w)
    want = params_from_jax(jax.tree.map(np.asarray, want_grads), tdet.arch)
    for name, p in tdet.named_parameters():
        w = want[name].numpy()
        if p.grad is None:
            assert not w.any(), name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)
    has = tdet.anchor_wh.grad is not None and bool(tdet.anchor_wh.grad.abs().sum() > 0)
    assert has == anchor_grad


def test_supervised_losses(setup):
    jdet, params, tdet, jb, tb, jgt, tgt, _, _ = setup
    key = jax.random.key(3)

    def fn(p):
        losses = jdet.supervised_losses(p, jb, jgt, key)
        return _total(losses), losses

    (_, want), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    tdet.zero_grad(set_to_none=True)
    got = tdet.supervised_losses(tb, tgt, loss_draws(key, N, ANCHORS, ROWS))
    _total(got).backward()
    assert float(got["roi_head/num_fg_samples"].detach()) > 0
    _compare([want], [got], grads, tdet, anchor_grad=False)


def test_unsupervised_losses(setup):
    jdet, params, tdet, jb, tb, _, _, pl, tpl = setup

    def fn(p):
        losses = jdet.unsupervised_losses(p, jb, JPseudoLabels(*pl), jax.random.key(0))
        return _total(losses), losses

    (_, want), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    tdet.zero_grad(set_to_none=True)
    got = tdet.unsupervised_losses(tb, tpl)
    _total(got).backward()
    assert float(got["loss_box_reg"].detach()) > 0 and float(got["loss_rpn_loc"].detach()) > 0
    _compare([want], [got], grads, tdet, anchor_grad=True)


@pytest.mark.parametrize("n_l,n_u", [(4, 4), (4, 2)], ids=["fused", "split"])
def test_student_losses(setup, n_l, n_u):
    jdet, params, tdet, jb, tb, jgt, tgt, pl, tpl = setup
    key = jax.random.key(3)
    jl, ju = JImageBatch(jb.image[:n_l], jb.image_hw[:n_l]), JImageBatch(jb.image[:n_u],
                                                                         jb.image_hw[:n_u])
    jpl = JPseudoLabels(*(x[:n_u] for x in pl))

    def fn(p):
        sup, unsup = jdet.student_losses(p, jl, JGroundTruth(*(x[:n_l] for x in jgt)), ju, jpl,
                                         key)
        return _total(sup, unsup), (sup, unsup)

    (_, want), grads = jax.jit(jax.value_and_grad(fn, has_aux=True))(params)
    tdet.zero_grad(set_to_none=True)
    got = tdet.student_losses(
        ImageBatch(tb.image[:n_l], tb.image_hw[:n_l]), GroundTruth(*(x[:n_l] for x in tgt)),
        ImageBatch(tb.image[:n_u], tb.image_hw[:n_u]), PseudoLabels(*(x[:n_u] for x in tpl)),
        student_draws(key, n_l, n_u, ANCHORS, ROWS))
    _total(*got).backward()
    _compare(want, got, grads, tdet, anchor_grad=True)
