"""Port parity for the solver and the train steps, JAX vs the port on the CPU.

- LR schedules: every scheduler at steps around warmup and milestones, rtol 1e-6;
- the optimizer against the JAX package's optax chain on the same gradients over
  several updates (clip active and not, weight decay, momentum, frozen blocks):
  parameters within 1e-6 of their scale;
- a trajectory: ``burnin_step`` x2, then ``mutual_step`` x1 across
  ``BURN_UP_STEP`` = 2, against JAX ``make_train_steps`` at TINY shapes with the JAX
  draws replayed. Metrics within rtol 1e-4; student and teacher parameters within
  1e-4 of each tensor's scale plus 1e-6 (a few f32 ulps of an update whose
  gradient sums in another order).

The data seed is one where no IoU of the 3 x 3-cell anchor grid sits within float
error of a matcher threshold or of a tie for a ground truth's best anchor: at this
size such a near tie flips a discrete match between XLA's fused and unfused
arithmetic alone, as it does between JAX and the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.config import get_cfg as jget_cfg
from probabilisticteacher_tpu.engine.steps import create_train_state as jcreate_train_state
from probabilisticteacher_tpu.engine.steps import make_train_steps as jmake_train_steps
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.modeling.detector import PTDetector as JDetector
from probabilisticteacher_tpu.solver import build_lr_schedule as jbuild_lr_schedule
from probabilisticteacher_tpu.solver import build_optimizer as jbuild_optimizer
from probabilisticteacher_tpu.structures import GroundTruth as JGroundTruth
from probabilisticteacher_tpu.structures import ImageBatch as JImageBatch
from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.engine.steps import create_train_state, make_train_steps
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.solver import build_lr_schedule, build_optimizer
from probabilisticteacher_torch.structures import GroundTruth, ImageBatch
from probabilisticteacher_torch.weights import params_from_jax
from torch_jax_draws import burnin_draws, mutual_draws

TINY = dict(num_classes=3, vgg_depth=11, rpn_pre_nms_topk=(32, 32), rpn_post_nms_topk=(16, 16),
            rpn_batch_per_image=8, roi_batch_per_image=8, detections_per_image=4,
            unsup_roi_budget=8, fc_dim=16, learnable_anchors=True, rpn_min_size=2.0,
            anchor_init_wh=((24.0, 12.0), (16.0, 16.0), (12.0, 24.0)))
H = W = 48


def _tiny_cfg(make):
    cfg = make()
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (100,)
    cfg.UNSUPNET.BURN_UP_STEP = 2
    cfg.UNSUPNET.EMA_KEEP_RATE = 0.5
    return cfg


# ------------------------------------------------------------------ solver
@pytest.mark.parametrize("name,method", [("WarmupMultiStepLR", "linear"),
                                         ("WarmupMultiStepLR", "constant"),
                                         ("WarmupCosineLR", "linear"),
                                         ("WarmupTwoStageMultiStepLR", "linear")])
def test_lr_schedules(name, method):
    cfgs = []
    for make in (jget_cfg, get_cfg):
        cfg = make()
        cfg.SOLVER.LR_SCHEDULER_NAME = name
        cfg.SOLVER.WARMUP_METHOD = method
        cfg.SOLVER.BASE_LR = 0.016
        cfg.SOLVER.WARMUP_ITERS = 400
        cfg.SOLVER.STEPS = (3000, 6000)
        cfg.SOLVER.MAX_ITER = 8000
        cfg.SOLVER.FACTOR_LIST = (1.0, 0.3, 0.05)
        cfgs.append(cfg)
    want, got = jbuild_lr_schedule(cfgs[0]), build_lr_schedule(cfgs[1])
    for it in (0, 1, 7, 399, 400, 401, 2999, 3000, 5999, 6000, 7999):
        np.testing.assert_allclose(got(it), float(want(it)), rtol=1e-6, err_msg=str(it))


@pytest.mark.parametrize("clip", [10.0, 1e-3], ids=["under", "over"])
def test_optimizer_matches_optax(clip):
    """Four updates from the same gradients. At the second, ``anchor_wh`` has no
    gradient in the port and a zero one in JAX: weight decay still moves it. The
    frozen stem (FREEZE_AT 2) stays where it was."""
    jarch = JArch(num_classes=2, vgg_depth=11, fc_dim=8, learnable_anchors=True)
    arch = Arch(num_classes=2, vgg_depth=11, fc_dim=8, learnable_anchors=True)
    params = JDetector(jarch).init(jax.random.key(1), (32, 32))
    start = params_from_jax(jax.tree.map(np.asarray, params), arch)
    cfgs = []
    for make in (jget_cfg, get_cfg):
        cfg = _tiny_cfg(make)
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = clip
        cfg.SOLVER.WEIGHT_DECAY = 0.01
        cfgs.append(cfg)
    tx = jbuild_optimizer(cfgs[0], params)
    opt_state = tx.init(params)
    update = jax.jit(tx.update)
    det = PTDetector(arch, device="cpu")
    det.load_state_dict(start)
    opt = build_optimizer(cfgs[1], det)
    rng = np.random.RandomState(0)
    for step in range(4):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.randn(*p.shape).astype(np.float32)),
                             params)
        if step == 1:
            grads["anchor_wh"] = jnp.zeros_like(grads["anchor_wh"])
        updates, opt_state = update(grads, opt_state, params)
        params = jax.tree.map(lambda p, u: p + u, params, updates)
        tgrads = params_from_jax(jax.tree.map(np.asarray, grads), arch)
        for name, p in det.named_parameters():
            p.grad = None if (step == 1 and name == "anchor_wh") else tgrads[name].clone()
        opt.step()
    want = params_from_jax(jax.tree.map(np.asarray, params), arch)
    for name, p in det.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-6 * max(np.abs(w).max(), 1.0), err_msg=name)
    assert torch.equal(det.backbone.block2_conv1.weight, start["backbone.block2_conv1.weight"])
    assert not torch.equal(det.backbone.block3_conv1.weight, start["backbone.block3_conv1.weight"])


# ------------------------------------------------------------------ trajectory
def _data(seed, n=2, g=3):
    rng = np.random.RandomState(seed)
    limg = rng.randint(0, 255, (n, H, W, 3)).astype(np.float32)
    lhw = np.array([[48, 48], [40, 44]], np.float32)
    uimg = rng.randint(0, 255, (n, H, W, 3)).astype(np.float32)
    uhw = np.array([[48, 48], [48, 48]], np.float32)
    boxes = np.zeros((n, g, 4), np.float32)
    for i in range(n):
        for j in range(g):
            x1, y1 = rng.uniform(0, 24, 2)
            boxes[i, j] = [x1, y1, x1 + rng.uniform(4, 16), y1 + rng.uniform(4, 16)]
    cls = rng.randint(0, 3, (n, g)).astype(np.int32)
    return limg, lhw, uimg, uhw, boxes, cls


def _close_params(jparams, det):
    want = params_from_jax(jax.tree.map(np.asarray, jparams), det.arch)
    for name, p in det.named_parameters():
        w = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6, err_msg=name)


def _close_metrics(jm, tm):
    assert set(jm) == set(tm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, atol=1e-6, err_msg=k)


def test_trajectory_burnin_then_mutual():
    jcfg, tcfg = _tiny_cfg(jget_cfg), _tiny_cfg(get_cfg)
    jdet = JDetector(JArch(**TINY))
    params = jax.tree.map(np.array, jdet.init(jax.random.key(0), (H, W)))
    # scaled scores so that the teacher's detections clear the score filter
    params["rpn_head"]["objectness"]["kernel"] *= 30
    params["predictor"]["cls_score"]["kernel"] *= 10
    params["predictor"]["cls_score"]["bias"][-1] = -6.0
    tx = jbuild_optimizer(jcfg, params)
    jstate = jcreate_train_state(jdet, tx, params=jax.tree.map(jnp.asarray, params))
    jburnin, jmutual = jmake_train_steps(jcfg, jdet, tx)

    det = PTDetector(Arch(**TINY), device="cpu")
    det.load_state_dict(params_from_jax(params, det.arch))
    state = create_train_state(det, build_optimizer(tcfg, det))
    burnin, mutual = make_train_steps(tcfg, det)

    limg, lhw, uimg, uhw, boxes, cls = _data(4)
    n, g = boxes.shape[:2]
    jl, ju = JImageBatch(jnp.asarray(limg), jnp.asarray(lhw)), JImageBatch(jnp.asarray(uimg),
                                                                           jnp.asarray(uhw))
    jgt = JGroundTruth(jnp.asarray(boxes), jnp.asarray(cls), jnp.ones((n, g), bool))
    tl = ImageBatch(torch.from_numpy(limg), torch.from_numpy(lhw))
    tu = ImageBatch(torch.from_numpy(uimg), torch.from_numpy(uhw))
    tgt = GroundTruth(torch.from_numpy(boxes), torch.from_numpy(cls),
                      torch.ones((n, g), dtype=torch.bool))
    key = jax.random.key(11)
    anchors = (H // 16) * (W // 16) * 3
    rows = TINY["rpn_post_nms_topk"][1] + g

    teacher0 = {k: v.clone() for k, v in state.teacher.state_dict().items()}
    for step in range(2):
        jstate, jm = jburnin(jstate, jl, jgt, key)
        state, tm = burnin(state, tl, tgt, burnin_draws(key, step, n, anchors, rows))
        assert state.step == step + 1
        _close_metrics(jm, tm)
        _close_params(jstate.student, state.student)
    for k, v in state.teacher.state_dict().items():     # burn-in leaves the teacher alone
        assert torch.equal(v, teacher0[k]), k

    student_pre = {k: v.clone() for k, v in state.student.state_dict().items()}
    jstate, jm = jmutual(jstate, jl, jgt, ju, key)
    state, tm = mutual(state, tl, tgt, tu, mutual_draws(key, 2, n, n, anchors, rows))
    assert state.step == 3
    _close_metrics(jm, tm)
    assert float(tm["num_pseudo_boxes"]) > 0 and float(tm["loss_box_reg_unsup"]) > 0
    # at the boundary the teacher becomes the pre-step student exactly
    for k, v in state.teacher.state_dict().items():
        assert torch.equal(v, student_pre[k]), k
    _close_params(jstate.student, state.student)
    _close_params(jstate.teacher, state.teacher)
