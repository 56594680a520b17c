"""Port parity: box ops, box regression, anchors and config, JAX vs PyTorch on the CPU.

The same numpy inputs, made from a seed, go through the JAX function and its
counterpart in ``probabilisticteacher_torch``. Tolerance: f32, 1e-6: absolute on
IoU, areas and clipped coordinates; on decoded boxes and deltas 1e-6 of the
largest magnitude in the output, since exp, log and a contracted multiply-add may
differ by an ulp between the two libraries and ``pcx - 0.5 * pw`` cancels.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu import config as jcfg
from probabilisticteacher_tpu.modeling import anchors_build as janchors
from probabilisticteacher_tpu.modeling.detector import Arch as JArch
from probabilisticteacher_tpu.ops import box_regression as jreg
from probabilisticteacher_tpu.ops import boxes as jboxes
from probabilisticteacher_torch import config as tcfg
from probabilisticteacher_torch.modeling import anchors_build as tanchors
from probabilisticteacher_torch.ops import box_regression as treg
from probabilisticteacher_torch.ops import boxes as tboxes

TOL = 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _boxes(rng, n, degenerate=True):
    xy = rng.uniform(-20, 200, (n, 2))
    wh = rng.uniform(0, 80, (n, 2))
    if degenerate:
        wh[::7] = 0.0          # empty boxes
        wh[3::11, 0] *= -1.0   # inverted boxes
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_area_and_pairwise_iou():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 40), _boxes(rng, 55)
    b[:5] = a[:5]              # identical pairs
    np.testing.assert_allclose(tboxes.area(torch.from_numpy(a)).numpy(),
                               np.asarray(jboxes.area(jnp.asarray(a))), rtol=0, atol=TOL)
    want = np.asarray(jboxes.pairwise_iou(jnp.asarray(a), jnp.asarray(b)))
    got = tboxes.pairwise_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # batched form agrees with the JAX batched function
    want_b = np.asarray(jboxes.pairwise_iou_batched(jnp.asarray(a[None]), jnp.asarray(b[None])))
    got_b = tboxes.pairwise_iou(torch.from_numpy(a[None]), torch.from_numpy(b[None])).numpy()
    np.testing.assert_allclose(got_b, want_b, rtol=0, atol=TOL)


def test_clip_boxes_and_nonempty():
    rng = np.random.RandomState(1)
    bx = _boxes(rng, 3 * 50).reshape(3, 50, 4)
    hw = np.array([[120, 160], [64, 200], [150, 90]], np.float32)
    want = np.asarray(jboxes.clip_boxes(jnp.asarray(bx), jnp.asarray(hw)[:, None, :]))
    got = tboxes.clip_boxes(torch.from_numpy(bx), torch.from_numpy(hw)[:, None, :]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for thresh in (0.0, 5.0):
        np.testing.assert_array_equal(
            tboxes.nonempty(torch.from_numpy(got), thresh).numpy(),
            np.asarray(jboxes.nonempty(jnp.asarray(want), thresh)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_apply_and_get_deltas(weights):
    rng = np.random.RandomState(2)
    src = _boxes(rng, 64, degenerate=False)
    src[:, 2:] += 1.0
    k = 3
    deltas = rng.randn(64, 4 * k).astype(np.float32)
    deltas[::5, 2::4] = 9.0    # beyond SCALE_CLAMP
    assert treg.SCALE_CLAMP == jreg.SCALE_CLAMP
    want = np.asarray(jreg.apply_deltas(jnp.asarray(deltas), jnp.asarray(src), weights))
    got = treg.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src), weights).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * np.abs(want).max())
    tgt = _boxes(rng, 64, degenerate=False)
    tgt[:, 2:] += 1.0
    want_d = np.asarray(jreg.get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights))
    got_d = treg.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt), weights).numpy()
    np.testing.assert_allclose(got_d, want_d, rtol=0, atol=TOL * np.abs(want_d).max())


@pytest.mark.parametrize("learnable", [False, True])
def test_anchors(learnable):
    kw = dict(learnable_anchors=learnable, stride=16, anchor_offset=0.5 if learnable else 0.0)
    ja, ta = JArch(**kw), tcfg.Arch(**kw)
    assert janchors.num_cell_anchors(ja) == tanchors.num_cell_anchors(ta)
    wh_j = janchors.init_anchor_params(ja)
    wh_t = tanchors.init_anchor_params(ta)
    if learnable:
        rng = np.random.RandomState(3)
        wh = (np.asarray(wh_j) * rng.uniform(0.8, 1.2, np.asarray(wh_j).shape)).astype(np.float32)
        wh_j, wh_t = jnp.asarray(wh), torch.from_numpy(wh)
    else:
        assert wh_j is None and wh_t is None
    want = np.asarray(janchors.anchor_boxes(wh_j, ja, 5, 7))
    got = tanchors.anchor_boxes(wh_t, ta, 5, 7, device="cpu").numpy()
    assert got.shape == want.shape == (5 * 7 * 9, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_config_copy_and_arch_from_cfg():
    """Both packages merge the reference YAML into the same tree and the same Arch."""
    path = os.path.join(REPO, "configs", "pt", "final_c2f.yaml")
    cj, ct = jcfg.get_cfg(), tcfg.get_cfg()
    assert dict(cj) == dict(ct)
    cj.merge_from_file(path)
    ct.merge_from_file(path)
    opts = ["SOLVER.AMP.ENABLED", "True", "MODEL.RPN.NMS_IMPL", "pallas"]
    cj.merge_from_list(opts)
    ct.merge_from_list(opts)
    assert dict(cj) == dict(ct)
    assert dataclasses.asdict(JArch.from_cfg(cj)) == dataclasses.asdict(tcfg.Arch.from_cfg(ct))
    assert [f.name for f in dataclasses.fields(JArch)] == \
        [f.name for f in dataclasses.fields(tcfg.Arch)]
