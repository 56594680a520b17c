"""Port parity for the training ops: matcher, sampling, losses, densities, the
ROIAlign backward and the tie-splitting max pool, JAX vs the PyTorch port on the CPU.

- matcher and sampling: equal results (indices, labels and masks), with the JAX
  uniforms replayed into the port;
- losses and densities: values and gradients in f32, rtol 1e-5 (atol 1e-6 for
  gradients that sum to ~0), on inputs whose masked rows would give NaN without
  the guards;
- ``roi_align_bwd_plain`` against ``jax.vjp`` of ``roi_align_pallas(interpret=True)``
  (whose VJP is ``_bwd_einsum``): f32 within 1e-5 of max|dF|, bf16 within 2e-2
  (the two round their intermediates at different places), and against the Pallas
  backward kernel ``_bwd_pallas(interpret=True)`` in f32 within 1e-5;
- the max-pool gradient against the JAX custom VJP on inputs with ties: exactly
  equal in f32 and bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.modeling import backbone as jbackbone
from probabilisticteacher_tpu.ops import box_regression as jbr
from probabilisticteacher_tpu.ops import losses as jL
from probabilisticteacher_tpu.ops import matcher as jm
from probabilisticteacher_tpu.ops import roi_align_pallas as jrp
from probabilisticteacher_tpu.ops import sampling as js
from probabilisticteacher_torch.modeling.backbone import MaxPool2x2
from probabilisticteacher_torch.ops import box_regression as tbr
from probabilisticteacher_torch.ops import losses as tL
from probabilisticteacher_torch.ops import matcher as tm
from probabilisticteacher_torch.ops import sampling as ts
from probabilisticteacher_torch.ops.roi_align import batched_pool_matrices, roi_align_bwd_plain
from probabilisticteacher_torch.ops.roi_align_cuda import roi_align
from torch_jax_draws import sample_draws


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x,
                                                                                   np.float32)


def _iou_case(seed, n=3, m=5, r=200):
    rng = np.random.RandomState(seed)
    iou = rng.choice([0.0, 0.1, 0.3, 0.5, 0.69, 0.7, 0.71, 0.9], size=(n, m, r)).astype(np.float32)
    iou[:, :, 7] = iou[:, :, 3]                        # tied predictions
    iou[:, 1] = iou[:, 0]                              # tied ground truths
    valid = rng.rand(n, m) > 0.3
    valid[0] = False                                   # an image with no ground truth
    return iou, valid


@pytest.mark.parametrize("thresholds,labels,low_quality", [
    ((0.3, 0.7), (0, -1, 1), True), ((0.5,), (0, 1), False)])
def test_match(thresholds, labels, low_quality):
    iou, valid = _iou_case(0)
    got = tm.match(tm.masked_iou(torch.from_numpy(iou), torch.from_numpy(valid)),
                   thresholds, labels, low_quality)
    for i in range(iou.shape[0]):
        want = jm.match(jm.masked_iou(jnp.asarray(iou[i]), jnp.asarray(valid[i])),
                        thresholds, labels, low_quality)
        np.testing.assert_array_equal(got.matched_idx[i].numpy(), np.asarray(want.matched_idx))
        np.testing.assert_array_equal(got.labels[i].numpy(), np.asarray(want.labels))


@pytest.mark.parametrize("num_samples,frac,n_rows", [(8, 0.25, 40), (256, 0.25, 300),
                                                      (16, 0.5, 10)])
def test_subsample_labels(num_samples, frac, n_rows):
    rng = np.random.RandomState(num_samples)
    labels = rng.choice([-1, 0, 1, 2], size=(4, n_rows), p=[0.2, 0.6, 0.1, 0.1]).astype(np.int32)
    labels[1] = -1                                     # nothing eligible
    labels[2, :3] = 1                                  # few positives
    labels[2, 3:] = 0
    key = jax.random.key(num_samples)
    draws = sample_draws(key, 4, n_rows)
    pos, neg = ts.subsample_labels(torch.from_numpy(labels), num_samples, frac, 0, draws)
    for i, k in enumerate(jax.random.split(key, 4)):
        wp, wn = js.subsample_labels(k, jnp.asarray(labels[i]), num_samples, frac, 0)
        np.testing.assert_array_equal(pos[i].numpy(), np.asarray(wp))
        np.testing.assert_array_equal(neg[i].numpy(), np.asarray(wn))
    assert int(pos.sum()) > 0 and int(neg.sum()) > 0


def test_random_topk_mask_ties_go_to_the_lower_index():
    eligible = torch.ones(2, 6, dtype=torch.bool)
    u = torch.tensor([[0.5, 0.9, 0.9, 0.1, 0.9, 0.2]] * 2)
    mask, count = ts.random_topk_mask(eligible, 2, u)
    assert mask[0].tolist() == [False, True, True, False, False, False]
    assert count.tolist() == [2, 2]


def _loss_inputs(seed, n=64, k=4):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    t_logits = f(n, k + 1) * 3
    t_logits[:4] = [[200.0, -200.0, -200.0, -200.0, -200.0]] * 4   # softmax underflows to 0
    mask = rng.rand(n) > 0.4
    mask[:2] = False
    return dict(o=f(n) * 2, t_logits=t_logits, s_logits=f(n, k + 1), mask=mask,
                mq=f(n, 4), sq=f(n, 4), mp=f(n, 4), sp=f(n, 4), labels=rng.randint(0, k + 1, n))


def _loss_cases():
    def rpn_soft(L, d):
        return L.rpn_soft_cls_loss(d["o"], d["t_logits"], d["mask"], 0.25, True, 0.5)

    def kl_sum(L, d):
        return L.kl_consistency_box_loss(d["mq"], d["sq"], d["mp"], d["sp"], d["mask"], 0.25,
                                         True, 0.5, "GUASSIAN", "sum")

    def kl_mean_laplace(L, d):
        return L.kl_consistency_box_loss(d["mq"], d["sq"], d["mp"], d["sp"], d["mask"], 0.5,
                                         True, 0.5, "LAPLACE", "mean")

    def kl_no_efl(L, d):
        return L.kl_consistency_box_loss(d["mq"], d["sq"], d["mp"], d["sp"], d["mask"], 0.5,
                                         False, 0.5, "GUASSIAN", "mean")

    def roi_soft(L, d):
        return L.roi_soft_cls_loss(d["s_logits"], d["t_logits"], d["mask"], 0.25, True, 0.5)

    def bce(L, d):
        return L.binary_cross_entropy_with_logits_sum(d["o"], (d["labels"] > 1) * 1.0,
                                                      d["mask"])

    def ce(L, d):
        return L.softmax_cross_entropy_mean(d["s_logits"], d["labels"], d["mask"])

    def nll_gauss(L, d):
        return L.prob_box_nll_sum(d["mq"], d["sq"], d["mp"], d["mask"], "GUASSIAN")

    def nll_laplace(L, d):
        return L.prob_box_nll_sum(d["mq"], d["sq"], d["mp"], d["mask"], "LAPLACE")

    def efl_class(L, d):
        return L.efl_class_weight(d["t_logits"], 0.5).sum() + 0 * d["mq"].sum()

    return [rpn_soft, kl_sum, kl_mean_laplace, kl_no_efl, roi_soft, bce, ce, nll_gauss,
            nll_laplace, efl_class]


_DIFF = ("o", "t_logits", "s_logits", "mq", "sq", "mp", "sp")


@pytest.mark.parametrize("case", _loss_cases(), ids=lambda f: f.__name__)
def test_losses_value_and_grad(case):
    d = _loss_inputs(1)
    jd = {k: jnp.asarray(v) for k, v in d.items()}
    names = [k for k in _DIFF]

    def jfn(*xs):
        return case(jL, {**jd, **dict(zip(names, xs))})

    want, wgrads = jax.value_and_grad(jfn, argnums=tuple(range(len(names))))(
        *(jd[k] for k in names))
    td = {k: torch.from_numpy(v) for k, v in d.items()}
    for k in names:
        td[k].requires_grad_(True)
    td["labels"] = td["labels"].long()
    got = case(tL, td)
    grads = torch.autograd.grad(got, [td[k] for k in names], allow_unused=True)
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    for k, g, w in zip(names, grads, wgrads):
        g = np.zeros_like(np.asarray(w)) if g is None else _np(g)
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(g, _np(w), rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("fn", ["gaussian_dist_pdf", "laplace_dist_pdf"])
def test_densities_and_nll(fn):
    rng = np.random.RandomState(2)
    val, mean = rng.randn(2, 50).astype(np.float32)
    var = rng.rand(50).astype(np.float32)
    want = getattr(jbr, fn)(jnp.asarray(val), jnp.asarray(mean), jnp.asarray(var))
    got = getattr(tbr, fn)(*(torch.from_numpy(x) for x in (val, mean, var)))
    np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5)
    np.testing.assert_allclose(_np(tbr.nll(got)), _np(jbr.nll(want)), rtol=1e-5)


# ------------------------------------------------------------- ROIAlign backward
def _roi_case(seed, n=2, h=6, w=10, c=16, r=16):
    rng = np.random.RandomState(seed)
    feat = rng.randn(n, h, w, c).astype(np.float32)
    xy = rng.uniform(-20, w * 16, (n, r, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(2, 90, (n, r, 2))], -1).astype(np.float32)
    boxes[:, 0] = [-40.0, -40.0, w * 16 + 40.0, h * 16 + 40.0]     # over every edge
    boxes[:, 1] = [w * 16 + 30.0, 5.0, w * 16 + 60.0, 30.0]        # wholly outside
    boxes[:, 2] = [30.0, 30.0, 30.0, 50.0]                          # zero width
    g = rng.randn(n, r, 7, 7, c).astype(np.float32)
    g[:, 3] = 0.0                                                   # a masked row
    return feat, boxes, g


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("shape", [(6, 10), (10, 6)], ids=["wide", "tall"])
def test_roi_align_bwd_plain_matches_jax_vjp(dtype, tol, shape):
    feat, boxes, g = _roi_case(3, h=shape[0], w=shape[1])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda f: jrp.roi_align_pallas(f, jnp.asarray(boxes), 1 / 16, 7, 2, True),
                     jnp.asarray(feat, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    wy, wx = batched_pool_matrices(torch.from_numpy(boxes), shape[0], shape[1], 1 / 16, 7, 2, tdt)
    got = roi_align_bwd_plain(wy, wx, torch.from_numpy(g))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol * np.abs(want).max())

    # the autograd Function's CPU backward is the same function
    f = torch.from_numpy(feat).to(tdt).requires_grad_(True)
    out = roi_align(f, torch.from_numpy(boxes), 1 / 16, 7, 2)
    (df,) = torch.autograd.grad(out, f, torch.from_numpy(g).to(tdt))
    assert torch.equal(df, got)


def test_roi_align_bwd_plain_matches_pallas_backward_kernel():
    feat, boxes, g = _roi_case(4, r=32)
    n, h, w, c = feat.shape
    r = boxes.shape[1]
    assert jrp._bwd_plan(r, 7, h, w, c) != (0, 0)     # the kernel runs, not the einsum
    wy, wx = jrp._pool_matrices(feat.shape, jnp.asarray(boxes), 1 / 16, 7, 2, jnp.float32)
    want = np.asarray(jrp._bwd_pallas(wy, wx, jnp.asarray(g), interpret=True))
    twy, twx = batched_pool_matrices(torch.from_numpy(boxes), h, w, 1 / 16, 7, 2, torch.float32)
    np.testing.assert_array_equal(twy.numpy(), np.asarray(wy))
    np.testing.assert_array_equal(twx.numpy(), np.asarray(wx))
    got = roi_align_bwd_plain(twy, twx, torch.from_numpy(g))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- max pool
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(6, 8), (7, 9)], ids=["even", "odd"])
def test_max_pool_tie_splitting_grad(dtype, hw):
    rng = np.random.RandomState(5)
    x = rng.randint(0, 3, (2, *hw, 4)).astype(np.float32)   # small integers: many ties
    x[0, :4, :4] = 1.0                                       # flat windows tie 4 ways
    g = rng.randn(2, hw[0] // 2, hw[1] // 2, 4).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    out, vjp = jax.vjp(jbackbone._max_pool_2x2, jnp.asarray(x, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).permute(0, 3, 1, 2).requires_grad_(True)
    got = MaxPool2x2.apply(xt)
    (gx,) = torch.autograd.grad(got, xt, torch.from_numpy(g).to(tdt).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(_np(got.permute(0, 2, 3, 1)), _np(out.astype(jnp.float32)))
    np.testing.assert_array_equal(_np(gx.permute(0, 2, 3, 1)), _np(want.astype(jnp.float32)))
