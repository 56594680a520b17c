"""Port parity: the plain PyTorch ROIAlign against the JAX package on the CPU.

The port's ``roi_align_batched`` is the plain version of the CUDA kernel
``csrc/roi_align_fwd.cu``. It is held, in f32, to the JAX ``roi_align_mxu``, to
the Pallas kernel ``roi_align_pallas`` run in interpret mode, and to the numpy
gather oracle ``tests/oracles.py::roi_align_aligned``. Tolerance: 1e-5 * max|F|
against the two JAX functions (the same matrices, summed in another order), 1e-4
* max|F| against the gather oracle (another formulation). Boxes include ones that
run off every edge of the map, lie wholly outside it, or are empty.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.ops import roi_align as jroi
from probabilisticteacher_tpu.ops.roi_align_pallas import roi_align_pallas
from probabilisticteacher_torch.ops import roi_align as troi
from probabilisticteacher_torch.ops import roi_align_cuda

import oracles

STRIDE = 16


def _case(seed, n=2, h=6, w=9, c=16, r=24):
    rng = np.random.RandomState(seed)
    feat = rng.randn(n, h, w, c).astype(np.float32)
    xy = rng.uniform(-2 * STRIDE, (w + 1) * STRIDE, (n, r, 2))
    wh = rng.uniform(0, 6 * STRIDE, (n, r, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    img_w, img_h = w * STRIDE, h * STRIDE
    boxes[:, 0] = [-40, -40, img_w + 40, img_h + 40]          # covers the map and beyond
    boxes[:, 1] = [img_w + 30, img_h + 30, img_w + 90, img_h + 90]  # wholly outside
    boxes[:, 2] = [10, 20, 10, 20]                             # empty
    boxes[:, 3] = [-30, 5, 8, img_h - 3]                       # off the left edge
    boxes[:, 4] = [img_w - 8, img_h - 8, img_w + 8, img_h + 8]  # bottom-right corner
    return feat, boxes


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_mxu_pallas_and_oracle(seed):
    feat, boxes = _case(seed)
    scale = 1.0 / STRIDE
    got = troi.roi_align_batched(torch.from_numpy(feat), torch.from_numpy(boxes), scale).numpy()
    assert got.shape == (2, 24, 7, 7, 16) and got.dtype == np.float32
    fmax = np.abs(feat).max()

    mxu = np.stack([np.asarray(jroi.roi_align_mxu(jnp.asarray(feat[i]), jnp.asarray(boxes[i]),
                                                  scale)) for i in range(2)])
    np.testing.assert_allclose(got, mxu, rtol=0, atol=1e-5 * fmax)

    pallas = np.asarray(roi_align_pallas(jnp.asarray(feat), jnp.asarray(boxes), scale,
                                         7, 2, True))
    np.testing.assert_allclose(got, pallas, rtol=0, atol=1e-5 * fmax)

    for i in range(2):
        want = oracles.roi_align_aligned(feat[i], boxes[i], scale, 7, 2)
        np.testing.assert_allclose(got[i], want, rtol=0, atol=1e-4 * fmax)
    # the wholly-outside box pools to exactly zero
    assert not got[:, 1].any()


@pytest.mark.parametrize("output_size,sampling_ratio", [(7, 2), (4, 1), (3, 3)])
def test_other_pool_shapes_match_jax(output_size, sampling_ratio):
    feat, boxes = _case(5, n=1, r=8)
    want = np.asarray(jroi.roi_align_mxu(jnp.asarray(feat[0]), jnp.asarray(boxes[0]),
                                         1.0 / STRIDE, output_size, sampling_ratio))
    got = troi.roi_align_mxu(torch.from_numpy(feat[0]), torch.from_numpy(boxes[0]),
                             1.0 / STRIDE, output_size, sampling_ratio).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(feat).max())


def test_chunking_does_not_change_results(monkeypatch):
    feat, boxes = _case(2, r=40)
    f, b = torch.from_numpy(feat), torch.from_numpy(boxes)
    whole = troi.roi_align_batched(f, b, 1.0 / STRIDE)
    monkeypatch.setattr(troi, "ROI_CHUNK", 7)
    chunked = troi.roi_align_batched(f, b, 1.0 / STRIDE)
    torch.testing.assert_close(chunked, whole, rtol=0, atol=0)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    feat, boxes = _case(3)
    f, b = torch.from_numpy(feat), torch.from_numpy(boxes)
    before = roi_align_cuda.KERNEL.launches
    got = roi_align_cuda.roi_align(f, b, 1.0 / STRIDE, 7, 2)
    assert roi_align_cuda.KERNEL.launches == before
    torch.testing.assert_close(got, troi.roi_align_batched(f, b, 1.0 / STRIDE), rtol=0, atol=0)


def test_wrapper_refuses_other_devices():
    f = torch.empty((1, 4, 4, 8), device="meta")
    b = torch.empty((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        roi_align_cuda.roi_align(f, b, 1.0 / STRIDE)


def test_plain_version_is_differentiable_on_cpu():
    """The CPU path keeps autograd (the training slice holds it to the JAX VJP)."""
    feat, boxes = _case(4, n=1, r=6)
    f = torch.from_numpy(feat).requires_grad_(True)
    out = roi_align_cuda.roi_align(f, torch.from_numpy(boxes), 1.0 / STRIDE)
    out.sum().backward()
    g_jax = jax.grad(lambda x: jnp.sum(jroi.roi_align_mxu(x, jnp.asarray(boxes[0]),
                                                          1.0 / STRIDE)))(jnp.asarray(feat[0]))
    np.testing.assert_allclose(f.grad[0].numpy(), np.asarray(g_jax), rtol=1e-5, atol=1e-5)
