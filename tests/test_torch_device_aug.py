"""Port parity for on-device augmentation: JAX ``data/device_aug.py`` vs the port.

The JAX draws (gates, jitter factors and order, blur sigma, jitter ratios) are
replayed into the port's draw arguments. Tolerances: f32 within 1e-4 of 255 (the
HSV round trip and the blur sum in another order); bf16 within 1.0, one bf16 ulp
in [128, 256) (a blend or a blur can round the other way). Each op is also
checked alone with fixed factors, so that no branch hides behind a gate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.data import device_aug as ja
from probabilisticteacher_torch.data import device_aug as ta
from torch_jax_draws import aug_draws, jitter_draws

TOL = {"float32": 1e-4 * 255, "bfloat16": 1.0}
MEAN = (103.53, 116.28, 123.675)


def _images(seed, n=12, h=20, w=28):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (n, h, w, 3)).astype(np.float32)
    img[:, 5:9, 5:12] = 200.0          # a flat patch
    img[:, 12:, :4] = 0.0              # black: saturation and hue edge cases
    img[0, :, :, 1] = img[0, :, :, 0]  # ties between channels
    return img


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_strong_augment(dtype):
    img = _images(0)
    key = jax.random.key(5)
    draws = aug_draws(key, img.shape[0])
    # the draws open every gate and leave every gate closed at least once
    for j, p in enumerate(ta.GATES):
        assert (draws.gates[:, j] < p).any() and (draws.gates[:, j] >= p).any(), j
    want = ja.strong_augment(key, jnp.asarray(img), dtype=getattr(jnp, dtype))
    got = ta.strong_augment(torch.from_numpy(img), draws, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and got.shape == img.shape
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scale_jitter(dtype):
    img = _images(1, n=4)
    hw = np.array([[20, 28], [18, 24], [20, 20], [11, 28]], np.float32)
    boxes = np.random.RandomState(2).uniform(0, 18, (4, 5, 4)).astype(np.float32)
    key = jax.random.key(6)
    wi, wb = ja.scale_jitter(key, jnp.asarray(img), jnp.asarray(hw), jnp.asarray(boxes), MEAN,
                             dtype=getattr(jnp, dtype))
    gi, gb = ta.scale_jitter(torch.from_numpy(img), torch.from_numpy(hw),
                             torch.from_numpy(boxes), MEAN, jitter_draws(key, 4),
                             getattr(torch, dtype))
    _close(gi, wi, dtype)
    np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=1e-6, atol=1e-5)


def _op_cases():
    f = np.array([0.7, 1.3, 1.0, 0.61], np.float32)
    d = np.array([0.08, -0.1, 0.0, 0.05], np.float32)
    return [
        ("brightness", lambda x: jax.vmap(ja.adjust_brightness)(x, jnp.asarray(f)),
         lambda x: ta.adjust_brightness(x, torch.from_numpy(f))),
        ("contrast", lambda x: jax.vmap(ja.adjust_contrast)(x, jnp.asarray(f)),
         lambda x: ta.adjust_contrast(x, torch.from_numpy(f))),
        ("saturation", lambda x: jax.vmap(ja.adjust_saturation)(x, jnp.asarray(f)),
         lambda x: ta.adjust_saturation(x, torch.from_numpy(f))),
        ("hue", lambda x: jax.vmap(ja.adjust_hue)(x, jnp.asarray(d)),
         lambda x: ta.adjust_hue(x, torch.from_numpy(d))),
        ("grayscale", ja._grayscale, ta._grayscale),
        ("solarize", ja.solarize, ta.solarize),
        ("blur", lambda x: jax.vmap(lambda k, im: ja.gaussian_blur(k, im))(
            jax.random.split(jax.random.key(8), 4), x), None),
    ]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", _op_cases(), ids=lambda c: c[0])
def test_single_ops(case, dtype):
    name, jfn, tfn = case
    img = _images(3, n=4)
    if name == "blur":   # give the port the sigmas JAX draws from its keys
        s = torch.tensor([float(jax.random.uniform(k, (), minval=0.1, maxval=2.0))
                          for k in jax.random.split(jax.random.key(8), 4)])
        tfn = lambda x: ta.gaussian_blur(x, s)  # noqa: E731
    want = jfn(jnp.asarray(img, getattr(jnp, dtype)))
    got = tfn(torch.from_numpy(img).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_color_jitter_follows_each_images_order():
    img = _images(4, n=4)
    factors = np.array([[0.7, 1.3, 0.8, 0.05]] * 4, np.float32)
    orders = [[0, 1, 2, 3], [3, 2, 1, 0], [1, 3, 0, 2], [2, 0, 3, 1]]
    got = ta.color_jitter(torch.from_numpy(img), torch.from_numpy(factors), torch.tensor(orders))
    ops = (ja.adjust_brightness, ja.adjust_contrast, ja.adjust_saturation, ja.adjust_hue)
    for i, order in enumerate(orders):
        x = jnp.asarray(img[i])
        for o in order:
            x = ops[o](x, jnp.float32(factors[i, o]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(x), rtol=0, atol=TOL["float32"])


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_draw_aug_factors_equal_tensor_bounds(seed):
    """``draw_aug`` builds the factors from scalar bounds a column at a time (a tensor
    of bounds on the card would be a copy from the host, which waits); the numbers are
    those of ``lo + (hi - lo) * u`` with the bounds as f32 tensors, bit for bit."""
    d = ta.draw_aug(4096, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed)
    gates, u = torch.rand((4096, 4), generator=g), torch.rand((4096, 4), generator=g)
    b, c, s, h = ta.JITTER
    lo = torch.tensor([1 - b, 1 - c, 1 - s, -h])
    hi = torch.tensor([1 + b, 1 + c, 1 + s, h])
    assert torch.equal(d.gates, gates)
    assert d.factors.dtype == torch.float32 and torch.equal(d.factors, lo + (hi - lo) * u)


def test_tensors_off_the_cpu_take_the_kernels():
    """Only a CPU tensor takes the plain version: any other goes to the CUDA wrappers,
    which refuse a device that is not the card (no fallback)."""
    img = torch.empty(2, 8, 8, 3, dtype=torch.uint8, device="meta")
    draws = ta.draw_aug(2, None, "meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        ta.strong_augment(img, draws, torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported device meta"):
        ta.scale_jitter(img.float(), torch.empty(2, 2, device="meta"),
                        torch.empty(2, 3, 4, device="meta"), MEAN,
                        torch.empty(2, device="meta"), torch.bfloat16)
