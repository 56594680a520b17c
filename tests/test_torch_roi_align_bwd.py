"""Port parity for the ROIAlign backward on the CPU, on the cases of
``roi_bwd_cases.py``, which cross the tiles of the backward kernel, and the
kernel's tiling plan (``roi_align_cuda.bwd_plan``) on them.

The plain backward ``roi_align_bwd_plain`` is held to ``jax.vjp`` of
``roi_align_pallas`` (whose VJP is ``_bwd_einsum``): f32 within 1e-5 * max|dF|,
bf16 within 2e-2 * max|dF| (the two round their intermediates at different
places). Both give NaN on an image with a non-finite box, each in its own places,
so those images are compared for being NaN only. The card's kernel is held to the
plain version on the same cases by ``test_torch_kernels.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.ops.roi_align_pallas import roi_align_pallas
from probabilisticteacher_torch.ops import roi_align as troi
from probabilisticteacher_torch.ops import roi_align_cuda

import roi_bwd_cases

STRIDE = roi_bwd_cases.STRIDE


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("name", list(roi_bwd_cases.CASES))
def test_bwd_plain_matches_jax_vjp_on_tile_cases(name, dtype, tol):
    shape, boxes, g, nonfinite = roi_bwd_cases.make(name)
    n, h, w, c = shape
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(lambda f: roi_align_pallas(f, jnp.asarray(boxes), 1 / STRIDE, 7, 2, True),
                     jnp.zeros(shape, jdt))
    (want,) = vjp(jnp.asarray(g, jdt))
    want = np.asarray(want.astype(jnp.float32))
    wy, wx = troi.batched_pool_matrices(torch.from_numpy(boxes), h, w, 1 / STRIDE, 7, 2, tdt)
    got = troi.roi_align_bwd_plain(wy, wx, torch.from_numpy(g))
    assert got.dtype == tdt and tuple(got.shape) == shape
    got = got.float().numpy()
    finite = [i for i in range(n) if i not in nonfinite]
    for i in nonfinite:
        assert np.isnan(got[i]).any() and np.isnan(want[i]).any()
    scale = np.abs(want[finite]).max()
    assert scale > 0
    np.testing.assert_allclose(got[finite], want[finite], rtol=0, atol=tol * scale)
    if name == "no_live_roi":
        assert not got[1].any() and not want[1].any()


@pytest.mark.parametrize("name", list(roi_bwd_cases.CASES))
def test_bwd_plan_tiles_the_cases(name):
    """The kernel's tiling covers the map, a block fits its shared memory, and the
    cases cross tiles as ``roi_bwd_cases`` says."""
    _, h, w, c, _ = roi_bwd_cases.CASES[name]
    plan = roi_align_cuda.bwd_plan(h, w, c, 7)
    assert (plan.tiles_y - 1) * plan.th < h <= plan.tiles_y * plan.th
    assert (plan.tiles_x - 1) * plan.tw < w <= plan.tiles_x * plan.tw
    assert plan.smem == roi_align_cuda.bwd_smem(plan.th, plan.tw, c, 7, plan.batch)
    assert plan.smem <= roi_align_cuda.BWD_SMEM_BYTES
    assert 2 * 7 * plan.batch <= roi_align_cuda.BWD_THREADS
    tiles = {"c512": (6, 6), "c64": (5, 1), "whole": (5, 1), "c16": (2, 1), "wide": (2, 4)}
    assert (plan.tiles_y, plan.tiles_x) == tiles.get(name, (1, 1))
    if name in ("c512", "c64", "wide"):
        assert h % plan.th != 0


def test_bwd_plan_at_the_recipe_shape_and_its_limit():
    """The student's 38 x 84 x 512 map: 36 tiles of 7 x 14 cells with all 512
    channels, a column to each of 16 warps but 2; too many channels raise."""
    plan = roi_align_cuda.bwd_plan(38, 84, 512, 7)
    assert (plan.th, plan.tw, plan.tiles_y, plan.tiles_x, plan.batch) == (7, 14, 6, 6, 32)
    with pytest.raises(ValueError, match="lanes"):
        roi_align_cuda.bwd_plan(4, 4, 60000, 7)
