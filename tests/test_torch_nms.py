"""Port parity: the plain PyTorch greedy NMS against the JAX package on the CPU, exact.

The port's ``ops/nms.py`` is the plain version of the CUDA kernel ``csrc/nms.cu``.
Its fixed buffers (indices and valid masks, invalid slots at index 0) must equal,
element for element, those of the JAX blocked solver ``ops/nms.py::nms`` (the JAX
default), of the Pallas scan ``ops/nms_pallas.py::nms`` run in interpret mode, and
the numpy oracle ``tests/oracles.py::greedy_nms``. Cases follow
``tests/test_nms_pallas.py``: random and clustered boxes (long suppression chains),
an IoU exactly at the threshold, all-invalid input, more survivors than the
budget, several images at once, class-aware NMS, and bf16-quantised (tied) scores
with duplicate boxes. ``tests/nms_tile_cases.py`` adds cases at the CUDA kernel's
64-row tile boundaries: chains and tied duplicates across them, K = 1, 63, 64, 65
and 257, a budget that runs out inside a tile, a wholly invalid tile and no valid
row at all.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from probabilisticteacher_tpu.ops import nms as jnms
from probabilisticteacher_tpu.ops import nms_pallas
from probabilisticteacher_torch.ops import nms as tnms
from probabilisticteacher_torch.ops import nms_cuda

import nms_tile_cases
from oracles import greedy_nms


def _random_case(rng, k, scale=200.0, cluster=False):
    if cluster:
        centers = rng.uniform(0, scale, (max(k // 20, 1), 2))
        idx = rng.randint(0, len(centers), k)
        xy = centers[idx] + rng.uniform(-12, 12, (k, 2))
    else:
        xy = rng.uniform(0, scale, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, k).astype(np.float32)
    valid = rng.rand(k) > 0.1
    return boxes, scores, valid


def _tied_case(rng, k):
    """Scores rounded to bf16 (many ties), a block of duplicate boxes, and a chain."""
    boxes, scores, valid = _random_case(rng, k, cluster=True)
    scores = torch.from_numpy(scores).to(torch.bfloat16).float().numpy()
    boxes[10:20] = boxes[5]                       # duplicates, tied scores
    scores[10:20] = scores[5]
    chain = np.arange(8, dtype=np.float32)[:, None] * np.float32(6.0)
    boxes[20:28] = np.concatenate([chain, np.zeros_like(chain), chain + 10, chain * 0 + 10], 1)
    scores[20:28] = np.linspace(0.9, 0.8, 8, dtype=np.float32)
    return boxes, scores, valid


def _port(fn, *arrays, **kw):
    idx, val = fn(*(torch.from_numpy(np.asarray(a)) for a in arrays), **kw)
    return idx.numpy(), val.numpy()


def _assert_same(got, want):
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))


@pytest.mark.parametrize("k,max_keep,thresh", [
    (64, 16, 0.5), (200, 50, 0.7), (1024, 100, 0.5), (3000, 2000, 0.7),
])
@pytest.mark.parametrize("cluster", [False, True])
def test_parity_with_both_jax_nms(k, max_keep, thresh, cluster):
    rng = np.random.RandomState(k + int(cluster))
    boxes, scores, valid = _random_case(rng, k, cluster=cluster)
    got = _port(tnms.nms, boxes, scores, valid, iou_thresh=thresh, max_keep=max_keep)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, max_keep)
    _assert_same(got, jnms.nms(*args))
    _assert_same(got, nms_pallas.nms(*args))


def test_parity_with_numpy_oracle():
    rng = np.random.RandomState(7)
    boxes, scores, valid = _random_case(rng, 400, cluster=True)
    ref = greedy_nms(boxes[valid], scores[valid], 0.6)
    orig = np.where(valid)[0]
    idx, val = _port(tnms.nms, boxes, scores, valid, iou_thresh=0.6, max_keep=100)
    np.testing.assert_array_equal(idx[val], orig[ref][:100])


def test_exact_threshold_tie():
    """iou == thresh does not suppress (strict >); all three agree bit for bit."""
    b = np.array([[0, 0, 2, 2], [0, 1, 2, 3], [10, 10, 12, 12]], np.float32)
    s = np.array([0.9, 0.8, 0.7], np.float32)
    v = np.ones(3, bool)
    got = _port(tnms.nms, b, s, v, iou_thresh=1.0 / 3.0, max_keep=3)
    args = (jnp.asarray(b), jnp.asarray(s), jnp.asarray(v), 1.0 / 3.0, 3)
    _assert_same(got, jnms.nms(*args))
    _assert_same(got, nms_pallas.nms(*args))


def test_all_invalid_and_empty_budget():
    b = np.zeros((32, 4), np.float32)
    idx, val = _port(tnms.nms, b, np.zeros(32, np.float32), np.zeros(32, bool),
                     iou_thresh=0.5, max_keep=8)
    assert not val.any() and not idx.any()


def test_max_keep_overflow_keeps_the_top_scores():
    rng = np.random.RandomState(3)
    xs, ys = np.meshgrid(np.arange(20) * 100.0, np.arange(20) * 100.0)
    boxes = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 50, ys.ravel() + 50],
                     axis=1).astype(np.float32)
    scores = rng.uniform(size=400).astype(np.float32)
    idx, val = _port(tnms.nms, boxes, scores, np.ones(400, bool), iou_thresh=0.5, max_keep=100)
    assert val.all()
    np.testing.assert_array_equal(idx, np.argsort(-scores, kind="stable")[:100])


@pytest.mark.parametrize("tied", [False, True])
def test_batched_images_match_vmapped_jax(tied):
    rng = np.random.RandomState(11 + int(tied))
    n, k = 4, 256
    cases = [(_tied_case if tied else _random_case)(rng, k) for _ in range(n)]
    boxes, scores, valid = (np.stack(x) for x in zip(*cases))
    got = _port(tnms.nms, boxes, scores, valid, iou_thresh=0.7, max_keep=64)
    for fn in (jnms.nms, nms_pallas.nms):
        want = jax.vmap(lambda b, s, v: fn(b, s, v, 0.7, 64))(
            jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid))
        _assert_same(got, want)


@pytest.mark.parametrize("tied", [False, True])
def test_class_aware_batched_nms(tied):
    rng = np.random.RandomState(13 + int(tied))
    k = 512
    boxes, scores, valid = (_tied_case if tied else _random_case)(rng, k)
    cls = rng.randint(0, 8, k).astype(np.int32)
    got = _port(tnms.batched_nms, boxes, scores, cls, valid, iou_thresh=0.5, max_keep=100)
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(cls), jnp.asarray(valid),
            0.5, 100)
    _assert_same(got, jnms.batched_nms(*args, block_size=256))
    _assert_same(got, nms_pallas.batched_nms(*args))
    # per image: a batch of two gives each image its own result
    got2 = _port(tnms.batched_nms, np.stack([boxes, boxes[::-1]]), np.stack([scores, scores]),
                 np.stack([cls, cls]), np.stack([valid, valid]), iou_thresh=0.5, max_keep=100)
    np.testing.assert_array_equal(got2[0][0], got[0])
    np.testing.assert_array_equal(got2[1][0], got[1])


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    rng = np.random.RandomState(17)
    boxes, scores, valid = _tied_case(rng, 300)
    cls = rng.randint(0, 3, 300).astype(np.int32)
    before = nms_cuda.KERNEL.launches
    got = _port(nms_cuda.batched_nms, boxes, scores, cls, valid, iou_thresh=0.5, max_keep=50)
    want = _port(tnms.batched_nms, boxes, scores, cls, valid, iou_thresh=0.5, max_keep=50)
    assert nms_cuda.KERNEL.launches == before
    _assert_same(got, want)


def _tile_case_expectations(name, idx, val, k):
    """What each tile case was built to show, on the port's result."""
    kept = idx[val]
    if name in ("chain", "chain_3"):
        step = 2 if name == "chain" else 3
        for a, b in nms_tile_cases.CHAINS:
            np.testing.assert_array_equal(kept[(kept >= a) & (kept < b)], np.arange(a, b, step))
    elif name == "ties":
        for a, b in nms_tile_cases.TIES:          # the first of each tied pair, in index order
            np.testing.assert_array_equal(kept[(kept >= a) & (kept < b)], [a, a + 1])
    elif name == "max_keep_in_tile":
        assert val.sum() == 90 and kept[-1] == 98  # the 90th kept row sits inside tile 1
    elif name == "invalid_tile":
        assert not ((kept >= 64) & (kept < 128)).any() and (kept >= 128).any()
    elif name == "all_invalid":
        assert not val.any() and not idx.any()
    else:
        assert val.any() and kept.max() < k


@pytest.mark.parametrize("name", nms_tile_cases.CPU_CASES)
def test_tile_boundary_cases_match_both_jax_nms(name):
    """The cases that cross the CUDA kernel's 64-row tiles: the plain version equals
    the JAX blocked solver and the Pallas scan in interpret mode, bit for bit."""
    boxes, scores, valid, max_keep, thresh = nms_tile_cases.make(name)
    boxes, scores, valid = boxes[0], scores[0], valid[0]
    got = _port(tnms.nms, boxes, scores, valid, iou_thresh=thresh, max_keep=max_keep)
    _tile_case_expectations(name, got[0], got[1], len(boxes))
    args = (jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(valid), thresh, max_keep)
    _assert_same(got, jnms.nms(*args))
    _assert_same(got, nms_pallas.nms(*args))
