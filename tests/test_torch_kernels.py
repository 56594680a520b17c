"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they build the kernels with ``nvcc`` and launch them, so they need
an NVIDIA GPU (the kernels target Hopper, ``sm_90a``) and the CUDA toolkit. Run on
the H100 with ``python -m pytest -m gpu tests/test_torch_kernels.py``. Elsewhere
the ``cuda`` fixture skips them; whether a card is present is decided inside the
fixture, never at import, so every pytest worker collects the same tests.

Tolerances: ROIAlign forward bf16 2e-2 * max|F| (the plain version rounds its
interpolation matrices and the y-interpolated intermediate to bf16, as the JAX
package does), f32 1e-5 * max|F|; ROIAlign backward bf16 2e-2 * max|dF| and f32
1e-5 * max|dF| (the kernel does not round its intermediate to bf16), on the
tile-crossing cases of ``roi_bwd_cases.py`` too, and two launches bit-identical
(each block adds into its own tile in a fixed order); NMS keep sets exactly
equal, the tile-boundary cases of ``nms_tile_cases.py`` included.
"""

import numpy as np
import pytest
import torch

import nms_tile_cases
import roi_bwd_cases
from probabilisticteacher_torch.ops import nms as tnms
from probabilisticteacher_torch.ops import nms_cuda, roi_align_cuda
from probabilisticteacher_torch.ops.roi_align import (batched_pool_matrices, roi_align_batched,
                                                      roi_align_bwd_plain)

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _roi_case(dev, dtype, n=2, h=38, w=84, c=512, r=300, seed=0):
    g = torch.Generator().manual_seed(seed)
    feat = torch.randn(n, h, w, c, generator=g).to(dev, dtype)
    xy = torch.rand(n, r, 2, generator=g) * torch.tensor([w * 16 + 64.0, h * 16 + 64.0]) - 32
    wh = torch.rand(n, r, 2, generator=g) * 400
    boxes = torch.cat([xy, xy + wh], -1)
    boxes[:, 0] = torch.tensor([-40.0, -40.0, w * 16 + 40.0, h * 16 + 40.0])
    boxes[:, 1] = torch.tensor([10.0, 10.0, 10.0, 30.0])       # empty width
    boxes[:, 2] = torch.tensor([w * 16 + 50.0, 5.0, w * 16 + 90.0, 60.0])  # outside
    return feat, boxes.to(dev)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
def test_roi_align_kernel_matches_plain(cuda, dtype, tol):
    feat, boxes = _roi_case(cuda, dtype)
    before = roi_align_cuda.KERNEL.launches
    got = roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2)
    torch.cuda.synchronize()
    assert roi_align_cuda.KERNEL.launches == before + 1
    want = roi_align_batched(feat, boxes, 1.0 / 16, 7, 2)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * feat.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
def test_roi_align_bwd_kernel_matches_plain(cuda, dtype, tol):
    feat, boxes = _roi_case(cuda, dtype, r=512)
    n, h, w, c = feat.shape
    g = torch.randn(n, 512, 7, 7, c, generator=torch.Generator().manual_seed(1)).to(cuda, dtype)
    g[:, 400:] = 0                                       # padded rows of the masked losses
    before = roi_align_cuda.BWD_KERNEL.launches
    got = roi_align_cuda.roi_align_backward(g, boxes, feat.shape, dtype, 1.0 / 16, 7, 2)
    again = roi_align_cuda.roi_align_backward(g, boxes, feat.shape, dtype, 1.0 / 16, 7, 2)
    torch.cuda.synchronize()
    assert roi_align_cuda.BWD_KERNEL.launches == before + 2
    assert torch.equal(got, again)
    wy, wx = batched_pool_matrices(boxes, h, w, 1.0 / 16, 7, 2, dtype)
    want = roi_align_bwd_plain(wy, wx, g)
    assert got.dtype == dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol * want.float().abs().max().item(), err


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-5)])
@pytest.mark.parametrize("name", list(roi_bwd_cases.CASES))
def test_roi_align_bwd_kernel_tile_cases(cuda, name, dtype, tol):
    """K2 against the plain version on the cases that cross its tiles (rows and
    columns); two launches bit-identical. An image with a non-finite box, where
    the plain dF is NaN, must come out finite (its taps are clamped to the map)."""
    shape, boxes, g, nonfinite = roi_bwd_cases.make(name)
    boxes = torch.from_numpy(boxes).to(cuda)
    g = torch.from_numpy(g).to(cuda, dtype)
    got = roi_align_cuda.roi_align_backward(g, boxes, shape, dtype, 1.0 / 16, 7, 2)
    again = roi_align_cuda.roi_align_backward(g, boxes, shape, dtype, 1.0 / 16, 7, 2)
    wy, wx = batched_pool_matrices(boxes, shape[1], shape[2], 1.0 / 16, 7, 2, dtype)
    want = roi_align_bwd_plain(wy, wx, g).float()
    torch.cuda.synchronize()
    assert got.dtype == dtype and tuple(got.shape) == shape
    assert torch.equal(got, again)
    assert torch.isfinite(got.float()).all()
    finite = [i for i in range(shape[0]) if i not in nonfinite]
    err = (got.float()[finite] - want[finite]).abs().max().item()
    assert err <= tol * want[finite].abs().max().item(), err
    if name == "no_live_roi":
        assert not got[1].any()


def test_roi_align_autograd_runs_both_kernels(cuda):
    feat, boxes = _roi_case(cuda, torch.bfloat16, r=64)
    feat.requires_grad_(True)
    fwd, bwd = roi_align_cuda.KERNEL.launches, roi_align_cuda.BWD_KERNEL.launches
    out = roi_align_cuda.roi_align(feat, boxes, 1.0 / 16, 7, 2)
    (df,) = torch.autograd.grad(out.float().square().sum(), feat)
    torch.cuda.synchronize()
    assert roi_align_cuda.KERNEL.launches == fwd + 1
    assert roi_align_cuda.BWD_KERNEL.launches == bwd + 1
    assert df.dtype == torch.bfloat16 and torch.isfinite(df.float()).all() and df.abs().sum() > 0


def _clustered_nms_case(k, classes, n=3):
    g = torch.Generator().manual_seed(k)
    centers = torch.rand(n, k // 20 + 1, 2, generator=g) * 1000
    pick = torch.randint(0, centers.shape[1], (n, k), generator=g)
    xy = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.rand(n, k, 2, generator=g) * 24 - 12
    boxes = torch.cat([xy, xy + 5 + torch.rand(n, k, 2, generator=g) * 80], -1)
    scores = torch.rand(n, k, generator=g).to(torch.bfloat16).float()  # ties
    boxes[:, 10:20] = boxes[:, 5:6]
    scores[:, 10:20] = scores[:, 5:6]
    valid = torch.rand(n, k, generator=g) > 0.1
    cls = torch.randint(0, classes, (n, k), generator=g) if classes else None
    return boxes, scores, valid, cls


# (k, max_keep, thresh, classes) of clustered boxes, or the name of a tile case
NMS_KERNEL_CASES = [(3000, 500, 0.7, 0), (12000, 2000, 0.7, 0), (4000, 100, 0.5, 8),
                    *nms_tile_cases.CASES]


@pytest.mark.parametrize("case", NMS_KERNEL_CASES, ids=str)
def test_nms_kernel_keep_sets_equal_plain(cuda, case):
    """Keep sets equal to the plain version on the card: clustered boxes with tied
    scores, and the cases of ``nms_tile_cases`` that cross the kernel's 64-row
    tiles (3 images each; 48 images of 12001 rows for ``large``)."""
    if isinstance(case, str):
        boxes, scores, valid, max_keep, thresh = nms_tile_cases.make(
            case, n=48 if case == "large" else 3)
        boxes, scores, valid = (torch.from_numpy(x) for x in (boxes, scores, valid))
        cls = None
    else:
        k, max_keep, thresh, classes = case
        boxes, scores, valid, cls = _clustered_nms_case(k, classes)
    boxes, scores, valid = boxes.to(cuda), scores.to(cuda), valid.to(cuda)
    before = nms_cuda.KERNEL.launches
    if cls is not None:
        cls = cls.to(cuda)
        got = nms_cuda.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
        want = tnms.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
    else:
        got = nms_cuda.nms(boxes, scores, valid, thresh, max_keep)
        want = tnms.nms(boxes, scores, valid, thresh, max_keep)
    torch.cuda.synchronize()
    assert nms_cuda.KERNEL.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert bool(got[1].any()) == (case != "all_invalid")


def test_nms_kernel_matches_the_cpu_plain_version(cuda):
    """The card's keep sets equal the CPU's, which the CPU tests hold to JAX."""
    rng = np.random.RandomState(5)
    xy = rng.uniform(0, 300, (2, 2000, 2))
    boxes = torch.from_numpy(np.concatenate([xy, xy + rng.uniform(5, 60, (2, 2000, 2))], -1)
                             .astype(np.float32))
    scores = torch.from_numpy(rng.uniform(size=(2, 2000)).astype(np.float32))
    valid = torch.from_numpy(rng.rand(2, 2000) > 0.1)
    want = tnms.nms(boxes, scores, valid, 0.6, 300)
    got = nms_cuda.nms(boxes.to(cuda), scores.to(cuda), valid.to(cuda), 0.6, 300)
    assert torch.equal(got[1].cpu(), want[1]) and torch.equal(got[0].cpu(), want[0])


def _drop_center_bin(grad):
    """K2 that loses one of the 49 bins of every ROI."""
    grad = grad.clone()
    grad[:, :, 3, 3] = 0
    return grad, lambda df: df


def _shift_one_column(grad):
    """K2 whose scatter lands one map column to the right."""
    return grad, lambda df: torch.cat([torch.zeros_like(df[:, :, :1]), df[:, :, :-1]], 2)


@pytest.mark.parametrize("fault", [_drop_center_bin, _shift_one_column])
def test_train_reference_catches_a_planted_k2_fault(cuda, monkeypatch, fault):
    """The card-vs-CPU gradient check of ``chip_smoke.py`` (phase 7) fails when K2
    is wrong. The fault is planted around the kernel's wrapper, on CUDA tensors
    only, so the CPU side keeps the plain backward. The readings are printed
    (run with ``-s``) beside the clean ones, to show how far the limit lies from a
    fault."""
    import chip_smoke

    clean = chip_smoke.train_reference_errors(cuda)
    real = roi_align_cuda.roi_align_backward

    def faulty(grad, *args):
        if grad.device.type != "cuda":
            return real(grad, *args)
        grad, post = fault(grad)
        return post(real(grad, *args))

    monkeypatch.setattr(roi_align_cuda, "roi_align_backward", faulty)
    bad = chip_smoke.train_reference_errors(cuda)
    print(f"\n[planted K2 fault] {fault.__name__}: gradient error {bad['grad_err']!r} "
          f"({bad['worst']}), loss error {bad['loss_err']!r}; clean {clean['grad_err']!r}; "
          f"limit {chip_smoke.TRAIN_REF_GRAD_TOL}")
    assert clean["grad_err"] <= chip_smoke.TRAIN_REF_GRAD_TOL
    assert bad["grad_err"] > chip_smoke.TRAIN_REF_GRAD_TOL
