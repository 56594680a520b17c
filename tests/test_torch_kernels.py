"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``: they build the kernels with ``nvcc`` and launch them, so they need
an NVIDIA GPU (the kernels target Hopper, ``sm_90a``) and the CUDA toolkit. Run on
the H100 with ``python -m pytest -m gpu tests/test_torch_kernels.py``. Elsewhere
the ``cuda`` fixture skips them; whether a card is present is decided inside the
fixture, never at import, so every pytest worker collects the same tests.

Tolerances: ROIAlign bf16 2e-2 * max|F| (the plain version rounds its
interpolation matrices and the y-interpolated intermediate to bf16, as the JAX
package does), f32 1e-5 * max|F|; NMS keep sets exactly equal.
"""

import numpy as np
import pytest
import torch

from probabilisticteacher_torch.ops import nms as tnms
from probabilisticteacher_torch.ops import nms_cuda, roi_align_cuda
from probabilisticteacher_torch.ops.roi_align import roi_align_batched

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


@pytest.mark.parametrize("k,max_keep,thresh,classes", [
    (3000, 500, 0.7, 0), (12000, 2000, 0.7, 0), (4000, 100, 0.5, 8)])
def test_nms_kernel_keep_sets_equal_plain(cuda, k, max_keep, thresh, classes):
    g = torch.Generator().manual_seed(k)
    n = 3
    centers = torch.rand(n, k // 20 + 1, 2, generator=g) * 1000
    pick = torch.randint(0, centers.shape[1], (n, k), generator=g)
    xy = torch.gather(centers, 1, pick[..., None].expand(-1, -1, 2))
    xy = xy + torch.rand(n, k, 2, generator=g) * 24 - 12
    boxes = torch.cat([xy, xy + 5 + torch.rand(n, k, 2, generator=g) * 80], -1)
    scores = torch.rand(n, k, generator=g).to(torch.bfloat16).float()  # ties
    boxes[:, 10:20] = boxes[:, 5:6]
    scores[:, 10:20] = scores[:, 5:6]
    valid = torch.rand(n, k, generator=g) > 0.1
    boxes, scores, valid = boxes.to(cuda), scores.to(cuda), valid.to(cuda)
    before = nms_cuda.KERNEL.launches
    if classes:
        cls = torch.randint(0, classes, (n, k), generator=g).to(cuda)
        got = nms_cuda.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
        want = tnms.batched_nms(boxes, scores, cls, valid, thresh, max_keep)
    else:
        got = nms_cuda.nms(boxes, scores, valid, thresh, max_keep)
        want = tnms.nms(boxes, scores, valid, thresh, max_keep)
    torch.cuda.synchronize()
    assert nms_cuda.KERNEL.launches == before + 1
    assert torch.equal(got[1], want[1])
    assert torch.equal(got[0], want[0])
    assert got[1].any()


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
