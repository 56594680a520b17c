"""The augmentation kernels (``csrc/device_aug.cu``) against the plain PyTorch version
of ``data/device_aug.py``, on the card.

Marked ``gpu``: they build the kernels with ``nvcc`` and launch them. Run on the H100
with ``python -m pytest --noconftest -m gpu tests/test_torch_aug_kernel.py``; elsewhere
the ``cuda`` fixture skips them (decided inside the fixture, never at import).

Both sides run on the card, TF32 off (the plain version's f32 gray level is a matrix
product). Tolerances, those of ``test_torch_device_aug.py``: f32 within 1e-4 * 255 (the
contrast mean, the luma dot and the blur taps' sum may be summed in another order, and
an f32 ulp there moves the later ops by about as much); bf16 within 1.0, one bf16 ulp
in [128, 256) (a value next to a rounding boundary of bf16 can round the other way
after such a sum). Solarize is the one op that is not continuous: a value that the
two sides put within the tolerance of 128 but on either side of it comes out about 1
apart, so such a pixel of a solarized image is measured before solarize, by
|kernel + plain - 255|. The scale jitter's boxes are the same torch ops on both sides and
must be equal. The draws open and close every gate at least once, put contrast at
each of the four positions of an open jitter, and take sigma at both ends of
U[0.1, 2].
"""

import pytest
import torch

from probabilisticteacher_torch.config import Arch, get_cfg
from probabilisticteacher_torch.data import device_aug as da
from probabilisticteacher_torch.engine.steps import create_train_state, make_train_steps
from probabilisticteacher_torch.modeling.detector import PTDetector
from probabilisticteacher_torch.ops import device_aug_cuda
from probabilisticteacher_torch.solver import build_optimizer
from probabilisticteacher_torch.structures import GroundTruth, ImageBatch

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4 * 255, torch.bfloat16: 1.0}
MEAN = (103.53, 116.28, 123.675)
# (label, images, height, width): the recipe's batch and canvas, and shapes that no
# 32 x 32 tile (nor the jitter's 128-pixel rows) divides
SHAPES = (("recipe", 16, 608, 1344), ("odd", 6, 37, 91), ("thin", 5, 70, 13))
DTYPES = (torch.float32, torch.bfloat16)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the H100: pytest -m gpu)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _images(n, h, w, dev, seed):
    """uint8 noise with flat, black and white patches, and zero padding on the right
    and bottom of some images, as the loader pads a canvas."""
    g = torch.Generator().manual_seed(seed)
    img = torch.randint(0, 256, (n, h, w, 3), generator=g, dtype=torch.uint8)
    img[:, h // 4:h // 2, w // 4:w // 2] = 200
    img[:, : h // 5, : w // 6] = 0
    img[:, -(h // 6):, : w // 5] = 255
    img[0, :, :, 1] = img[0, :, :, 0]                    # ties between channels
    img[1::3, :, (3 * w) // 4:] = 0                      # padded columns
    img[2::3, (2 * h) // 3:] = 0                         # padded rows
    return img.to(dev)


def _draws(n, dev, seed):
    """AugDraws for n images: random factors, then every gate open and closed, contrast
    at each position of an open jitter, sigma at 0.1 and 2 and between."""
    g = torch.Generator(device=dev).manual_seed(seed)
    d = da.draw_aug(n, g, dev)
    i = torch.arange(n, device=dev)
    closed = torch.tensor(da.GATES, device=dev) + 0.05
    gates = torch.stack([(i % 5 == 4), (i % 3 != 1), (i % 2 == 1), (i % 4 != 1)], -1)
    gates = torch.where(gates, closed, torch.zeros_like(closed))
    rest = torch.tensor([0, 2, 3], device=dev)
    order = torch.stack([torch.cat([rest[:p], torch.tensor([1], device=dev), rest[p:]])
                         for p in (i % 4).tolist()])
    sigma = torch.where(i % 3 == 0, 0.1, torch.where(i % 3 == 1, 2.0, d.sigma))
    factors = d.factors.clone()
    factors[0] = torch.tensor([1.4, 0.6, 1.4, -0.1])
    factors[1] = torch.tensor([0.6, 1.4, 0.6, 0.1])
    draws = da.AugDraws(gates, factors, order, sigma.float())
    if n >= 5:
        for j, p in enumerate(da.GATES):
            assert (draws.gates[:, j] < p).any() and (draws.gates[:, j] >= p).any(), j
        at = (draws.order == 1).long().argmax(-1)
        assert set(at[draws.gates[:, 0] < da.GATES[0]].tolist()) == {0, 1, 2, 3}
        blur = draws.gates[:, 2] < da.GATES[2]
        assert set(torch.tensor([0.1, 2.0]).tolist()) <= set(draws.sigma[blur].tolist())
    return draws


def _launches():
    return sum(k.launches for k in device_aug_cuda.KERNELS)


def _gap(got, want, draws=None, tol=0.0):
    """max |got - want|; with ``draws``, a pixel of a solarized image whose two values
    lie within ``tol`` of the threshold on either side counts by its gap before
    solarize."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    if draws is not None:
        sol = (draws.gates[:, 3] < da.GATES[3]).view(-1, 1, 1, 1)
        across = (sol & (torch.minimum(got, want) >= 127 - tol)
                  & (torch.maximum(got, want) <= 128 + tol))
        d = torch.where(across, torch.minimum(d, (got + want - 255).abs()), d)
    return d.max().item()


@pytest.mark.parametrize("in_dtype", [torch.uint8, torch.float32], ids=["u8", "f32in"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_strong_augment_matches_plain(cuda, shape, dtype, in_dtype):
    _, n, h, w = shape
    img = _images(n, h, w, cuda, seed=h).to(in_dtype)
    draws = _draws(n, cuda, seed=w)
    got = da.strong_augment(img, draws, dtype)
    want = da.strong_augment_plain(img, draws, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, h, w, 3) and got.is_contiguous()
    gap = _gap(got, want, draws, TOL[dtype])
    print(f"{shape[0]} {dtype}: max |kernel - plain| {gap!r}, "
          f"{int((got != want).sum())} of {got.numel()} values differ")
    assert gap <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_scale_jitter_matches_plain(cuda, shape, dtype):
    _, n, h, w = shape
    g = torch.Generator().manual_seed(n)
    img = da.strong_augment_plain(_images(n, h, w, cuda, seed=n), _draws(n, cuda, seed=1), dtype)
    hw = torch.stack([torch.randint(h // 2, h + 1, (n,), generator=g),
                      torch.randint(w // 2, w + 1, (n,), generator=g)], -1).float()
    hw[0] = torch.tensor([h, w])
    ratio = 0.5 + 0.5 * torch.rand(n, generator=g)
    ratio[0], ratio[1] = 0.5, 0.99999
    boxes = torch.rand(n, 7, 4, generator=g) * torch.tensor([w, h, w, h])
    hw, ratio, boxes = hw.to(cuda), ratio.to(cuda), boxes.to(cuda)
    got, got_b = da.scale_jitter(img, hw, boxes, MEAN, ratio, dtype)
    want, want_b = da.scale_jitter_plain(img, hw, boxes, MEAN, ratio, dtype)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == img.shape
    print(f"{shape[0]} {dtype}: scale jitter max |kernel - plain| {_gap(got, want)!r}")
    assert _gap(got, want) <= TOL[dtype]
    assert torch.equal(got_b, want_b)


def test_kernels_are_deterministic(cuda):
    img = _images(8, 200, 300, cuda, seed=5)
    draws = _draws(8, cuda, seed=6)
    a = da.strong_augment(img, draws, torch.bfloat16)
    b = da.strong_augment(img, draws, torch.bfloat16)
    assert torch.equal(a, b)


def test_launches_per_call(cuda):
    img = _images(4, 64, 96, cuda, seed=7)
    draws = _draws(4, cuda, seed=8)
    hw = torch.tensor([[64.0, 96.0]] * 4, device=cuda)
    ratio = torch.full((4,), 0.75, device=cuda)
    boxes = torch.zeros(4, 3, 4, device=cuda)
    before = [k.launches for k in device_aug_cuda.KERNELS]
    total = _launches()
    out = da.strong_augment(img, draws, torch.bfloat16)
    assert [k.launches - b for k, b in zip(device_aug_cuda.KERNELS, before)] == [1, 1, 0]
    assert _launches() == total + device_aug_cuda.STRONG_LAUNCHES
    da.scale_jitter(out, hw, boxes, MEAN, ratio, torch.bfloat16)
    assert [k.launches - b for k, b in zip(device_aug_cuda.KERNELS, before)] == [1, 1, 1]
    assert _launches() == (total + device_aug_cuda.STRONG_LAUNCHES
                                          + device_aug_cuda.JITTER_LAUNCHES)
    # the plain version on the card launches none of them
    da.strong_augment_plain(img, draws, torch.bfloat16)
    assert [k.launches - b for k, b in zip(device_aug_cuda.KERNELS, before)] == [1, 1, 1]


def test_draws_and_augmentation_make_no_host_sync(cuda):
    """``draw_aug``, ``draw_jitter``, ``strong_augment`` and ``scale_jitter`` for both
    batches of a mutual step, as the step calls them, under the sync debug mode."""
    n, h, w = 4, 96, 160
    limg, uimg = _images(n, h, w, cuda, seed=9), _images(n, h, w, cuda, seed=10)
    hw = torch.tensor([[96.0, 160.0], [80.0, 160.0], [96.0, 120.0], [60.0, 100.0]],
                      device=cuda)
    boxes = torch.rand(n, 5, 4, device=cuda) * 50
    gen = torch.Generator(device=cuda).manual_seed(11)
    da.strong_augment(limg, _draws(n, cuda, 12), torch.bfloat16)      # built and loaded
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        aug_l, jit_l = da.draw_aug(n, gen, cuda), da.draw_jitter(n, gen, cuda)
        aug_u, jit_u = da.draw_aug(n, gen, cuda), da.draw_jitter(n, gen, cuda)
        for img, aug, jit in ((limg, aug_l, jit_l), (uimg, aug_u, jit_u)):
            strong = da.strong_augment(img, aug, torch.bfloat16)
            da.scale_jitter(strong, hw, boxes, MEAN, jit, torch.bfloat16)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def _micro_detector(dev):
    cfg = get_cfg()
    cfg.merge_from_list(["MODEL.VGG.DEPTH", "11", "MODEL.VGG.PRETRAIN", "",
                         "MODEL.ROI_HEADS.NUM_CLASSES", "8",
                         "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "64", "MODEL.RPN.PRE_NMS_TOPK_TEST", "64",
                         "MODEL.RPN.POST_NMS_TOPK_TRAIN", "32",
                         "MODEL.RPN.POST_NMS_TOPK_TEST", "32",
                         "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "16",
                         "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
                         "MODEL.ROI_BOX_HEAD.FC_DIM", "32", "TEST.DETECTIONS_PER_IMAGE", "8",
                         "UNSUPNET.UNSUP_ROI_BUDGET", "8", "UNSUPNET.BURN_UP_STEP", "0",
                         "SOLVER.IMG_PER_BATCH_LABEL", "2", "SOLVER.IMG_PER_BATCH_UNLABEL", "2",
                         "SOLVER.AMP.ENABLED", "True", "INPUT.CANVAS.WIDE", "(96, 160)"])
    det = PTDetector(Arch.from_cfg(cfg), device=dev)
    det.init(seed=0)
    return cfg, det


def test_mutual_step_draws_and_augment_make_no_host_sync(cuda):
    """A whole bf16 mutual step, with the sync debug mode on from the step's start
    through its draws (up to ``ema``) and through its ``augment`` stage."""
    cfg, det = _micro_detector(cuda)
    state = create_train_state(det, build_optimizer(cfg, det))
    _, mutual = make_train_steps(cfg, det)
    n, h, w = 2, 96, 160
    hw = torch.tensor([[96.0, 160.0], [72.0, 140.0]], device=cuda)
    limg = ImageBatch(_images(n, h, w, cuda, seed=13), hw)
    uimg = ImageBatch(_images(n, h, w, cuda, seed=14), hw)
    lgt = GroundTruth(torch.tensor([[[10.0, 10.0, 60.0, 50.0]] * 3] * n, device=cuda),
                      torch.ones(n, 3, dtype=torch.int32, device=cuda),
                      torch.ones(n, 3, dtype=torch.bool, device=cuda))
    checked = {"ema": 0, "pseudo_labels": 2, "augment": 0}   # 2: "error"

    def mark(stage):
        if stage in checked:
            torch.cuda.set_sync_debug_mode(checked[stage])

    before = _launches()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = mutual(state, limg, lgt, uimg,
                                torch.Generator(device=cuda).manual_seed(15), mark)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert _launches() - before == 2 * (device_aug_cuda.STRONG_LAUNCHES
                                                       + device_aug_cuda.JITTER_LAUNCHES)
    assert all(torch.isfinite(v).all() for v in metrics.values())
