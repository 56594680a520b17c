"""ROIAlign-backward inputs that cross the tiles of the CUDA kernel ``csrc/roi_align_bwd.cu``.

Numpy only, so that the CPU parity test (``test_torch_roi_align_bwd.py``, the plain
backward against JAX's ``_bwd_einsum``) and the card's kernel tests
(``test_torch_kernels.py``, which run without JAX) share them. The kernel tiles
dF into tiles of map cells that hold every channel; the wider the channels, the
smaller the tiles (``roi_align_cuda.bwd_plan``):

- ``c512``: 6 x 6 tiles of 7 x 14 cells, the last band 3 rows high (H is not a
  multiple of the band height), with boxes on tile corners; ``c64``: 5 bands of
  8 rows; ``c16``: 2 bands of 19 rows; ``c24``: C not a multiple of 16, so that a
  lane holds 4 channels, not 16;
- ``wide``: a 7 x 1600 map in 2 x 4 tiles of 4 x 400 cells, with boxes that
  straddle every row and tile boundary;
- ``tiny``: boxes under one map cell, whose bins share a few taps;
- ``whole``: boxes covering the whole map, and one a little beyond it;
- ``edges``: boxes over every edge, wholly outside, of zero width and height,
  inverted, and in image 0 non-finite (NaN and inf corners);
- ``no_live_roi``: image 1 has no ROI with a gradient.

Every case has zero gradient rows (the padded ROIs of the masked losses).
``make(name)`` -> feature shape (N, H, W, C), boxes (N, R, 4) f32 XYXY in image
coordinates (stride 16), g (N, R, 7, 7, C) f32, and the images that hold a
non-finite box (where the plain version's dF is NaN and the kernel's is not).
"""

import numpy as np

STRIDE = 16.0
P = 7
# name: (N, H, W, C, R)
CASES = {
    "wide": (2, 7, 1600, 16, 24),
    "c16": (2, 38, 84, 16, 40),
    "c64": (2, 38, 84, 64, 40),
    "c512": (1, 38, 84, 512, 24),
    "c24": (2, 12, 20, 24, 8),
    "tiny": (2, 12, 20, 16, 16),
    "whole": (1, 38, 84, 64, 8),
    "edges": (2, 12, 20, 16, 16),
    "no_live_roi": (2, 12, 20, 16, 16),
}


def _random_boxes(rng, n, r, h, w):
    img_w, img_h = w * STRIDE, h * STRIDE
    xy = rng.uniform(0, 1, (n, r, 2)) * [img_w + 64, img_h + 64] - 32
    wh = rng.uniform(0, 1, (n, r, 2)) ** 2 * [img_w / 2, img_h / 2] + 4
    return np.concatenate([xy, xy + wh], -1)


def make(name, seed=0):
    n, h, w, c, r = CASES[name]
    rng = np.random.RandomState(seed + 1009 * len(name) + c)
    img_w, img_h = w * STRIDE, h * STRIDE
    boxes = _random_boxes(rng, n, r, h, w)
    if name == "wide":
        # across every row boundary, and across every tile boundary
        for i, edge in enumerate(range(1, h)):
            x = rng.uniform(0, img_w - 600)
            boxes[:, i] = [x, edge * STRIDE - 20, x + 500, edge * STRIDE + 20]
        boxes[:, h] = [0, 0, img_w, img_h / 2]
    if name == "c512":
        for i, (yy, xx) in enumerate([(7, 14), (14, 28), (35, 70), (37, 83)]):
            boxes[:, i] = [xx * STRIDE - 30, yy * STRIDE - 30, xx * STRIDE + 30,
                           yy * STRIDE + 30]                          # on tile corners
    if name == "tiny":
        xy = rng.uniform(0, 1, (n, r, 2)) * [img_w, img_h]
        boxes = np.concatenate([xy, xy + rng.uniform(1, 12, (n, r, 2))], -1)
    if name == "whole":
        boxes[:, 0] = [0, 0, img_w, img_h]
        boxes[:, 1] = [-8, -8, img_w + 8, img_h + 8]
        boxes[:, 2] = [0.5, 0.5, img_w - 0.5, img_h - 0.5]
    if name == "edges":
        boxes[:, 0] = [-60.0, -60.0, img_w + 60, img_h + 60]          # over every edge
        boxes[:, 1] = [img_w + 40, 8.0, img_w + 90, 90.0]             # wholly outside
        boxes[:, 2] = [100.0, 100.0, 100.0, 180.0]                    # zero width
        boxes[:, 3] = [60.0, 50.0, 140.0, 50.0]                       # zero height
        boxes[:, 4] = [200.0, 150.0, 190.0, 140.0]                    # inverted
        boxes[:, 5] = [img_w - 10, img_h - 10, img_w + 30, img_h + 30]
        boxes[:, 6] = [-30.0, -30.0, 5.0, 5.0]                        # top-left corner
        boxes[0, 7] = [np.nan, 20.0, 60.0, 90.0]
        boxes[0, 8] = [10.0, 20.0, np.inf, 90.0]
        boxes[0, 9] = [-np.inf, -np.inf, np.inf, np.inf]
    g = rng.randn(n, r, P, P, c)
    g[:, r - 4:] = 0.0                                                # padded ROI rows
    g[:, 1] = 0.0
    if name == "no_live_roi":
        g[1] = 0.0
    nonfinite = [i for i in range(n) if not np.isfinite(boxes[i]).all()]
    return (n, h, w, c), boxes.astype(np.float32), g.astype(np.float32), nonfinite
