"""NMS inputs that cross the 64-row tiles of the CUDA kernel ``csrc/nms.cu``.

Numpy only, so that the CPU parity tests (``test_torch_nms.py``, against both JAX
NMS implementations) and the card's kernel tests (``test_torch_kernels.py``, which
run without JAX) share them. Scores fall with the row index unless a case ties
them, so a row's index is its place in the sorted order and the cases can put
chains, ties and invalid rows at the tile boundaries (rows 63/64, 127/128, ...).

``make(name, n)`` -> boxes (n, K, 4) f32, scores (n, K) f32, valid (n, K) bool,
max_keep, IoU threshold; each image has its own seed.
"""

import numpy as np

# name: (K, max_keep, IoU threshold); "large" runs on the card only
CASES = {
    "chain": (257, 257, 0.5),          # neighbours overlap: every other row kept
    "chain_3": (257, 257, 0.2),        # rows two apart overlap too: every third kept
    "ties": (257, 257, 0.5),           # tied duplicate groups over rows 56-72 and 124-132
    "k1": (1, 1, 0.5),
    "k63": (63, 63, 0.5),
    "k64": (64, 64, 0.5),
    "k65": (65, 65, 0.5),
    "k257": (257, 257, 0.5),
    "max_keep_in_tile": (257, 90, 0.5),  # the budget runs out inside tile 1
    "invalid_tile": (257, 257, 0.5),   # rows 64-127 invalid
    "all_invalid": (130, 50, 0.5),
    "large": (12001, 2000, 0.7),
}
CPU_CASES = [name for name in CASES if name != "large"]
CHAINS = ((60, 71), (120, 201))        # rows 60-70 and 120-200
TIES = ((56, 73), (124, 133))          # tied scores over rows 56-72 and 124-132


def _clustered(rng, k, extent):
    centers = rng.uniform(0, extent, (k // 20 + 1, 2))
    xy = centers[rng.randint(0, len(centers), k)] + rng.uniform(-12, 12, (k, 2))
    wh = rng.uniform(5, 60, (k, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def _image(name, rng):
    k = CASES[name][0]
    boxes = _clustered(rng, k, 200.0 if k < 1000 else 1300.0)
    scores = np.linspace(1.0, 0.01, k, dtype=np.float32)
    valid = rng.rand(k) > 0.1
    if name in ("ties", "large"):
        for lane, (a, b) in enumerate(TIES):
            # two boxes of their own, each repeated with a 1 px jitter (IoU > 0.8)
            pair = np.float32([[3000, 3000, 3040, 3030], [3100, 3000, 3130, 3050]]) + 200 * lane
            boxes[a:b] = pair[np.arange(b - a) % 2] + rng.uniform(-1, 1, (b - a, 4)).astype(
                np.float32)
            scores[a:b] = scores[a]
            valid[a:b] = True
    if name in ("chain", "chain_3", "large"):
        for lane, (a, b) in enumerate(CHAINS):
            x = np.arange(b - a, dtype=np.float32)[:, None] * 3.0      # width 10, step 3
            y = np.float32(2000.0 + 100.0 * lane)
            boxes[a:b] = np.concatenate([x, x * 0 + y, x + 10, x * 0 + y + 10], 1)
            valid[a:b] = True
    if name == "max_keep_in_tile":
        # a grid of separate boxes with every tenth row a near copy of the one before
        xs, ys = np.meshgrid(np.arange(17) * 100.0, np.arange(16) * 100.0)
        grid = np.stack([xs.ravel(), ys.ravel(), xs.ravel() + 50, ys.ravel() + 50], 1)[:k]
        boxes = grid.astype(np.float32)
        boxes[10::10] = boxes[9:-1:10] + 2
        valid[:] = True
    if name == "invalid_tile":
        valid[64:128] = False
    if name == "all_invalid":
        valid[:] = False
    return boxes, scores, valid


def make(name, n=1, seed=0):
    k, max_keep, thresh = CASES[name]
    images = [_image(name, np.random.RandomState(seed + 7919 * i + k)) for i in range(n)]
    boxes, scores, valid = (np.stack(x) for x in zip(*images))
    return boxes, scores, valid, max_keep, thresh
