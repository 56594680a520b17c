"""Single-image inference API (detectron2 ``DefaultPredictor`` equivalent).

Takes a raw BGR uint8 numpy image, applies the test-time resize, runs
:meth:`PTDetector.detect` on the static canvas, and returns detections in
original-image coordinates. Usage:

    from probabilisticteacher_torch.predictor import Predictor
    pred = Predictor(cfg, jax_params=params_np)   # or state_dict=...
    out = pred(image_bgr)   # {"boxes", "scores", "classes"}

Checkpoint files (Orbax, detectron2 ``.pth``) are read by a later slice.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .config import Arch
from .modeling.detector import PTDetector
from .structures import ImageBatch
from .weights import params_from_jax


def resize_shortest_edge(img: np.ndarray, boxes: np.ndarray, short: int,
                         max_size: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """detectron2 ResizeShortestEdge: scale so min side == short, cap long side.

    PIL is imported only when the size actually changes.
    """
    h, w = img.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((nw, nh), Image.BILINEAR), dtype=np.uint8)
    if boxes.size:
        boxes = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    return img, boxes, scale


class Predictor:
    """Weights come from a port ``state_dict``, a JAX param tree of numpy arrays
    (through :func:`weights.params_from_jax`), or, when neither is given, the
    seeded :meth:`PTDetector.init`. Runs on ``device``: the card unless the
    caller names another."""

    def __init__(self, cfg, state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 jax_params: Optional[Mapping[str, Any]] = None, device=None):
        self.cfg = cfg
        self.arch = Arch.from_cfg(cfg)
        self.detector = PTDetector(self.arch, device=device).eval()
        if jax_params is not None:
            state_dict = params_from_jax(jax_params, self.arch)
        if state_dict is None:
            self.detector.init()
        else:
            self.detector.load_state_dict(state_dict)

    def __call__(self, image_bgr: np.ndarray) -> Dict[str, np.ndarray]:
        """image_bgr: (H, W, 3) uint8 -> detections in original coordinates."""
        img, _, scale = resize_shortest_edge(
            image_bgr, np.zeros((0, 4), np.float32),
            self.cfg.INPUT.MIN_SIZE_TEST, self.cfg.INPUT.MAX_SIZE_TEST,
        )
        hh, ww = img.shape[:2]
        ch, cw = self.cfg.INPUT.CANVAS.WIDE if ww > hh else self.cfg.INPUT.CANVAS.TALL
        canvas = np.zeros((ch, cw, 3), np.float32)
        canvas[:min(hh, ch), :min(ww, cw)] = img[:ch, :cw]
        dev = self.detector.device
        batch = ImageBatch(torch.from_numpy(canvas[None]).to(dev),
                           torch.tensor([[hh, ww]], dtype=torch.float32, device=dev))
        dets = self.detector.detect(batch)
        v = dets.valid[0].cpu().numpy()
        return {
            "boxes": dets.boxes[0].cpu().numpy()[v] / scale,
            "scores": dets.scores[0].cpu().numpy()[v],
            "classes": dets.classes[0].cpu().numpy()[v],
        }
