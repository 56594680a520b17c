"""Single-image inference API (detectron2 ``DefaultPredictor`` equivalent).

Takes a raw BGR uint8 numpy image, applies the test-time resize, runs
:meth:`PTDetector.detect` on the static canvas, and returns detections in
original-image coordinates. Usage:

    from probabilisticteacher_torch.predictor import Predictor
    pred = Predictor(cfg, checkpoint_path="output/c2f/model_0030000")
    out = pred(image_bgr)   # {"boxes", "scores", "classes"}
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from .config import Arch
from .data.loader import resize_shortest_edge
from .modeling.detector import PTDetector
from .structures import ImageBatch
from .weights import params_from_jax


class Predictor:
    """Weights come from a checkpoint file (``checkpoint_path``: the teacher by
    default, as the headline metric tracks the teacher, ``trainer.py:529-542``; a
    detectron2 ``.pth``/``.pkl`` goes through ``d2_import``), a port ``state_dict``,
    a JAX param tree of numpy arrays (through :func:`weights.params_from_jax`), or,
    when none is given, the seeded :meth:`PTDetector.init`. Runs on ``device``:
    the card unless the caller names another."""

    def __init__(self, cfg, checkpoint_path: Optional[str] = None,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 jax_params: Optional[Mapping[str, Any]] = None, use_teacher: bool = True,
                 device=None):
        self.cfg = cfg
        self.arch = Arch.from_cfg(cfg)
        self.detector = PTDetector(self.arch, device=device).eval()
        if jax_params is not None:
            state_dict = params_from_jax(jax_params, self.arch)
        if state_dict is not None:
            self.detector.load_state_dict(state_dict)
        elif checkpoint_path:
            self.detector.load_state_dict(self._checkpoint_weights(checkpoint_path, use_teacher))
        else:
            self.detector.init()

    def _checkpoint_weights(self, path: str, use_teacher: bool) -> Dict[str, torch.Tensor]:
        from .checkpoint import load_weights
        from .d2_import import is_d2_checkpoint, load_detectron2_weights
        from .engine.steps import TrainState

        student = self.detector
        teacher = PTDetector(self.arch, device=student.device).eval()
        state = TrainState(0, student, teacher, None)
        if is_d2_checkpoint(path):
            load_detectron2_weights(path, state, self.arch.pooler_resolution)
        else:
            load_weights(path, state)
        return (teacher if use_teacher else student).state_dict()

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
        with torch.inference_mode():
            dets = self.detector.detect(batch)
        v = dets.valid[0].cpu().numpy()
        return {
            "boxes": dets.boxes[0].cpu().numpy()[v] / scale,
            "scores": dets.scores[0].cpu().numpy()[v],
            "classes": dets.classes[0].cpu().numpy()[v],
        }
