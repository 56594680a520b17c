"""Host data pipeline: decode, weak aug, aspect bucketing, static padded batches.

The port's copy of the JAX package's ``data/loader.py`` (numpy and PIL; same
seeds, same batches). It replaces the reference's torch DataLoader stack
(``pt/data/build.py``, ``pt/data/common.py``, ``pt/data/dataset_mapper.py``) with a
numpy pipeline that feeds static shapes:

- weak augmentation on host: ResizeShortestEdge(600, max 1333) + random hflip
  (``dataset_mapper.py:51-59``); geometry is shared by the strong view, which is
  generated on the device inside the train step (data/device_aug.py);
- aspect-ratio bucketing into two static canvases (w>h vs h>w), mirroring
  ``AspectRatioGroupedSemiSupDatasetTwoCrop`` (``common.py:106-180``); a batch is
  emitted when the labeled stream has a full bucket AND the unlabeled stream
  has one, chosen independently, so the two halves may use different canvases
  (the reference's bucket keys are per-stream too, ``common.py:148-163``);
- GT padded to MAX_GT with a validity mask (structures.GroundTruth);
- background prefetch thread (decode overlaps the device step).

Decode runs in the native C++ loader (data/native.py) when it builds, else in PIL.
A :class:`SemiSupLoader` whose ``tracer`` is set (``tracing.py``) records a
``loader.map`` span around each image's mapping, tagged with its stream, and a
``loader.batch`` span around the making of each batch.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..tracing import span

try:
    from PIL import Image
except ImportError:  # pragma: no cover
    Image = None


# --------------------------------------------------------------------------- #
# single-image transforms
# --------------------------------------------------------------------------- #
def read_image(path: str, fmt: str = "BGR") -> np.ndarray:
    """uint8 (H, W, 3) honoring cfg.INPUT.FORMAT ("BGR" default, or "RGB") —
    detectron2 ``read_image(..., format)`` parity (``dataset_mapper.py:97``)."""
    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.uint8)
    return img[:, :, ::-1] if fmt == "BGR" else img


def resize_shortest_edge(img: np.ndarray, boxes: np.ndarray, short: int,
                         max_size: int) -> Tuple[np.ndarray, np.ndarray, float]:
    """detectron2 ResizeShortestEdge: scale so min side == short, cap long side."""
    h, w = img.shape[:2]
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    if (nh, nw) != (h, w):
        img = np.asarray(
            Image.fromarray(img).resize((nw, nh), Image.BILINEAR), dtype=np.uint8
        )
    if boxes.size:
        boxes = boxes * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    return img, boxes, scale


def random_crop(img: np.ndarray, boxes: np.ndarray, crop_type: str,
                crop_size, rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """detectron2 RandomCrop: 'relative' / 'relative_range' / 'absolute'."""
    h, w = img.shape[:2]
    if crop_type == "relative":
        ch, cw = int(h * crop_size[0] + 0.5), int(w * crop_size[1] + 0.5)
    elif crop_type == "relative_range":
        sz = np.asarray(crop_size, np.float32)
        ch_r, cw_r = sz + rng.random(2) * (1.0 - sz)
        ch, cw = int(h * ch_r + 0.5), int(w * cw_r + 0.5)
    elif crop_type == "absolute":
        ch, cw = min(int(crop_size[0]), h), min(int(crop_size[1]), w)
    else:
        raise ValueError(crop_type)
    y0 = int(rng.integers(0, h - ch + 1))
    x0 = int(rng.integers(0, w - cw + 1))
    img = img[y0:y0 + ch, x0:x0 + cw]
    if boxes.size:
        boxes = boxes - np.array([x0, y0, x0, y0], np.float32)
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, cw)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, ch)
    return img, boxes


def hflip(img: np.ndarray, boxes: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    w = img.shape[1]
    img = img[:, ::-1]
    if boxes.size:
        boxes = boxes.copy()
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x1
    return img, boxes


# --------------------------------------------------------------------------- #
# sample -> padded canvas record
# --------------------------------------------------------------------------- #
class Mapper:
    """Weak augmentation + canvas padding for one dataset dict.

    Uses the native C++ loader (data/native.py: decode + PIL-parity resample +
    flip + pad in one GIL-released call) when available and enabled
    (``DATALOADER.NATIVE``); falls back to the PIL path otherwise.
    """

    def __init__(self, cfg, is_train: bool = True):
        self.short_sizes = tuple(cfg.INPUT.MIN_SIZE_TRAIN) if is_train else (cfg.INPUT.MIN_SIZE_TEST,)
        # "choice" picks one of the listed sizes; "range" samples uniformly in
        # [min, max] (detectron2 build_augmentation sample_style parity)
        self.size_sampling = cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING if is_train else "choice"
        assert self.size_sampling in ("choice", "range"), self.size_sampling
        self.fmt = cfg.INPUT.FORMAT
        assert self.fmt in ("BGR", "RGB"), self.fmt
        self.max_size = cfg.INPUT.MAX_SIZE_TRAIN if is_train else cfg.INPUT.MAX_SIZE_TEST
        self.do_flip = is_train and cfg.INPUT.RANDOM_FLIP != "none"
        self.canvas_wide = tuple(cfg.INPUT.CANVAS.WIDE)
        self.canvas_tall = tuple(cfg.INPUT.CANVAS.TALL)
        self.max_gt = cfg.INPUT.MAX_GT
        self.is_train = is_train
        # RandomCrop before resize (dataset_mapper.py:51-59; off in all PT configs)
        self.crop = is_train and bool(cfg.INPUT.CROP.ENABLED)
        self.crop_type = cfg.INPUT.CROP.TYPE
        self.crop_size = tuple(cfg.INPUT.CROP.SIZE)
        # the native fast path covers the default decode->resize->flip pipeline only
        self.use_native = bool(cfg.DATALOADER.get("NATIVE", True)) and not self.crop

    def _load_native(self, record, short, flip):
        from . import native

        if not (self.use_native and native.available()):
            return None
        h0, w0 = record["height"], record["width"]
        scale = short / min(h0, w0)
        if max(h0, w0) * scale > self.max_size:
            scale = self.max_size / max(h0, w0)
        nh, nw = int(round(h0 * scale)), int(round(w0 * scale))
        bucket = 0 if nw > nh else 1
        ch, cw = self.canvas_wide if bucket == 0 else self.canvas_tall
        out = native.load_image(record["file_name"], short, self.max_size, flip, (ch, cw))
        if out is None:
            return None
        canvas, hw, scale_out = out
        return canvas, hw, scale_out, bucket, (nh, nw)

    def __call__(self, record: dict, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        annos = record.get("annotations", [])
        boxes = np.asarray([a["bbox"] for a in annos], np.float32).reshape(-1, 4)
        classes = np.asarray([a["category_id"] for a in annos], np.int64).reshape(-1)

        if self.size_sampling == "range":
            short = int(rng.integers(min(self.short_sizes), max(self.short_sizes) + 1))
        else:
            short = int(rng.choice(self.short_sizes))
        flip = bool(self.do_flip and rng.random() < 0.5)

        nat = self._load_native(record, short, flip)
        if nat is not None:
            canvas, hwf, scale, bucket, (nh, nw) = nat
            if self.fmt == "RGB":  # native path decodes to BGR
                canvas = np.ascontiguousarray(canvas[:, :, ::-1])
            h, w = int(hwf[0]), int(hwf[1])
            if boxes.size:
                h0, w0 = record["height"], record["width"]
                boxes = boxes * np.array([nw / w0, nh / h0, nw / w0, nh / h0], np.float32)
                if flip:
                    x1 = boxes[:, 0].copy()
                    boxes[:, 0] = nw - boxes[:, 2]
                    boxes[:, 2] = nw - x1
        else:
            img = read_image(record["file_name"], self.fmt)
            if self.crop:
                img, boxes = random_crop(img, boxes, self.crop_type, self.crop_size, rng)
            img, boxes, scale = resize_shortest_edge(img, boxes, short, self.max_size)
            if flip:
                img, boxes = hflip(img, boxes)

            h, w = img.shape[:2]
            bucket = 0 if w > h else 1
            ch, cw = self.canvas_wide if bucket == 0 else self.canvas_tall
            # safety crop for canvases tighter than the resize budget
            img = img[:ch, :cw]
            h, w = img.shape[:2]

            canvas = np.zeros((ch, cw, 3), np.uint8)
            canvas[:h, :w] = img

        g = self.max_gt
        gt_boxes = np.zeros((g, 4), np.float32)
        gt_classes = np.zeros((g,), np.int32)
        gt_valid = np.zeros((g,), bool)
        if boxes.size:
            boxes[:, 0::2] = boxes[:, 0::2].clip(0, w)
            boxes[:, 1::2] = boxes[:, 1::2].clip(0, h)
            keep = (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])
            boxes, classes = boxes[keep][:g], classes[keep][:g]
            k = len(boxes)
            gt_boxes[:k] = boxes
            gt_classes[:k] = classes
            gt_valid[:k] = True

        return {
            "image": canvas,
            "image_hw": np.asarray([h, w], np.float32),
            "gt_boxes": gt_boxes,
            "gt_classes": gt_classes,
            "gt_valid": gt_valid,
            "bucket": bucket,
            "image_id": record["image_id"],
            "orig_hw": np.asarray([record["height"], record["width"]], np.float32),
            "scale": np.float32(scale),
            "flipped": False,  # eval loader never flips
        }


def _stack(records: Sequence[dict]) -> Dict[str, np.ndarray]:
    out = {}
    for k in ("image", "image_hw", "gt_boxes", "gt_classes", "gt_valid"):
        out[k] = np.stack([r[k] for r in records])
    # images ship to the device as uint8 (4x less host->device traffic — the
    # dominant per-step cost on PCIe/tunneled hosts); the on-device aug /
    # preprocess casts to the compute dtype
    assert out["image"].dtype == np.uint8, out["image"].dtype
    out["image_id"] = [r["image_id"] for r in records]
    out["scale"] = np.asarray([r["scale"] for r in records], np.float32)
    out["orig_hw"] = np.stack([r["orig_hw"] for r in records])
    return out


class _InfiniteSampler:
    """Shuffled infinite stream over dataset indices (TrainingSampler analog)."""

    def __init__(self, n: int, seed: int):
        self.n = n
        self.rng = np.random.Generator(np.random.PCG64(seed))

    def __iter__(self) -> Iterator[int]:
        while True:
            for i in self.rng.permutation(self.n):
                yield int(i)


class SemiSupLoader:
    """Joint labeled+unlabeled iterator with aspect bucketing.

    Yields dicts {"label": batch, "unlabel": batch} where each batch is the
    _stack() output. Per-rank batch sizes are (total / world_size), asserting
    divisibility like the reference (``pt/data/build.py:173-187``).
    """

    def __init__(self, cfg, label_dicts: List[dict], unlabel_dicts: List[dict],
                 seed: int = 0, world_size: int = 1, prefetch: int = 2):
        for total in (cfg.SOLVER.IMG_PER_BATCH_LABEL, cfg.SOLVER.IMG_PER_BATCH_UNLABEL):
            assert total % world_size == 0, (
                f"Batch size {total} not divisible by world size {world_size}"
            )
        self.bs_label = cfg.SOLVER.IMG_PER_BATCH_LABEL // world_size
        self.bs_unlabel = cfg.SOLVER.IMG_PER_BATCH_UNLABEL // world_size
        if cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS:
            label_dicts = [d for d in label_dicts if d.get("annotations")]
        assert label_dicts, "labeled dataset is empty"
        assert unlabel_dicts, "unlabeled dataset is empty"
        self.label_dicts = label_dicts
        self.unlabel_dicts = unlabel_dicts
        self.mapper = Mapper(cfg, is_train=True)
        self.seed = seed
        self.label_iter = iter(_InfiniteSampler(len(label_dicts), seed + 2))
        self.unlabel_iter = iter(_InfiniteSampler(len(unlabel_dicts), seed + 3))
        self.prefetch = prefetch
        self.num_workers = max(1, int(cfg.DATALOADER.NUM_WORKERS))
        self._pool = None
        if self.num_workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            # threads, not processes: PIL decode and the native C loader release
            # the GIL, so this parallelizes like the reference's worker processes
            self._pool = ThreadPoolExecutor(self.num_workers)
        self._sample_counter = 0
        self.tracer = None   # tracing.py's Tracer, or None: no spans
        self._q: Optional[queue.Queue] = None
        # PERSISTENT aspect buckets: surplus decoded records survive across
        # batches instead of being discarded (parity with the reference's
        # AspectRatioGroupedSemiSupDatasetTwoCrop, pt/data/common.py:139-180;
        # per-call buckets would waste up to 4x the labeled batch in host
        # decode and bias sampling toward whichever bucket filled first)
        self._label_buckets: Dict[int, list] = {0: [], 1: []}
        self._unlabel_buckets: Dict[int, list] = {0: [], 1: []}

    def _map_one(self, item):
        """Corrupt-sample resilience: skip undecodable images (returns None), like
        the reference's MapDataset retry-with-fallback (``pt/data/common.py:35-57``)."""
        d, seed, stream = item
        try:
            with span(self.tracer, "loader.map", stream):
                return self.mapper(d, np.random.Generator(np.random.PCG64(seed)))
        except Exception as e:
            import logging

            logging.getLogger("probabilisticteacher_torch").warning(
                f"Failed to load {d.get('file_name')}: {e}; skipping"
            )
            return None

    def _draw(self, stream: str, n: int):
        dicts, it = ((self.label_dicts, self.label_iter) if stream == "l"
                     else (self.unlabel_dicts, self.unlabel_iter))
        jobs = []
        for _ in range(n):
            self._sample_counter += 1
            jobs.append((dicts[next(it)], self.seed * 1_000_003 + self._sample_counter, stream))
        if self._pool is not None:
            return list(self._pool.map(self._map_one, jobs))
        return [self._map_one(j) for j in jobs]

    @staticmethod
    def _ready(buckets: Dict[int, list], bs: int) -> Optional[int]:
        """Fullest bucket holding a complete batch (None if neither does).
        Draining the fuller bucket first keeps both aspect groups flowing
        instead of starving whichever fills slower."""
        full = [b for b in (0, 1) if len(buckets[b]) >= bs]
        return max(full, key=lambda b: len(buckets[b])) if full else None

    def _produce_one(self) -> Dict[str, Dict[str, np.ndarray]]:
        label_buckets = self._label_buckets
        unlabel_buckets = self._unlabel_buckets
        while True:
            # label and unlabel pick their ready buckets INDEPENDENTLY (a batch
            # may pair wide labeled with tall unlabeled), matching the
            # reference's decoupled bucket keys (pt/data/common.py:148-163).
            # Coupling them is a host-memory leak: with mismatched aspect
            # distributions the same-bucket condition can never fire and one
            # stream's bucket grows without bound.
            bl = self._ready(label_buckets, self.bs_label)
            bu = self._ready(unlabel_buckets, self.bs_unlabel)
            if bl is not None and bu is not None:
                # consume from the front; the rest stays for the next batch
                lb = label_buckets[bl][: self.bs_label]
                ub = unlabel_buckets[bu][: self.bs_unlabel]
                label_buckets[bl] = label_buckets[bl][self.bs_label:]
                unlabel_buckets[bu] = unlabel_buckets[bu][self.bs_unlabel:]
                return {"label": _stack(lb), "unlabel": _stack(ub)}
            # draw only for the stream that lacks a full bucket: each bucket is
            # bounded by bs + chunk records, so host RSS cannot creep over a
            # 30k-iter run no matter how the two streams' aspects are skewed
            chunk = self.num_workers
            if bl is None:
                for rec in self._draw("l", chunk):
                    if rec is not None:
                        label_buckets[rec["bucket"]].append(rec)
            if bu is None:
                for rec in self._draw("u", chunk):
                    if rec is not None:
                        unlabel_buckets[rec["bucket"]].append(rec)

    def __iter__(self):
        """Batches from a background worker thread. Closing the generator (or
        dropping it) stops the worker after the batch it is making."""
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def worker():
            while not stop.is_set():
                try:
                    with span(self.tracer, "loader.batch"):
                        batch = self._produce_one()
                    if not put(batch):
                        return
                except BaseException as e:  # noqa: BLE001 — must not die silently
                    import sys

                    if sys.is_finalizing() or isinstance(e, (KeyboardInterrupt,
                                                             SystemExit)):
                        return  # interpreter shutdown — exit quietly
                    # a real data-pipeline failure: surface it to the consumer
                    # instead of leaving it blocked on q.get forever
                    import logging
                    import traceback

                    logging.getLogger("probabilisticteacher_torch").error(
                        "Data prefetch worker failed:\n" + traceback.format_exc())
                    put(e)
                    return

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, BaseException):
                    raise RuntimeError("Data prefetch worker failed") from item
                yield item
        finally:
            stop.set()


class EvalLoader:
    """Sequential eval loader over padded static batches.

    The reference evaluates at batch 1 (``pt/data/build.py:77-103``); with static
    canvases we can batch same-bucket images (``TEST.IMS_PER_BATCH``, an
    addition to the reference, default 1 for parity). The final partial batch is padded by
    repeating the last record; callers must dedupe by image_id — evaluate once
    per id (evaluation.py adds GT keyed by image_id, and duplicate detections
    for the same id are filtered here by truncation).
    """

    def __init__(self, cfg, dicts: List[dict]):
        self.dicts = dicts
        self.mapper = Mapper(cfg, is_train=False)
        self.rng = np.random.Generator(np.random.PCG64(0))
        self.batch = int(cfg.TEST.get("IMS_PER_BATCH", 1))

    def __len__(self):
        return len(self.dicts)

    def __iter__(self):
        buckets: Dict[int, list] = {0: [], 1: []}
        for d in self.dicts:
            rec = self.mapper(d, self.rng)
            b = buckets[rec["bucket"]]
            b.append(rec)
            if len(b) == self.batch:
                yield _stack(b)
                buckets[rec["bucket"]] = []
        for b in buckets.values():
            if b:
                # pad to the static batch size (keeps one compiled shape); the
                # padded repeats carry image_id None and are skipped in eval
                pad = [dict(b[-1], image_id=None) for _ in range(self.batch - len(b))]
                yield _stack(b + pad)

