"""Device-input pipelining: the next batch's host-to-device copy overlaps the step.

:class:`DevicePrefetcher` is a CUDA-stream double buffer. A background thread
pulls host batches and runs ``shard_fn`` on a side ``torch.cuda.Stream``: the
arrays are pinned and copied with ``non_blocking=True`` (:func:`host_to_device`),
and an event is recorded behind the copies. ``__next__`` makes the consumer's
current stream wait on that event (the step never reads a canvas before its copy
lands) and calls ``record_stream`` on every tensor of the batch (the caching
allocator does not hand a block back to the side stream while the step still
reads it). On the CPU the same thread runs ``shard_fn`` with no stream and no
event.

The phase decision (does this batch need the unlabeled images on the device?) is
exact: the worker counts iterations from ``start_iter`` in consumption order, so
the burn-in/mutual boundary holds per batch even with copies running ahead.
"""

from __future__ import annotations

import logging
import queue
import sys
import threading
import traceback
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

__all__ = ["DevicePrefetcher", "host_to_device"]

logger = logging.getLogger("probabilisticteacher_torch")


def host_to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A numpy array on ``device``: pinned and copied without blocking the host
    when ``device`` is the card (the copy is ordered on the current stream)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _tensors(obj) -> Iterator[torch.Tensor]:
    """Every tensor in a nest of dicts, lists and tuples (NamedTuples included)."""
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


class DevicePrefetcher:
    """Iterator of device-resident batches, copied one or more steps ahead.

    Args:
        host_iter: iterator of host (numpy) batches.
        shard_fn: ``(host_batch, iteration) -> device_batch``; runs on the
            background thread, on the side stream when ``device`` is the card.
        start_iter: iteration number of the FIRST batch that will be consumed
            (resume support: the phase decision inside shard_fn depends on it).
        depth: max copied-but-unconsumed batches (device memory for ``depth``
            extra batches is the cost of the overlap).
        device: the device ``shard_fn`` copies to; the CPU when None.
    """

    def __init__(self, host_iter: Iterator, shard_fn: Callable[[Any, int], Any],
                 start_iter: int = 0, depth: int = 2, device=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._host = host_iter
        self._shard = shard_fn
        self._device = torch.device("cpu" if device is None else device)
        self._stream: Optional[torch.cuda.Stream] = (
            torch.cuda.Stream(self._device) if self._device.type == "cuda" else None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._start_iter = start_iter
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="device-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        """Blocking put that still honors close(); True if delivered."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _copy(self, batch, it: int):
        """(device batch, event recorded behind its copies or None)."""
        if self._stream is None:
            return self._shard(batch, it), None
        with torch.cuda.stream(self._stream):
            dev = self._shard(batch, it)
            event = torch.cuda.Event()
            event.record(self._stream)
        return dev, event

    def _worker(self):
        it = self._start_iter
        try:
            while not self._stop.is_set():
                batch = next(self._host)
                if not self._put(self._copy(batch, it)):
                    return
                it += 1
        except BaseException as e:  # noqa: BLE001 — surface to the consumer
            if sys.is_finalizing() or isinstance(e, (KeyboardInterrupt, SystemExit)):
                return
            logger.error("Device prefetch worker failed:\n" + traceback.format_exc())
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        item = self._q.get()
        if isinstance(item, BaseException):
            raise RuntimeError("Device prefetch worker failed") from item
        dev, event = item
        if event is not None:
            current = torch.cuda.current_stream(self._device)
            current.wait_event(event)
            for t in _tensors(dev):
                if t.is_cuda:
                    t.record_stream(current)
        return dev

    def close(self):
        """Stop the worker, then the host iterator (when it can be closed);
        pending copies are dropped."""
        self._stop.set()
        # unblock a worker stuck in q.put by draining
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=10)
        if not self._thread.is_alive() and hasattr(self._host, "close"):
            self._host.close()
