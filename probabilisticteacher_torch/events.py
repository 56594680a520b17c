"""Metrics storage + writers (EventStorage-lite).

Replaces detectron2's EventStorage / PeriodicWriter trio (console, JSON,
TensorBoard — ``pt/engine/trainer.py:411-429,544-546``). Scalars are kept in a
bounded history; writers flush every WRITE_PERIOD iterations. TensorBoard output is
emitted only if tensorboardX/tf is importable (optional dependency).
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import defaultdict, deque
from typing import Dict

import torch

logger = logging.getLogger("probabilisticteacher_torch")


class EventStorage:
    def __init__(self, window: int = 20):
        self._history = defaultdict(lambda: deque(maxlen=window))
        self._latest: Dict[str, float] = {}
        self._latest_iter: Dict[str, int] = {}
        self.iter = 0

    def put_scalars(self, **scalars):
        for k, v in scalars.items():
            v = float(v)
            self._history[k].append(v)
            self._latest[k] = v
            self._latest_iter[k] = self.iter

    def latest(self) -> Dict[str, float]:
        return dict(self._latest)

    def iter_of(self, key: str) -> int:
        """Iteration at which ``key`` was last written (-1 if never) — lets
        consumers (health guards) distinguish a fresh value from a stale one."""
        return self._latest_iter.get(key, -1)

    def medians(self) -> Dict[str, float]:
        out = {}
        for k, h in self._history.items():
            s = sorted(h)
            out[k] = s[len(s) // 2]
        return out


class ConsoleWriter:
    def __init__(self, max_iter: int):
        self.max_iter = max_iter
        self._last_time = time.perf_counter()
        self._last_iter = 0

    def write(self, storage: EventStorage):
        now = time.perf_counter()
        it = storage.iter
        rate = (it - self._last_iter) / max(now - self._last_time, 1e-9)
        self._last_time, self._last_iter = now, it
        m = storage.medians()
        losses = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(m.items()) if k.startswith(("loss", "total")))
        extras = "  ".join(f"{k}: {v:.4g}" for k, v in sorted(m.items())
                           if not k.startswith(("loss", "total")))
        # detectron2's max_mem: the card's peak allocation so far
        mem = (f"  max_mem: {torch.cuda.max_memory_allocated() / 2**20:.0f}M"
               if torch.cuda.is_available() and torch.cuda.is_initialized() else "")
        logger.info(f"iter: {it}/{self.max_iter}  {losses}  {extras}  it/s: {rate:.2f}{mem}")


class JSONWriter:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage):
        rec = {"iteration": storage.iter, **storage.latest()}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class TensorboardWriter:
    def __init__(self, log_dir: str):
        self._w = None
        try:
            from torch.utils.tensorboard import SummaryWriter

            self._w = SummaryWriter(log_dir)
        except Exception:
            logger.debug("tensorboard unavailable; skipping TB writer")

    def write(self, storage: EventStorage):
        if self._w is None:
            return
        for k, v in storage.latest().items():
            self._w.add_scalar(k, v, storage.iter)
