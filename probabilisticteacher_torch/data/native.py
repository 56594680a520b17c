"""ctypes bindings for the native C++ loader (``probabilisticteacher_torch/csrc/ptloader.cpp``).

At first use the source is built with ``g++ -O3 -shared -fPIC -std=c++17 ...
-ljpeg -lpng`` into ``probabilisticteacher_torch/_build/``, named by a hash of the
source and flags. When the toolchain or the libraries are missing, the loader
decodes with PIL instead (``data/loader.py``); both are host decoders, and which
one runs is logged once. ctypes releases the GIL during the call, so a Python
thread pool decodes in parallel, as the reference's worker processes do
(``DATALOADER.NUM_WORKERS``).
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger("probabilisticteacher_torch")

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "ptloader.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIBS = ("-ljpeg", "-lpng")


class _Library:
    """The built library, loaded once per process; ``lib`` is None when the build
    or the load failed (the PIL decoder runs then)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tried = False
        self.lib: Optional[ctypes.CDLL] = None

    def path(self) -> Path:
        digest = hashlib.sha256(SOURCE.read_bytes())
        digest.update(" ".join(GXX_FLAGS + LIBS).encode())
        return BUILD_DIR / f"ptloader-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile the source unless its library exists; raise with g++'s output."""
        out = self.path()
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE), *LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE.name}: {proc.stderr.strip()}")
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
        return out

    def get(self) -> Optional[ctypes.CDLL]:
        with self._lock:
            if self._tried:
                return self.lib
            self._tried = True
            try:
                path = self.build()
                lib = ctypes.CDLL(str(path))
            except (OSError, RuntimeError) as e:   # no g++, libjpeg or libpng
                logger.warning("native loader unavailable (%s); decoding with PIL", e)
                return None
            lib.ptl_load_image.restype = ctypes.c_int
            lib.ptl_load_image.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_float),
            ]
            self.lib = lib
            logger.info("native loader: decoding with %s", path)
            return lib


_LIBRARY = _Library()


def available() -> bool:
    return _LIBRARY.get() is not None


def load_image(path: str, short_edge: int, max_size: int, flip: bool,
               canvas_hw: Tuple[int, int]) -> Optional[Tuple[np.ndarray, np.ndarray, float]]:
    """Decode+resize+flip+pad in native code.

    Returns (canvas uint8 (ch, cw, 3) BGR, valid_hw (2,) float32, scale), or None
    if the native library is unavailable / decode failed (caller falls back).
    """
    lib = _LIBRARY.get()
    if lib is None:
        return None
    ch, cw = canvas_hw
    canvas = np.zeros((ch, cw, 3), np.uint8)
    out_hw = (ctypes.c_int * 2)()
    out_scale = ctypes.c_float()
    rc = lib.ptl_load_image(
        path.encode(), short_edge, max_size, int(flip), ch, cw,
        canvas.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), out_hw,
        ctypes.byref(out_scale),
    )
    if rc != 0:
        return None
    hw = np.asarray([out_hw[0], out_hw[1]], np.float32)
    return canvas, hw, float(out_scale.value)
