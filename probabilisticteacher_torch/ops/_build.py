"""Build and bind the package's CUDA kernels (``probabilisticteacher_torch/csrc``).

Each ``.cu`` source exports a plain C function that launches its kernel on the
stream it is given and returns ``cudaGetLastError()``. ``nvcc`` compiles it for
Hopper (``sm_90a``) into a shared library under ``probabilisticteacher_torch/_build``
at first use, named by a hash of the source and flags, and ``ctypes`` loads it.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional, Sequence

_PKG = Path(__file__).resolve().parent.parent
SOURCE_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# no --use_fast_math: the NMS kernel must round every IoU as IEEE f32 does
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


class CudaKernel:
    """One C entry point of one ``.cu`` source: built, loaded and counted.

    ``launches`` counts the calls that launched the kernel; a wrapper calls
    :meth:`launch` exactly where it launches, and nowhere else.
    """

    def __init__(self, source: str, symbol: str, argtypes: Sequence,
                 extra_flags: Iterable[str] = ()):
        self.source = source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.flags = NVCC_FLAGS + tuple(extra_flags)
        self.launches = 0
        self.build_log: Optional[str] = None
        self._lib = None
        self._fn = None

    @property
    def source_path(self) -> Path:
        return SOURCE_DIR / self.source

    def library_path(self) -> Path:
        digest = hashlib.sha256(self.source_path.read_bytes())
        digest.update(" ".join(self.flags).encode())
        return BUILD_DIR / f"{self.source_path.stem}-{digest.hexdigest()[:16]}.so"

    def _load(self):
        if self._fn is None:
            build([self])
            lib = ctypes.CDLL(str(self.library_path()))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.pt_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        """Call the C entry point; raise if the launch was refused or failed."""
        code = self._load()(*args)
        if code != 0:
            msg = self._lib.pt_error_string(code).decode()
            raise RuntimeError(f"{self.symbol} ({self.source}) failed: CUDA error {code}: {msg}")
        self.launches += 1


def build(kernels: Sequence[CudaKernel]) -> None:
    """Compile every kernel whose library is missing, one ``nvcc`` per source, all
    started together. Raises with the compiler's output if one fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    seen = set()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in seen:
            continue
        seen.add(out)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *k.flags, "-o", str(tmp), str(k.source_path)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((k, out, tmp, proc))
    failed = []
    for k, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        k.build_log = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {k.source} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never loads half a file
    if failed:
        raise RuntimeError("\n".join(failed))
