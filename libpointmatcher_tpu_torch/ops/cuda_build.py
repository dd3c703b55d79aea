"""Build the port's CUDA sources into shared libraries at first use.

Each source in ``csrc/`` has a plain C interface. ``nvcc`` compiles it for
``sm_90a`` into ``.torch_ext_build/`` beside the package, and ``ctypes``
loads it: no PyTorch header is compiled, so a build takes seconds. The
library's name carries a hash of the source and the flags, so an edited
source is never served a stale build. ``nvcc`` runs outside the GIL, so
libraries loaded from several threads build in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

__all__ = ["KernelLibrary"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / ".torch_ext_build"
_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the kernels are built from csrc/ at "
                       "first use and need the CUDA toolkit")


class KernelLibrary:
    """One CUDA source, its built library and its ctypes bindings.

    ``declare(lib)`` sets ``argtypes``/``restype`` of every exported
    function. ``build_log`` holds ptxas's report (registers, shared memory,
    spills) of the build this process made, empty if the library was
    already built."""

    def __init__(self, source: str, declare: Callable[[ctypes.CDLL], None]):
        self.source = _CSRC / source
        self._declare = declare
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None
        self.build_log = ""

    def path(self) -> Path:
        tag = hashlib.sha256(self.source.read_bytes()
                             + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
        return _BUILD_DIR / f"libpm_{self.source.stem}_{tag}.so"

    def load(self) -> ctypes.CDLL:
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is None:
                out = self.path()
                if not out.exists():
                    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                    tmp = out.with_suffix(f".{os.getpid()}.tmp")
                    proc = subprocess.run(
                        [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                        capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError(f"nvcc failed on {self.source}:\n"
                                           f"{proc.stderr}")
                    self.build_log = proc.stderr
                    os.replace(tmp, out)
                lib = ctypes.CDLL(str(out))
                lib.pm_error_string.argtypes = [ctypes.c_int]
                lib.pm_error_string.restype = ctypes.c_char_p
                self._declare(lib)
                self._lib = lib
            return self._lib

    def check(self, err: int, what: str) -> None:
        """Raise if a launch returned a CUDA error code."""
        if err != 0:
            raise RuntimeError(f"{what} launch failed: "
                               f"{self.load().pm_error_string(err).decode()}")
