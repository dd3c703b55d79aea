"""ctypes bridge to the native IO helpers of ``native/pm_native.cpp`` (the
counterpart of ``libpointmatcher_tpu.io.native``, with the same symbols and
signatures).

The library is built from the checkout's ``native/pm_native.cpp`` at first
use, one ``g++`` call, into ``.torch_ext_build/`` beside the package (the
directory the CUDA kernels are built into); its name carries a hash of the
source and the flags, so an edited source is never served a stale build, and
``native/`` is only read. Every entry point returns None when the library is
unavailable (no compiler, no source, or ``PMTPU_NO_NATIVE`` set before the
first use), and the callers take the Python path instead: the JAX package's
documented behaviour for a machine without a compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["available", "parse_floats", "parse_floats_n", "format_floats",
           "covariance_greedy", "CpuBaseline", "cpu_baseline"]

_ROOT = Path(__file__).resolve().parent.parent.parent
_SRC = _ROOT / "native" / "pm_native.cpp"
_BUILD_DIR = _ROOT / ".torch_ext_build"
_FLAGS = ["-O3", "-fPIC", "-shared"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _so_path() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()
                         + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libpm_io_{tag}.so"


def _build(so: Path) -> None:
    """Compile into a temporary file and rename it into place, so that
    processes building at once never load a half-written library."""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _declare(lib: ctypes.CDLL) -> None:
    c_long, dptr = ctypes.c_long, ctypes.POINTER(ctypes.c_double)
    lptr = ctypes.POINTER(ctypes.c_long)
    sigs = {
        "pm_parse_floats": (c_long, [ctypes.c_char_p, c_long,
                                     ctypes.POINTER(ctypes.c_float), c_long]),
        "pm_parse_doubles": (c_long, [ctypes.c_char_p, c_long, dptr, c_long]),
        "pm_parse_doubles_n": (c_long, [ctypes.c_char_p, c_long, dptr, c_long,
                                        lptr]),
        "pm_format_floats": (c_long, [ctypes.POINTER(ctypes.c_float), c_long,
                                      c_long, ctypes.c_char_p, c_long]),
        "pm_covariance_greedy": (c_long, [dptr, c_long, c_long, lptr]),
        "pm_kdtree_build": (ctypes.c_void_p, [dptr, c_long]),
        "pm_kdtree_free": (None, [ctypes.c_void_p]),
        "pm_kdtree_knn": (None, [ctypes.c_void_p, dptr, c_long, c_long, lptr]),
        "pm_cpu_normals": (None, [ctypes.c_void_p, dptr, c_long, c_long, dptr]),
        "pm_icp_cpu_register": (None, [ctypes.c_void_p, dptr, dptr, dptr,
                                       c_long, c_long, ctypes.c_double, dptr]),
        "pm_icp_cpu_register_conv": (c_long, [
            ctypes.c_void_p, dptr, dptr, dptr, c_long, c_long, ctypes.c_double,
            ctypes.c_double, ctypes.c_double, c_long, dptr]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("PMTPU_NO_NATIVE"):
            return None  # force the Python parsers (testing, debugging)
        try:
            so = _so_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            _declare(lib)
            _lib = lib
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    """True when the native library is built and loaded."""
    return _load() is not None


def _dptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def parse_floats(text: bytes) -> Optional[np.ndarray]:
    """Tokenize an ASCII numeric block → float64 array, or None when the
    native path is unavailable or the block holds a non-numeric token."""
    lib = _load()
    if lib is None:
        return None
    cap = max(len(text) // 2 + 16, 64)
    out = np.empty(cap, np.float64)
    n = lib.pm_parse_doubles(text, len(text), _dptr(out), cap)
    if n < 0:
        return None
    return out[:n]


def parse_floats_n(text: bytes, want: int):
    """Parse exactly ``want`` numbers from the head of ``text`` →
    ``(values float64 [n], consumed_bytes)``, or None when unavailable."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty(want, np.float64)
    consumed = ctypes.c_long(0)
    n = lib.pm_parse_doubles_n(text, len(text), _dptr(out), want,
                               ctypes.byref(consumed))
    return out[:n], int(consumed.value)


def covariance_greedy(mag: np.ndarray, nb: int) -> Optional[np.ndarray]:
    """CovarianceSampling's sequential greedy pick (compiled,
    ``pm_covariance_greedy``): ``mag`` is [n, 6]; the ``nb`` selected row
    indices in pick order, or None when the library is unavailable. The
    port's filter runs the numpy transcription
    (``filters/sampling.py::covariance_greedy``), held equal to this."""
    lib = _load()
    if lib is None:
        return None
    mag = np.ascontiguousarray(mag, np.float64)
    out = np.empty(nb, np.int64)
    got = lib.pm_covariance_greedy(
        _dptr(mag), mag.shape[0], nb,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_long)))
    return out[:got]


class CpuBaseline:
    """Compiled single-thread CPU ICP baseline (kd-tree 1-NN, trim,
    point-to-plane solve), the stand-in for the reference's compiled loop.
    Build it with :func:`cpu_baseline`, which returns None without the
    library."""

    def __init__(self, lib, ref_pts: np.ndarray):
        self._lib = lib
        self._ref = np.ascontiguousarray(ref_pts, np.float64)
        self._h = lib.pm_kdtree_build(_dptr(self._ref), len(self._ref))
        self._normals = None

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.pm_kdtree_free(self._h)

    def compute_normals(self, k: int = 10) -> np.ndarray:
        out = np.empty_like(self._ref)
        self._lib.pm_cpu_normals(self._h, _dptr(self._ref), len(self._ref), k,
                                 _dptr(out))
        self._normals = out
        return out

    def _args(self, src_pts, T_init):
        if self._normals is None:
            self.compute_normals()
        src = np.ascontiguousarray(src_pts, np.float64)
        T = np.ascontiguousarray(np.eye(4) if T_init is None else T_init,
                                 np.float64)
        return src, T

    def register(self, src_pts: np.ndarray, iterations: int,
                 trim: float = 0.85, T_init=None) -> np.ndarray:
        """A fixed budget of ``iterations`` → T [4, 4]."""
        src, T = self._args(src_pts, T_init)
        self._lib.pm_icp_cpu_register(
            self._h, _dptr(self._ref), _dptr(self._normals), _dptr(src),
            len(src), iterations, trim, _dptr(T))
        return T

    def register_conv(self, src_pts: np.ndarray, max_iterations: int = 40,
                      trim: float = 0.85, rot_thresh: float = 0.001,
                      trans_thresh: float = 0.001, smooth: int = 3,
                      T_init=None):
        """Stopped by the reference's Differential checker
        (TransformationCheckersImpl.cpp:85-158) at the engine's default
        thresholds → ``(T, iterations_run)``."""
        src, T = self._args(src_pts, T_init)
        it = self._lib.pm_icp_cpu_register_conv(
            self._h, _dptr(self._ref), _dptr(self._normals), _dptr(src),
            len(src), max_iterations, trim, rot_thresh, trans_thresh, smooth,
            _dptr(T))
        return T, int(it)


def cpu_baseline(ref_pts: np.ndarray) -> Optional[CpuBaseline]:
    """The compiled CPU baseline over a reference cloud, or None when the
    library is unavailable."""
    lib = _load()
    if lib is None:
        return None
    return CpuBaseline(lib, ref_pts)


def format_floats(values: np.ndarray) -> Optional[bytes]:
    """Format a float32 [rows, cols] table as ASCII rows, or None."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, np.float32)
    rows, cols = values.shape
    cap = rows * cols * 20 + rows * 2 + 64
    buf = ctypes.create_string_buffer(cap)
    w = lib.pm_format_floats(values.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             rows, cols, buf, cap)
    if w < 0:
        return None
    return buf.raw[:w]
