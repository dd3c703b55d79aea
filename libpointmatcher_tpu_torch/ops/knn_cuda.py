"""The dense k-NN kernels on the card, each beside its plain version.

========  ==============================  =======================================
kernel    replaces (TPU, Pallas)          plain version (CPU path, comparisons)
========  ==============================  =======================================
K1        knn_pallas.py::knn1_pallas      ``ops.knn.knn_brute_force`` (k = 1)
K9        knn_pallas.py::knn1_pallas_mxu  :func:`knn1_mxu_plain`
K5        knn_pallas.py::knnk_pallas      ``ops.knn.knn_brute_force`` (k ≤ 32)
========  ==============================  =======================================

The kernels are CUDA C++ in ``csrc/knn.cu`` (see its header for the design
and for what bounds them). They are compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, into
``.torch_ext_build/`` beside the package, and loaded with ``ctypes``: no
PyTorch header is compiled, so a build takes seconds. The library's name
carries a hash of the source, so an edited source is never served a stale
build.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import torch

from .knn import knn_brute_force

__all__ = ["knn1", "knn1_mxu", "knnk", "knn1_mxu_plain", "build", "KNNK_MAX",
           "reset_launch_counts"]

#: largest k served by the K5 kernel (as ``knn_pallas.KNNK_MAX``)
KNNK_MAX = 32

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "knn.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent.parent / ".torch_ext_build"
_NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: ptxas's report (registers, shared memory, spills) of the last build
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the k-NN kernels are built from "
                       "csrc/knn.cu at first use and need the CUDA toolkit")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
        out = _BUILD_DIR / f"libpm_knn_{tag}.so"
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {_SRC}:\n{proc.stderr}")
            build_log = proc.stderr
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.pm_knn1.argtypes = [p, p, i, p, p, i, i, i, i, i, p, p, p, p, p]
        lib.pm_knn1.restype = i
        lib.pm_knnk.argtypes = [p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
        lib.pm_knnk.restype = i
        lib.pm_tile_rows.argtypes = []
        lib.pm_tile_rows.restype = i
        lib.pm_error_string.argtypes = [i]
        lib.pm_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def _check_inputs(query, query_mask, ref, ref_mask):
    for name, t in (("query", query), ("ref", ref)):
        if t.dtype != torch.float32 or t.ndim != 2 or t.shape[1] not in (2, 3):
            raise ValueError(f"{name} must be float32 [rows, 2|3], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if query.shape[1] != ref.shape[1]:
        raise ValueError("query and ref must have the same dimension")
    for name, t, rows in (("query_mask", query_mask, query.shape[0]),
                          ("ref_mask", ref_mask, ref.shape[0])):
        if t.dtype != torch.bool or t.shape != (rows,):
            raise ValueError(f"{name} must be bool [{rows}]")
    devs = {t.device for t in (query, query_mask, ref, ref_mask)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if max(query.shape[0], ref.shape[0]) >= 2**31:
        raise ValueError("row counts must fit in int32")


def _split(lib, n: int, m: int, device) -> tuple:
    """Reference chunks over gridDim.y: enough blocks for ~4 per SM."""
    tile = lib.pm_tile_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qblocks = max(1, -(-n // 256))
    splits = max(1, min(-(-4 * sms // qblocks), -(-m // tile)))
    chunk = tile * -(-max(m, 1) // (tile * splits))
    splits = max(1, -(-m // chunk))
    return splits, chunk


def _launch_knn1(query, query_mask, ref, ref_mask, mxu: bool):
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    n, dim = q.shape
    m = r.shape[0]
    splits, chunk = _split(lib, n, m, q.device)
    part_d = torch.empty((splits, n), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, n), dtype=torch.int32, device=q.device)
    out_d = torch.empty(n, dtype=torch.float32, device=q.device)
    out_i = torch.empty(n, dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pm_knn1(q.data_ptr(), qm.data_ptr(), n, r.data_ptr(),
                      rm.data_ptr(), m, dim, int(mxu), splits, chunk,
                      part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                      out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"k-NN kernel launch failed: "
                           f"{lib.pm_error_string(err).decode()}")
    return out_d, out_i


def knn1(query, query_mask, ref, ref_mask):
    """K1: exact 1-NN → ``(d2 [N], id [N])``, (+inf, −1) invalid."""
    _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        d, i = knn_brute_force(query, query_mask, ref, ref_mask, k=1)
        return d[:, 0], i[:, 0]
    out = _launch_knn1(query, query_mask, ref, ref_mask, mxu=False)
    knn1.launches += 1
    return out


def knn1_mxu_plain(query, query_mask, ref, ref_mask, tile_m: int = 4096):
    """Plain version of K9: d² = (q² + (r² + pen)) − 2·(q·r), each step a
    rounded torch op (the kernel fuses the products into FMAs, so the two
    agree within the tolerance that rounding allows, not bit for bit);
    argmin with the lowest index on ties, then clamped at 0."""
    n, dim = query.shape
    m = ref.shape[0]
    inf = float("inf")
    sq = lambda x: ((x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1])
                    + (x[:, 2] * x[:, 2] if dim == 3 else 0.0))
    q2 = sq(query)
    r2pen = torch.where(ref_mask, sq(ref), torch.full_like(ref[:, 0], inf))
    best_d = torch.full((n,), inf, dtype=torch.float32, device=query.device)
    best_i = torch.full((n,), -1, dtype=torch.int64, device=query.device)
    for t0 in range(0, m, tile_m):
        r = ref[t0:t0 + tile_m]
        dot = None
        for c in range(dim):
            term = query[:, c, None] * r[None, :, c]
            dot = term if dot is None else dot + term
        d2 = (q2[:, None] + r2pen[None, t0:t0 + tile_m]) - 2.0 * dot
        ti = torch.argmin(d2, dim=1)
        td = torch.gather(d2, 1, ti[:, None])[:, 0]
        take = td < best_d
        best_d = torch.where(take, td, best_d)
        best_i = torch.where(take, ti + t0, best_i)
    best_d = torch.clamp(best_d, min=0.0)
    ok = torch.isfinite(best_d) & query_mask
    best_d = torch.where(query_mask, best_d, torch.full_like(best_d, inf))
    best_i = torch.where(ok, best_i, torch.full_like(best_i, -1))
    return best_d, best_i.to(torch.int32)


def knn1_mxu(query, query_mask, ref, ref_mask):
    """K9: 1-NN in the expansion form, (1+ε)-exact for ε at or above
    ``dispatch.MXU_EPSILON_FLOOR`` → ``(d2 [N], id [N])``."""
    _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return knn1_mxu_plain(query, query_mask, ref, ref_mask)
    out = _launch_knn1(query, query_mask, ref, ref_mask, mxu=True)
    knn1_mxu.launches += 1
    return out


def knnk(query, query_mask, ref, ref_mask, k: int):
    """K5: exact top-k, 2 ≤ k ≤ 32 → ``(d2 [N, k], id [N, k])`` ascending,
    lowest index first on ties, (+inf, −1) for missing neighbours."""
    if not 1 <= k <= KNNK_MAX:
        raise ValueError(f"k must be in 1..{KNNK_MAX}, got {k}")
    _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return knn_brute_force(query, query_mask, ref, ref_mask, k=k)
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    n, dim = q.shape
    m = r.shape[0]
    kk = max(2, 1 << (k - 1).bit_length())
    splits, chunk = _split(lib, n, m, q.device)
    part_d = torch.empty((splits, n, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((splits, n, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((n, k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((n, k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pm_knnk(q.data_ptr(), qm.data_ptr(), n, r.data_ptr(),
                      rm.data_ptr(), m, dim, k, kk, splits, chunk,
                      part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                      out_i.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"k-NN kernel launch failed: "
                           f"{lib.pm_error_string(err).decode()}")
    knnk.launches += 1
    return out_d, out_i


def reset_launch_counts() -> None:
    for fn in (knn1, knn1_mxu, knnk):
        fn.launches = 0


reset_launch_counts()
