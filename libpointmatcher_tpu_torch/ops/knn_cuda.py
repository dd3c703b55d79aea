"""The dense k-NN kernels on the card, each beside its plain version.

========  ==============================  =======================================
kernel    replaces (TPU, Pallas)          plain version (CPU path, comparisons)
========  ==============================  =======================================
K1        knn_pallas.py::knn1_pallas      ``ops.knn.knn_brute_force`` (k = 1)
K9        knn_pallas.py::knn1_pallas_mxu  :func:`knn1_mxu_plain`
K5        knn_pallas.py::knnk_pallas      ``ops.knn.knn_brute_force`` (k ≤ 32)
========  ==============================  =======================================

The kernels are CUDA C++ in ``csrc/knn.cu`` (see its header for the design
and for what bounds them), built at first use by :mod:`.cuda_build`. Each
takes one query set and one reference, or a pair axis: ``[B, N, d]``
queries against ``[B, M, d]`` references, pair b against its own, in one
launch.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary
from .knn import knn_brute_force

__all__ = ["knn1", "knn1_mxu", "knnk", "knn1_mxu_plain", "build", "LIBRARY",
           "KNNK_MAX", "reset_launch_counts"]

#: largest k served by the K5 kernel (as ``knn_pallas.KNNK_MAX``)
KNNK_MAX = 32


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pm_knn1.argtypes = [p, p, i, p, p, i, i, i, i, i, i, p, p, p, p, p]
    lib.pm_knn1.restype = i
    lib.pm_knnk.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i, p, p, p, p, p]
    lib.pm_knnk.restype = i
    lib.pm_tile_rows.argtypes = []
    lib.pm_tile_rows.restype = i


LIBRARY = KernelLibrary("knn.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check_inputs(query, query_mask, ref, ref_mask):
    """Single search: query [N, d], ref [M, d]. Pairs: query [B, N, d] and
    ref [B, M, d], pair b searching its own reference. → B (0: single)."""
    pairs = query.ndim == 3
    for name, t in (("query", query), ("ref", ref)):
        if (t.dtype != torch.float32 or t.ndim != (3 if pairs else 2)
                or t.shape[-1] not in (2, 3)):
            raise ValueError(f"{name} must be float32 [rows, 2|3] or "
                             f"[pairs, rows, 2|3] for both, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if query.shape[-1] != ref.shape[-1]:
        raise ValueError("query and ref must have the same dimension")
    if pairs and query.shape[0] != ref.shape[0]:
        raise ValueError(f"{query.shape[0]} query sets for {ref.shape[0]} "
                         "references")
    for name, t, shape in (("query_mask", query_mask, query.shape[:-1]),
                           ("ref_mask", ref_mask, ref.shape[:-1])):
        if t.dtype != torch.bool or t.shape != shape:
            raise ValueError(f"{name} must be bool {tuple(shape)}")
    devs = {t.device for t in (query, query_mask, ref, ref_mask)}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if max(query.numel(), ref.numel()) >= 2**31:
        raise ValueError("row counts must fit in int32")
    return query.shape[0] if pairs else 0


def _split(lib, n: int, m: int, device, pairs: int = 1) -> tuple:
    """Reference chunks over gridDim.y: enough blocks for ~4 per SM."""
    tile = lib.pm_tile_rows()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    qblocks = max(1, -(-n // 256)) * max(pairs, 1)
    splits = max(1, min(-(-4 * sms // qblocks), -(-m // tile)))
    chunk = tile * -(-max(m, 1) // (tile * splits))
    splits = max(1, -(-m // chunk))
    return splits, chunk


def _launch_knn1(query, query_mask, ref, ref_mask, mxu: bool, pairs: int):
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    b = max(pairs, 1)
    n, dim = q.shape[-2:]
    m = r.shape[-2]
    splits, chunk = _split(lib, n, m, q.device, b)
    part_d = torch.empty((b, splits, n), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, splits, n), dtype=torch.int32, device=q.device)
    out_d = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    out_i = torch.empty(q.shape[:-1], dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pm_knn1(q.data_ptr(), qm.data_ptr(), n, r.data_ptr(),
                      rm.data_ptr(), m, b, dim, int(mxu), splits, chunk,
                      part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                      out_i.data_ptr(), stream)
    LIBRARY.check(err, "k-NN kernel")
    return out_d, out_i


def knn1(query, query_mask, ref, ref_mask):
    """K1: exact 1-NN → ``(d2 [N], id [N])``, (+inf, −1) invalid; with a
    pair axis (query [B, N, d], ref [B, M, d]) one launch gives
    ``[B, N]``, each pair against its own reference."""
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        d, i = knn_brute_force(query, query_mask, ref, ref_mask, k=1)
        return d[..., 0], i[..., 0]
    out = _launch_knn1(query, query_mask, ref, ref_mask, False, pairs)
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
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        if pairs:
            return tuple(torch.stack(x) for x in zip(*(
                knn1_mxu_plain(*a) for a in zip(query, query_mask, ref,
                                                ref_mask))))
        return knn1_mxu_plain(query, query_mask, ref, ref_mask)
    out = _launch_knn1(query, query_mask, ref, ref_mask, True, pairs)
    knn1_mxu.launches += 1
    return out


def knnk(query, query_mask, ref, ref_mask, k: int):
    """K5: exact top-k, 2 ≤ k ≤ 32 → ``(d2 [N, k], id [N, k])`` ascending,
    lowest index first on ties, (+inf, −1) for missing neighbours; with a
    pair axis as :func:`knn1`, ``[B, N, k]``."""
    if not 1 <= k <= KNNK_MAX:
        raise ValueError(f"k must be in 1..{KNNK_MAX}, got {k}")
    pairs = _check_inputs(query, query_mask, ref, ref_mask)
    if query.device.type == "cpu":
        return knn_brute_force(query, query_mask, ref, ref_mask, k=k)
    lib = build()
    q = query.contiguous()
    r = ref.contiguous()
    qm = query_mask.contiguous().view(torch.uint8)
    rm = ref_mask.contiguous().view(torch.uint8)
    b = max(pairs, 1)
    n, dim = q.shape[-2:]
    m = r.shape[-2]
    kk = max(2, 1 << (k - 1).bit_length())
    splits, chunk = _split(lib, n, m, q.device, b)
    part_d = torch.empty((b, splits, n, kk), dtype=torch.float32, device=q.device)
    part_i = torch.empty((b, splits, n, kk), dtype=torch.int32, device=q.device)
    out_d = torch.empty((*q.shape[:-1], k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((*q.shape[:-1], k), dtype=torch.int32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.pm_knnk(q.data_ptr(), qm.data_ptr(), n, r.data_ptr(),
                      rm.data_ptr(), m, b, dim, k, kk, splits, chunk,
                      part_d.data_ptr(), part_i.data_ptr(), out_d.data_ptr(),
                      out_i.data_ptr(), stream)
    LIBRARY.check(err, "k-NN kernel")
    knnk.launches += 1
    return out_d, out_i


def reset_launch_counts() -> None:
    for fn in (knn1, knn1_mxu, knnk):
        fn.launches = 0


reset_launch_counts()
