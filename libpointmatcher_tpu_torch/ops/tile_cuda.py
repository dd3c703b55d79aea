"""The tile-sweep kernels on the card, each beside its plain version.

========  ==============================================  =========================
kernel    replaces (TPU, Pallas)                          plain version
========  ==============================================  =========================
K7        tilesweep.py::_tile_sweep_pallas (1-NN)         :func:`tile_sweep_plain`
K8        tilesweep.py::_tile_sweep_pallas_k (top-k)      :func:`tile_sweep_k_plain`
T4        tile_kernel_micro.py::main.min_only             :func:`tile_min_plain`
T5        tile_kernel_micro.py::main.one                  :func:`tile_min_plain`
========  ==============================================  =========================

T4 and T5 are the ablations of ``tools_torch/tile_kernel_micro.py``: K7's
function without the id (per query, the minimum d² over its tile's
candidates) on K7's own table, eight tiles per block in 2048-column stages
(T4) or one tile per block over its whole list at once (T5).

The kernels are CUDA C++ in ``csrc/tile.cu`` (see its header for the design
and for what bounds them), built at first use by :mod:`.cuda_build`. Both
take ``q [T, TQ, 8]`` (a tile's queries, coordinates in the first ``dim``
columns) and ``cand_t [T, 8, M]`` (its candidate table: coordinates in rows
0..dim-1, the pad penalty in row 6, the candidate's original row id as a
float in row 7; M a multiple of 128), and return the candidate's row id,
−1 where the distance is not finite. Among equal distances the lowest
candidate position wins, the XLA fallback's ``argmin`` / ``top_k`` rule.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import KernelLibrary

__all__ = ["tile_sweep", "tile_sweep_k", "tile_sweep_plain",
           "tile_sweep_k_plain", "tile_min_only", "tile_min_one",
           "tile_min_plain", "build", "LIBRARY", "TILE_KNN_MAX", "DPAD",
           "PEN_ROW", "CID_ROW", "MIN_ONE_MAX", "reset_launch_counts"]

#: largest k of the top-k tile sweep K8 (as ``tilesweep.TILE_KNN_MAX``)
TILE_KNN_MAX = 32
DPAD = 8         # query columns / candidate-table rows
PEN_ROW = 6      # candidate-table row of the pad penalty
CID_ROW = 7      # candidate-table row of the original row id
#: register list lengths instantiated in csrc/tile.cu
_KK = (4, 8, 16, 32)
#: T4's candidate columns per stage
MIN_STAGE = 2048
#: T5's largest candidate list (its shared memory holds the whole list)
MIN_ONE_MAX = 232448 // 16


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pm_tile_nn1.argtypes = [p, p, i, i, i, i, p, p, p]
    lib.pm_tile_nn1.restype = i
    lib.pm_tile_nnk.argtypes = [p, p, i, i, i, i, i, i, p, p, p]
    lib.pm_tile_nnk.restype = i
    lib.pm_tile_min.argtypes = [p, p, i, i, i, i, i, p, p]
    lib.pm_tile_min.restype = i
    lib.pm_tile_min_stage.restype = i
    lib.pm_tile_min_one_max.restype = i
    if (lib.pm_tile_min_stage(), lib.pm_tile_min_one_max()) != (MIN_STAGE,
                                                                 MIN_ONE_MAX):
        raise RuntimeError("csrc/tile.cu stages differ from ops/tile_cuda.py")


LIBRARY = KernelLibrary("tile.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check(q, cand_t, dim: int) -> None:
    if q.dtype != torch.float32 or q.ndim != 3 or q.shape[2] != DPAD:
        raise ValueError(f"q must be float32 [T, TQ, {DPAD}], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if (cand_t.dtype != torch.float32 or cand_t.ndim != 3
            or cand_t.shape[:2] != (q.shape[0], DPAD) or cand_t.shape[2] % 128):
        raise ValueError(f"cand_t must be float32 [{q.shape[0]}, {DPAD}, M] "
                         f"with M a multiple of 128, got {cand_t.dtype} "
                         f"{tuple(cand_t.shape)}")
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if q.device != cand_t.device:
        raise ValueError(f"inputs on several devices: {q.device}, {cand_t.device}")
    if max(q.numel(), cand_t.numel()) >= 2**31:
        raise ValueError("tables must hold fewer than 2^31 entries")


def _tile_d2(q, ct, dim: int) -> torch.Tensor:
    """[t, TQ, M] distances of a slice of tiles, each step a rounded torch
    operation in the kernel's order: ((pen + dx²) + dy²) + dz²."""
    d2 = ct[:, PEN_ROW, None, :]
    for c in range(dim):
        diff = q[:, :, c, None] - ct[:, None, c, :]
        d2 = d2 + diff * diff
    return d2


def _tiles_per_step(tq: int, m: int) -> int:
    """Tiles per step of a plain version: ~2^24 distances at a time."""
    return max(1, (1 << 24) // max(tq * m, 1))


def tile_sweep_plain(q, cand_t, dim: int):
    """Plain version of K7 → ``(d2 [T, TQ], id [T, TQ] int32)``."""
    T, tq, _ = q.shape
    d_out = torch.empty((T, tq), dtype=torch.float32, device=q.device)
    i_out = torch.empty((T, tq), dtype=torch.int32, device=q.device)
    step = _tiles_per_step(tq, cand_t.shape[2])
    for t0 in range(0, T, step):
        ct = cand_t[t0:t0 + step]
        d2 = _tile_d2(q[t0:t0 + step], ct, dim)
        pos = torch.argmin(d2, dim=2, keepdim=True)       # first of equal minima
        td = torch.gather(d2, 2, pos)[..., 0]
        cid = torch.gather(ct[:, CID_ROW, None, :].expand_as(d2), 2, pos)[..., 0]
        d_out[t0:t0 + step] = td
        i_out[t0:t0 + step] = torch.where(torch.isfinite(td), cid,
                                          torch.full_like(cid, -1.0)).to(torch.int32)
    return d_out, i_out


def tile_sweep_k_plain(q, cand_t, dim: int, k: int):
    """Plain version of K8 → ``(d2 [T, k, TQ], id [T, k, TQ] int32)``,
    ascending along k: a stable sort keeps the lowest position first among
    equal distances."""
    T, tq, _ = q.shape
    d_out = torch.empty((T, k, tq), dtype=torch.float32, device=q.device)
    i_out = torch.empty((T, k, tq), dtype=torch.int32, device=q.device)
    step = _tiles_per_step(tq, cand_t.shape[2])
    for t0 in range(0, T, step):
        ct = cand_t[t0:t0 + step]
        d2 = _tile_d2(q[t0:t0 + step], ct, dim)
        srt, pos = torch.sort(d2, dim=2, stable=True)
        td = srt[..., :k]
        cid = torch.gather(ct[:, CID_ROW, None, :].expand_as(d2), 2, pos[..., :k])
        cid = torch.where(torch.isfinite(td), cid, torch.full_like(cid, -1.0))
        d_out[t0:t0 + step] = td.transpose(1, 2)
        i_out[t0:t0 + step] = cid.transpose(1, 2).to(torch.int32)
    return d_out, i_out


def tile_sweep(q, cand_t, dim: int):
    """K7: per-tile 1-NN → ``(d2 [T, TQ], id [T, TQ])``."""
    _check(q, cand_t, dim)
    if q.device.type == "cpu":
        return tile_sweep_plain(q, cand_t, dim)
    lib = build()
    q, cand_t = q.contiguous(), cand_t.contiguous()
    T, tq, _ = q.shape
    out_d = torch.empty((T, tq), dtype=torch.float32, device=q.device)
    out_i = torch.empty((T, tq), dtype=torch.int32, device=q.device)
    err = lib.pm_tile_nn1(q.data_ptr(), cand_t.data_ptr(), T, tq,
                          cand_t.shape[2], dim, out_d.data_ptr(),
                          out_i.data_ptr(),
                          torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err, "tile 1-NN kernel")
    tile_sweep.launches += 1
    return out_d, out_i


def tile_sweep_k(q, cand_t, dim: int, k: int):
    """K8: per-tile top-k, 1 ≤ k ≤ ``TILE_KNN_MAX`` → ``(d2 [T, k, TQ],
    id [T, k, TQ])`` ascending along k, (+inf, −1) past the candidates."""
    if not 1 <= k <= TILE_KNN_MAX:
        raise ValueError(f"k must be in 1..{TILE_KNN_MAX}, got {k}")
    _check(q, cand_t, dim)
    if q.device.type == "cpu":
        return tile_sweep_k_plain(q, cand_t, dim, k)
    lib = build()
    q, cand_t = q.contiguous(), cand_t.contiguous()
    T, tq, _ = q.shape
    kk = next(x for x in _KK if x >= k)
    out_d = torch.empty((T, k, tq), dtype=torch.float32, device=q.device)
    out_i = torch.empty((T, k, tq), dtype=torch.int32, device=q.device)
    err = lib.pm_tile_nnk(q.data_ptr(), cand_t.data_ptr(), T, tq,
                          cand_t.shape[2], dim, k, kk, out_d.data_ptr(),
                          out_i.data_ptr(),
                          torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err, "tile top-k kernel")
    tile_sweep_k.launches += 1
    return out_d, out_i


def tile_min_plain(q, cand_t, dim: int):
    """Plain version of T4 and T5 → ``d2 [T, TQ]``, each query's minimum d²
    over its tile's candidates, formed as in :func:`tile_sweep_plain`."""
    T, tq, _ = q.shape
    out = torch.empty((T, tq), dtype=torch.float32, device=q.device)
    step = _tiles_per_step(tq, cand_t.shape[2])
    for t0 in range(0, T, step):
        d2 = _tile_d2(q[t0:t0 + step], cand_t[t0:t0 + step], dim)
        out[t0:t0 + step] = d2.amin(dim=2)
    return out


def _launch_min(fn, q, cand_t, dim: int, tiles_per_block: int):
    _check(q, cand_t, dim)
    if q.device.type == "cpu":
        return tile_min_plain(q, cand_t, dim)
    lib = build()
    q, cand_t = q.contiguous(), cand_t.contiguous()
    T, tq, _ = q.shape
    out = torch.empty((T, tq), dtype=torch.float32, device=q.device)
    err = lib.pm_tile_min(q.data_ptr(), cand_t.data_ptr(), T, tq,
                          cand_t.shape[2], dim, tiles_per_block, out.data_ptr(),
                          torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err, f"tile min-only kernel ({tiles_per_block} tiles a block)")
    fn.launches += 1
    return out


def tile_min_only(q, cand_t, dim: int):
    """T4: each query's minimum d² over its tile's candidates, eight tiles
    a block, 2048 candidate columns a stage → ``d2 [T, TQ]``."""
    return _launch_min(tile_min_only, q, cand_t, dim, 8)


def tile_min_one(q, cand_t, dim: int):
    """T5: T4's function, one tile a block, its whole candidate list staged
    at once (M ≤ ``MIN_ONE_MAX``) → ``d2 [T, TQ]``."""
    if cand_t.shape[-1] > MIN_ONE_MAX:
        raise ValueError(f"T5 takes at most {MIN_ONE_MAX} candidates a tile, "
                         f"got {cand_t.shape[-1]}")
    return _launch_min(tile_min_one, q, cand_t, dim, 1)


def reset_launch_counts() -> None:
    for fn in (tile_sweep, tile_sweep_k, tile_min_only, tile_min_one):
        fn.launches = 0


reset_launch_counts()
