"""The survivor-sweep kernels on the card, each beside its plain version.

========  ===========================================  ==========================
kernel    replaces (TPU, Pallas)                       plain version
========  ===========================================  ==========================
K2        knn_sweep2.py::survivors_and_bounds          :func:`survivors_and_bounds_plain`
K3        knn_sweep2.py::nn1_survivor_sweep            :func:`survivor_sweep_plain`
K4        knn_sweep2.py::nn1_survivor_sweep_stream     :func:`survivor_sweep_plain`
K6        knn_sweep2.py::nnk_survivor_sweep            :func:`nnk_survivor_sweep_plain`
========  ===========================================  ==========================

The kernels are CUDA C++ in ``csrc/sweep.cu`` (see its header for the
design and for what bounds them), built at first use by :mod:`.cuda_build`.
The tables are those of :mod:`.sweep`: ``qp [n_pad, 8]``, ``ct [8,
nch_pad]``, ``rt3 [nch, 8, 128]``, ``surv [tiles, nch_pad]`` int32: K2
writes one row per 256 queries, K3 and K4 take those rows or their OR
per 1024 queries (:func:`flag_tile`), K6's kernel only K2's own rows (its
plain version either). K6 returns ``[n_pad, k]`` for k = 2..4.

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
wrapper counts its kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import KernelLibrary
from .knn import _tile_d2

__all__ = ["survivors_and_bounds", "nn1_survivor_sweep",
           "nn1_survivor_sweep_stream", "nnk_survivor_sweep",
           "survivors_and_bounds_plain", "survivor_sweep_plain",
           "nnk_survivor_sweep_plain", "build", "LIBRARY",
           "BOUND_TILE", "SWEEP_TILE", "SWEEPK_TILE", "SWEEPK_MAX", "flag_tile",
           "reset_launch_counts"]

#: queries per K2 tile (one flag row each)
BOUND_TILE = 256
#: queries per flag row of the TPU's fold (four bound tiles), which K3 and
#: K4 also take
SWEEP_TILE = 1024
#: queries per flag row that K6 takes: K2's own rows
SWEEPK_TILE = BOUND_TILE
#: segments each K3/K4/K6 survivor list is cut into (partials merged in order)
SWEEP_SEGMENTS = 8
#: most chunks a sweep's survivor list may hold (its shared memory)
MAX_CHUNKS = 8192
#: largest k of the top-k sweep K6
SWEEPK_MAX = 4

_UP = float(np.float32(1.0 + 4e-7))
_DOWN = float(np.float32(1.0 - 4e-7))
_FAR = 1.0e15


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.pm_survivors_bounds.argtypes = [p, i, p, i, i, i, p, p, p]
    lib.pm_survivors_bounds.restype = i
    lib.pm_survivor_sweep.argtypes = [p, i, p, i, p, i, i, p, p, p, p, p]
    lib.pm_survivor_sweep.restype = i
    lib.pm_survivor_sweep_k.argtypes = [p, i, p, i, p, i, i, i, p, p, p, p, p]
    lib.pm_survivor_sweep_k.restype = i
    for fn in ("pm_bound_tile", "pm_fold_tile", "pm_sweep_segments"):
        getattr(lib, fn).restype = i
    if ((lib.pm_bound_tile(), lib.pm_fold_tile(), lib.pm_sweep_segments())
            != (BOUND_TILE, SWEEP_TILE, SWEEP_SEGMENTS)):
        raise RuntimeError("csrc/sweep.cu tiles or segments differ from "
                           "ops/sweep_cuda.py")


LIBRARY = KernelLibrary("sweep.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check(name, t, dtype, shape):
    if t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)}, got "
                         f"{t.dtype} {tuple(t.shape)}")


def _check_tables(qp, rt3=None, ct=None, surv=None, tile=BOUND_TILE):
    if qp.ndim != 2 or qp.shape[1] != 8 or qp.shape[0] % tile:
        raise ValueError(f"qp must be [n_pad, 8] with n_pad a multiple of "
                         f"{tile}, got {tuple(qp.shape)}")
    _check("qp", qp, torch.float32, qp.shape)
    if ct is not None:
        if ct.ndim != 2 or ct.shape[0] != 8 or ct.shape[1] % 128:
            raise ValueError(f"ct must be [8, nch_pad], got {tuple(ct.shape)}")
        _check("ct", ct, torch.float32, ct.shape)
    if rt3 is not None:
        if rt3.ndim != 3 or rt3.shape[1:] != (8, 128):
            raise ValueError(f"rt3 must be [nch, 8, 128], got {tuple(rt3.shape)}")
        _check("rt3", rt3, torch.float32, rt3.shape)
        if rt3.shape[0] > MAX_CHUNKS:
            raise ValueError(f"rt3 holds {rt3.shape[0]} chunks, the sweep "
                             f"takes at most {MAX_CHUNKS}")
    if surv is not None:
        nch_pad = surv.shape[1] if surv.ndim == 2 else -1
        _check("surv", surv, torch.int32, (qp.shape[0] // tile, nch_pad))
        if rt3 is not None and nch_pad < rt3.shape[0]:
            raise ValueError("surv has fewer columns than rt3 has chunks")
    tensors = [t for t in (qp, rt3, ct, surv) if t is not None]
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if qp.shape[0] >= 2**31 or (rt3 is not None and rt3.shape[0] * 128 >= 2**31):
        raise ValueError("row counts must fit in int32")


# ------------------------------------------------------------------ K2
def _chunk_count(ct, nch):
    nch = ct.shape[1] if nch is None else int(nch)
    if not 0 <= nch <= ct.shape[1]:
        raise ValueError(f"nch must lie in [0, {ct.shape[1]}], got {nch}")
    return nch


def survivors_and_bounds_plain(qp, ct, k: int = 1, nch=None,
                               block_rows: int = 8192):
    """Plain version of K2, in the kernel's order of rounded operations.

    U = min(qp[:, 4], min over chunks of (‖q − ctr‖ + ‖half‖)·UP), where
    ctr = 0.5·(lo + hi) and half = 0.5·(hi − lo); for k > 1 a chunk with
    fewer than k valid rows adds 1e15 to its term. A chunk survives for a
    256-query tile if any query has gap²·DOWN + qp[:, 3] ≤ U²·UP. Only the
    first ``nch`` chunks (default: all columns of ``ct``) are visited; the
    flags of the padding columns after them are 0."""
    n_pad, nch_pad = qp.shape[0], ct.shape[1]
    nch = _chunk_count(ct, nch)
    surv = torch.zeros((n_pad // BOUND_TILE, nch_pad), dtype=torch.int32,
                       device=qp.device)
    if nch == 0:
        return qp[:, 4].clone(), surv
    ct = ct[:, :nch]
    lo, hi = ct[0:3], ct[3:6]
    ctr = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    rad = torch.sqrt(half[0] * half[0] + half[1] * half[1] + half[2] * half[2])
    add = None
    if k > 1:
        add = torch.where(ct[6] < float(k), _FAR, 0.0)
    ub = torch.empty(n_pad, dtype=torch.float32, device=qp.device)
    for r0 in range(0, n_pad, block_rows):
        q = qp[r0:r0 + block_rows]
        dx, dy, dz = (q[:, c, None] - ctr[c][None, :] for c in range(3))
        dc2 = dx * dx + dy * dy + dz * dz
        cand = (torch.sqrt(dc2) + rad[None, :]) * _UP
        if add is not None:
            cand = cand + add[None, :]
        u = torch.minimum(q[:, 4], cand.amin(dim=1))
        ub[r0:r0 + block_rows] = u
        ub2 = (u * u) * _UP
        g = [torch.clamp(torch.maximum(lo[c][None, :] - q[:, c, None],
                                       q[:, c, None] - hi[c][None, :]), min=0.0)
             for c in range(3)]
        gap2 = g[0] * g[0] + g[1] * g[1] + g[2] * g[2]
        ok = (gap2 * _DOWN + q[:, 3, None]) <= ub2[:, None]
        surv[r0 // BOUND_TILE:(r0 + q.shape[0]) // BOUND_TILE, :nch] = (
            ok.reshape(-1, BOUND_TILE, ok.shape[1]).any(dim=1).to(torch.int32))
    return ub, surv


def survivors_and_bounds(qp, ct, k: int = 1, nch=None):
    """K2: per-query bounds and per-(256-query tile, chunk) survival flags
    → ``(ub [n_pad] f32, surv [n_pad/256, nch_pad] int32)``. ``nch``, the
    map's chunk count, cuts the padding columns of ``ct`` (boxes at
    ``FAR``, which can neither bind a bound nor survive) out of the work;
    their flags are 0."""
    _check_tables(qp, ct=ct)
    nch = _chunk_count(ct, nch)
    if qp.device.type == "cpu":
        return survivors_and_bounds_plain(qp, ct, k, nch)
    lib = build()
    qp = qp.contiguous()
    ct = ct.contiguous()
    n_pad, nch_pad = qp.shape[0], ct.shape[1]
    ub = torch.empty(n_pad, dtype=torch.float32, device=qp.device)
    surv = torch.empty((n_pad // BOUND_TILE, nch_pad), dtype=torch.int32,
                       device=qp.device)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    err = lib.pm_survivors_bounds(qp.data_ptr(), n_pad, ct.data_ptr(), nch,
                                  nch_pad, int(k), ub.data_ptr(),
                                  surv.data_ptr(), stream)
    LIBRARY.check(err, "K2 survivors_and_bounds")
    survivors_and_bounds.launches += 1
    return ub, surv


# ------------------------------------------------------------------ K3 / K4
def flag_tile(qp, surv) -> int:
    """Queries per row of ``surv``: ``BOUND_TILE`` (K2's own flags) or
    ``SWEEP_TILE`` (their OR over four bound tiles, the TPU's fold), read
    from its row count; any other shape raises."""
    n_pad = qp.shape[0]
    rows = surv.shape[0] if surv.ndim == 2 else -1
    for tile in (BOUND_TILE, SWEEP_TILE):
        if n_pad % tile == 0 and rows == n_pad // tile:
            return tile
    raise ValueError(f"surv must have n_pad/{BOUND_TILE} or n_pad/{SWEEP_TILE} "
                     f"rows (n_pad {n_pad}), got {tuple(surv.shape)}")


def survivor_sweep_plain(qp, rt3, surv):
    """Plain version of K3 and K4: per tile of ``flag_tile(qp, surv)``
    queries, the exact 1-NN over the rows of its surviving chunks (those of
    index < nch), swept in increasing index with d² = ((pen + dx²) + dy²) +
    dz², the lowest index winning a tie; (+inf, 0) where the minimum stays
    +inf."""
    tile = flag_tile(qp, surv)
    n_pad = qp.shape[0]
    nch = rt3.shape[0]
    out_d = torch.full((n_pad,), float("inf"), dtype=torch.float32,
                       device=qp.device)
    out_i = torch.zeros(n_pad, dtype=torch.int32, device=qp.device)
    rows = rt3[:, :4, :].transpose(1, 2)                    # [nch, 128, 4]
    lane = torch.arange(128, device=qp.device)
    for t in range(n_pad // tile):
        lst = torch.nonzero(surv[t, :nch]).flatten()
        if lst.numel() == 0:
            continue
        r = rows[lst].reshape(-1, 4)
        sl = slice(t * tile, (t + 1) * tile)
        d2 = _tile_d2(qp[sl, :3], r[:, :3], r[:, 3])
        best = torch.argmin(d2, dim=1)
        bd = torch.gather(d2, 1, best[:, None])[:, 0]
        ids = (lst[:, None] * 128 + lane[None, :]).reshape(-1)[best]
        out_d[sl] = bd
        out_i[sl] = torch.where(torch.isfinite(bd), ids,
                                torch.zeros_like(ids)).to(torch.int32)
    return out_d, out_i


def _launch_sweep(qp, rt3, surv, name):
    lib = build()
    qp = qp.contiguous()
    rt3 = rt3.contiguous()
    surv = surv.contiguous()
    if rt3.data_ptr() % 16:
        raise ValueError("rt3 must be 16-byte aligned")
    n_pad = qp.shape[0]
    part_d = torch.empty((SWEEP_SEGMENTS, n_pad), dtype=torch.float32,
                         device=qp.device)
    part_i = torch.empty((SWEEP_SEGMENTS, n_pad), dtype=torch.int32,
                         device=qp.device)
    out_d = torch.empty(n_pad, dtype=torch.float32, device=qp.device)
    out_i = torch.empty(n_pad, dtype=torch.int32, device=qp.device)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    err = lib.pm_survivor_sweep(qp.data_ptr(), n_pad, rt3.data_ptr(),
                                rt3.shape[0], surv.data_ptr(), surv.shape[0],
                                surv.shape[1], part_d.data_ptr(),
                                part_i.data_ptr(), out_d.data_ptr(),
                                out_i.data_ptr(), stream)
    LIBRARY.check(err, name)
    return out_d, out_i


def nn1_survivor_sweep(qp, rt3, surv):
    """K3: exact 1-NN of each query over its tile's surviving chunks →
    ``(d2 [n_pad], id [n_pad])``, ids into the sorted map. ``surv`` holds
    K2's flags, one row per 256 queries, or their OR per 1024
    (:func:`flag_tile`); ``rt3``'s penalty row holds 0 or +inf."""
    _check_tables(qp, rt3=rt3, surv=surv, tile=flag_tile(qp, surv))
    if qp.device.type == "cpu":
        return survivor_sweep_plain(qp, rt3, surv)
    out = _launch_sweep(qp, rt3, surv, "K3 survivor sweep")
    nn1_survivor_sweep.launches += 1
    return out


def nn1_survivor_sweep_stream(qp, rt3, surv):
    """K4: the sweep of a streaming map (above ``sweep.SKIP_MAX_MPAD``
    rows). On the card both maps read through L2, so it launches K3's
    schedule (``csrc/sweep.cu``), counted apart; the same result."""
    _check_tables(qp, rt3=rt3, surv=surv, tile=flag_tile(qp, surv))
    if qp.device.type == "cpu":
        return survivor_sweep_plain(qp, rt3, surv)
    out = _launch_sweep(qp, rt3, surv, "K4 survivor sweep (stream)")
    nn1_survivor_sweep_stream.launches += 1
    return out


# ------------------------------------------------------------------ K6
def _check_k(k):
    if not 2 <= int(k) <= SWEEPK_MAX:
        raise ValueError(f"the top-k sweep takes k in 2..{SWEEPK_MAX}, got {k}")
    return int(k)


def nnk_survivor_sweep_plain(qp, rt3, surv, k: int):
    """Plain version of K6: per tile of ``flag_tile(qp, surv)`` queries, the
    exact top-k over the rows of its surviving chunks (those of index <
    nch), ascending, with d² formed as in :func:`survivor_sweep_plain`; a
    stable sort keeps the lower sorted-map index first among equal
    distances. Slots that hold no finite distance, and every slot of a tile
    with no survivor, give (+inf, −1)."""
    k = _check_k(k)
    tile = flag_tile(qp, surv)
    n_pad = qp.shape[0]
    nch = rt3.shape[0]
    out_d = torch.full((n_pad, k), float("inf"), dtype=torch.float32,
                       device=qp.device)
    out_i = torch.full((n_pad, k), -1, dtype=torch.int32, device=qp.device)
    rows = rt3[:, :4, :].transpose(1, 2)                    # [nch, 128, 4]
    lane = torch.arange(128, device=qp.device)
    for t in range(n_pad // tile):
        lst = torch.nonzero(surv[t, :nch]).flatten()
        if lst.numel() == 0:
            continue
        r = rows[lst].reshape(-1, 4)
        sl = slice(t * tile, (t + 1) * tile)
        d2 = _tile_d2(qp[sl, :3], r[:, :3], r[:, 3])
        sd, pos = torch.sort(d2, dim=1, stable=True)
        sd, pos = sd[:, :k], pos[:, :k]
        ids = (lst[:, None] * 128 + lane[None, :]).reshape(-1)[pos]
        out_d[sl] = sd
        out_i[sl] = torch.where(torch.isfinite(sd), ids,
                                torch.full_like(ids, -1)).to(torch.int32)
    return out_d, out_i


def nnk_survivor_sweep(qp, rt3, surv, k: int):
    """K6: exact top-k (k = 2..4) of each query over its tile's surviving
    chunks → ``(d2 [n_pad, k], id [n_pad, k])`` ascending, ids into the
    sorted map, (+inf, −1) in empty slots. ``surv`` holds K2's flags, one
    row per 256 queries (``SWEEPK_TILE``, the only rows the kernel takes),
    or on the CPU also their OR per 1024 (:func:`flag_tile`); any other
    row count raises. Two launches: the sweep over ``SWEEP_SEGMENTS``
    segments of each list, then their merge; ``launches`` counts calls."""
    k = _check_k(k)
    tile = flag_tile(qp, surv)
    _check_tables(qp, rt3=rt3, surv=surv, tile=tile)
    if qp.device.type == "cpu":
        return nnk_survivor_sweep_plain(qp, rt3, surv, k)
    if tile != SWEEPK_TILE:
        raise ValueError(f"surv must have n_pad/{SWEEPK_TILE} rows on the "
                         f"card, got {tuple(surv.shape)}")
    lib = build()
    qp = qp.contiguous()
    rt3 = rt3.contiguous()
    surv = surv.contiguous()
    if rt3.data_ptr() % 16:
        raise ValueError("rt3 must be 16-byte aligned")
    n_pad = qp.shape[0]
    part_d = torch.empty((SWEEP_SEGMENTS, n_pad, k), dtype=torch.float32,
                         device=qp.device)
    part_i = torch.empty((SWEEP_SEGMENTS, n_pad, k), dtype=torch.int32,
                         device=qp.device)
    out_d = torch.empty((n_pad, k), dtype=torch.float32, device=qp.device)
    out_i = torch.empty((n_pad, k), dtype=torch.int32, device=qp.device)
    stream = torch.cuda.current_stream(qp.device).cuda_stream
    err = lib.pm_survivor_sweep_k(qp.data_ptr(), n_pad, rt3.data_ptr(),
                                  rt3.shape[0], surv.data_ptr(), surv.shape[0],
                                  surv.shape[1], k, part_d.data_ptr(),
                                  part_i.data_ptr(), out_d.data_ptr(),
                                  out_i.data_ptr(), stream)
    LIBRARY.check(err, "K6 top-k survivor sweep")
    nnk_survivor_sweep.launches += 1
    return out_d, out_i


def reset_launch_counts() -> None:
    for fn in (survivors_and_bounds, nn1_survivor_sweep,
               nn1_survivor_sweep_stream, nnk_survivor_sweep):
        fn.launches = 0


reset_launch_counts()
