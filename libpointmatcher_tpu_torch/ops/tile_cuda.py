"""The tile-sweep kernels on the card, each beside its plain version.

========  ==============================================  ===================================
kernel    replaces (TPU, Pallas)                          plain version
========  ==============================================  ===================================
K7        tilesweep.py::_tile_sweep_pallas (1-NN)         :func:`tile_sweep_parents_plain`
K8        tilesweep.py::_tile_sweep_pallas_k (top-k)      :func:`tile_sweep_k_parents_plain`
T4        tile_kernel_micro.py::main.min_only             :func:`tile_min_plain`
T5        tile_kernel_micro.py::main.one                  :func:`tile_min_plain`
========  ==============================================  ===================================

The kernels are CUDA C++ in ``csrc/tile.cu`` (see its header for the design
and for what bounds them), built at first use by :mod:`.cuda_build`.

K7 and K8 serve the matcher's step in the **parent form**
(:func:`tile_sweep_parents`, :func:`tile_sweep_k_parents`): one block per
parent tile sweeps the candidate tables of all its virtual tiles
(``cand_t [..., Tv, 8, M]``: coordinates in rows 0..dim-1, the pad penalty
in row 6, the candidate's original row id as a float in row 7; M a
multiple of 128) in ``vrows`` order, each over its live prefix of
``ncols`` columns, merges them, applies ``maxDist`` and the query mask and
writes each result at its query's row. Their plain version is the
composition the JAX package runs: the queries gathered per virtual tile,
the per-tile sweep, ``maxDist`` on each virtual tile, the merge in
``vrows`` order (:func:`_combine_min` for K7, :func:`_merge_sorted_k` for
K8), the scatter to the reading's rows and the mask. In the **per-tile
form** (:func:`tile_sweep`, :func:`tile_sweep_k`: ``q [T, TQ, 8]`` against
``cand_t [T, 8, M]``) each tile is its own parent, with no radius and no
mask; its plain versions are :func:`tile_sweep_plain` and
:func:`tile_sweep_k_plain`. Both forms return the candidate's row id, −1
where the distance is not finite; within a table the lowest candidate
position wins among equal distances, the XLA fallback's ``argmin`` /
``top_k`` rule.

T4 and T5 are the ablations of ``tools_torch/tile_kernel_micro.py``: K7's
per-tile function without the id (per query, the minimum d² over its
tile's candidates) on K7's own table, of any M, four queries a thread:
T4 with the tables staged in double-buffered ``cp.async`` stages
(:func:`t4_team` sets its tiles a block), T5 one tile a block over its
whole list in one step, its columns cut into slices swept by teams of the
block's threads (:func:`t5_shape`).

A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises. There is no fallback between the two. Each
kernel's launches count in ``<wrapper>.launches``, of both forms on
``tile_sweep.launches`` (K7) and ``tile_sweep_k.launches`` (K8).
"""

from __future__ import annotations

import ctypes
import math

import torch

from .cuda_build import KernelLibrary
from .dispatch import apply_max_dist, radius2

__all__ = ["tile_sweep", "tile_sweep_k", "tile_sweep_plain",
           "tile_sweep_k_plain", "tile_sweep_parents", "tile_sweep_k_parents",
           "tile_sweep_parents_plain", "tile_sweep_k_parents_plain",
           "tile_min_only", "tile_min_one", "tile_min_plain", "build",
           "LIBRARY", "TILE_KNN_MAX", "DPAD", "PEN_ROW", "CID_ROW", "TEAMS",
           "MIN_ONE_MAX", "T4_THREADS", "T4_QUERIES", "T4_COLS", "t4_team",
           "T5_THREADS", "t5_shape", "reset_launch_counts"]

#: largest k of the top-k tile sweep K8 (as ``tilesweep.TILE_KNN_MAX``)
TILE_KNN_MAX = 32
DPAD = 8         # query columns / candidate-table rows
PEN_ROW = 6      # candidate-table row of the pad penalty
CID_ROW = 7      # candidate-table row of the original row id
#: K7's warps a block that share a parent's virtual tiles, at TQ <= 64 (one
#: warp for the parent's queries; csrc/tile.cu allows 1..4)
TEAMS = 4
#: T4's threads a block, queries a thread and table columns a block stages
#: over its tiles (csrc/tile.cu kT4Threads, kT4Q, kT4Cols)
T4_THREADS, T4_QUERIES, T4_COLS = 256, 4, 1024
#: T5's threads a block (csrc/tile.cu kT5Threads), ``team × slices``
T5_THREADS = 256
#: T5's largest candidate list: its shared memory (232 448 bytes) holds the
#: whole list, three arrays of whole groups of 8 columns, beside the scratch
#: of its cross-slice reduction (four floats a thread)
MIN_ONE_MAX = (232448 // 4 - 4 * T5_THREADS) // 3 // 8 * 8


def _declare(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    sweep = [p, i, p, p, p, p, p, i, i, i, i, i, i, i, f]
    lib.pm_tile_nn1.argtypes = [*sweep, i, p, p, p]
    lib.pm_tile_nn1.restype = i
    lib.pm_tile_nnk.argtypes = [*sweep, i, i, p, p, p]
    lib.pm_tile_nnk.restype = i
    lib.pm_tile_min.argtypes = [p, p, i, i, i, i, i, i, p, p]
    lib.pm_tile_min.restype = i
    for name in ("pm_tile_max_teams", "pm_tile_min_cols", "pm_tile_min_one_max",
                 "pm_tile_t5_threads"):
        getattr(lib, name).restype = i
    if ((lib.pm_tile_min_cols(), lib.pm_tile_min_one_max(),
         lib.pm_tile_t5_threads()) != (T4_COLS, MIN_ONE_MAX, T5_THREADS)):
        raise RuntimeError("csrc/tile.cu stages differ from ops/tile_cuda.py")
    if not 1 <= TEAMS <= lib.pm_tile_max_teams():
        raise RuntimeError(f"TEAMS {TEAMS} outside csrc/tile.cu's 1.."
                           f"{lib.pm_tile_max_teams()}")


LIBRARY = KernelLibrary("tile.cu", _declare)


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    return LIBRARY.load()


def _check(q, cand_t, dim: int, multiple: int = 128) -> None:
    """Per-tile inputs: ``q [T, TQ, 8]``, ``cand_t [T, 8, M]``, M a
    multiple of ``multiple`` (K7, K8: 128; T4, T5 take any M)."""
    if q.dtype != torch.float32 or q.ndim != 3 or q.shape[2] != DPAD:
        raise ValueError(f"q must be float32 [T, TQ, {DPAD}], got {q.dtype} "
                         f"{tuple(q.shape)}")
    if (cand_t.dtype != torch.float32 or cand_t.ndim != 3
            or cand_t.shape[:2] != (q.shape[0], DPAD) or cand_t.shape[2] % multiple):
        raise ValueError(f"cand_t must be float32 [{q.shape[0]}, {DPAD}, M] "
                         f"with M a multiple of {multiple}, got {cand_t.dtype} "
                         f"{tuple(cand_t.shape)}")
    if dim not in (2, 3):
        raise ValueError(f"dim must be 2 or 3, got {dim}")
    if q.device != cand_t.device:
        raise ValueError(f"inputs on several devices: {q.device}, {cand_t.device}")
    if max(q.numel(), cand_t.numel()) >= 2**31:
        raise ValueError("tables must hold fewer than 2^31 entries")


def _parent_shape(points, qmask, q_rows, cand_t, ncols, vrows):
    """Check the parent form's inputs → ``(Bf, Tp, TQ, Tv, K, M)``: Bf
    scans of Tp parent tiles of TQ queries, Tv virtual tiles a scan, merge
    depth K, M table columns."""
    if points.dtype != torch.float32 or points.ndim < 2 or points.shape[-1] not in (2, 3):
        raise ValueError(f"points must be float32 [..., N, 2 or 3], got "
                         f"{points.dtype} {tuple(points.shape)}")
    n = points.shape[-2]
    if vrows.ndim < 2:
        raise ValueError(f"vrows must be [..., K, Tp], got {tuple(vrows.shape)}")
    kd, tp = vrows.shape[-2:]
    if q_rows is None:
        bf = math.prod(points.shape[:-2])
        if tp == 0 or n % tp:
            raise ValueError(f"{n} rows in tile order are not {tp} tiles")
        tq = n // tp
    else:
        if points.ndim != 2:
            raise ValueError("q_rows serves a single scan")
        bf, tq = 1, q_rows.shape[-1]
        if tuple(q_rows.shape) != (tp, tq):
            raise ValueError(f"q_rows must be [{tp}, TQ], got {tuple(q_rows.shape)}")
    if qmask.dtype != torch.bool or qmask.shape != points.shape[:-1]:
        raise ValueError(f"qmask must be bool {tuple(points.shape[:-1])}, got "
                         f"{qmask.dtype} {tuple(qmask.shape)}")
    if vrows.numel() != bf * kd * tp:
        raise ValueError(f"vrows {tuple(vrows.shape)} does not hold {bf} scans")
    if (cand_t.dtype != torch.float32 or cand_t.ndim < 3
            or cand_t.shape[-2] != DPAD or cand_t.shape[-1] % 128):
        raise ValueError(f"cand_t must be float32 [..., Tv, {DPAD}, M] with M a "
                         f"multiple of 128, got {cand_t.dtype} {tuple(cand_t.shape)}")
    tv, m = cand_t.shape[-3], cand_t.shape[-1]
    if cand_t.numel() != bf * tv * DPAD * m:
        raise ValueError(f"cand_t {tuple(cand_t.shape)} does not hold {bf} scans")
    if ncols is not None and ncols.numel() != bf * tv:
        raise ValueError(f"ncols must hold {bf * tv} virtual tiles, got "
                         f"{tuple(ncols.shape)}")
    devs = {x.device for x in (points, qmask, q_rows, cand_t, ncols, vrows)
            if x is not None}
    if len(devs) > 1:
        raise ValueError(f"inputs on several devices: {devs}")
    if max(points.numel(), cand_t.numel()) >= 2**31:
        raise ValueError("tables must hold fewer than 2^31 entries")
    return bf, tp, tq, tv, kd, m


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




# ------------------------------------------------ the parent form's plain version
def _queries(points, q_rows, tiles):
    """The step's queries as ``[Bf, Tp, TQ, 8]`` → (queries, TQ). Without
    ``q_rows`` the reading is already in tile order (``tiles`` parent
    tiles per scan); with it (one scan), queries are gathered by row."""
    n, d = points.shape[-2:]
    if q_rows is None:
        q = points.reshape(-1, tiles, n // tiles, d)
    else:
        if points.ndim != 2:
            raise ValueError("q_rows serves a single scan")
        q = points[q_rows.clamp(min=0).long()][None]
    q8 = torch.zeros((*q.shape[:-1], DPAD), dtype=torch.float32,
                     device=points.device)
    q8[..., :d] = q
    return q8, q.shape[2]


def _parents_of(vrows, bf: int, tv: int):
    """The parent tile of each virtual tile ``[Bf, Tv]``, read from
    ``vrows``. A virtual tile that no parent merges (padding) gets parent
    0, and the all-pad sentinel that several parents name gets one of
    them: neither holds a candidate, so its queries do not matter."""
    kd, tp = vrows.shape[-2:]
    vr = vrows.reshape(bf, kd * tp).long()
    tiles = torch.arange(tp, device=vrows.device).repeat(kd).expand(bf, -1)
    return torch.zeros((bf, tv), dtype=torch.long,
                       device=vrows.device).scatter_(1, vr, tiles)


def _by_parent(q, parent):
    """Queries per virtual tile: ``[Bf, Tp, TQ, 8]`` → ``[Bf, Tv, TQ, 8]``."""
    bf = q.shape[0]
    par = parent.reshape(bf, -1).long()
    return q[torch.arange(bf, device=q.device)[:, None], par]


def _merge_rows(bd, bi, vrows, combine):
    """Merge each parent's virtual tiles: ``bd``/``bi`` [Bf, Tv, ...] →
    [Bf, Tp, ...], row j of ``vrows`` read at step j."""
    bf = bd.shape[0]
    vr = vrows.reshape(bf, -1, vrows.shape[-1]).long()
    at = torch.arange(bf, device=bd.device)[:, None]
    md, mi = bd[at, vr[:, 0]], bi[at, vr[:, 0]]
    for j in range(1, vr.shape[1]):
        md, mi = combine(md, mi, bd[at, vr[:, j]], bi[at, vr[:, j]])
    return md, mi


def _scatter_rows(vals, q_rows, n: int, fill):
    """Results of the tiled queries back onto the reading's ``n`` rows
    (query rows are unique; padding slots write to a dropped row n)."""
    flat = q_rows.reshape(-1).long()
    idx = torch.where(flat >= 0, flat, torch.full_like(flat, n))
    out = torch.full((n + 1, *vals.shape[1:]), fill, dtype=vals.dtype,
                     device=vals.device)
    out[idx] = vals
    return out[:n]


def _combine_min(md, mi, dj, ij):
    """Running (min distance, min row id on exact ties) combine."""
    big = torch.iinfo(torch.int32).max
    better = dj < md
    key_m = torch.where(mi >= 0, mi, big)
    key_j = torch.where(ij >= 0, ij, big)
    tie_key = torch.minimum(key_m, key_j)
    tied = torch.where(tie_key == big, -1, tie_key)
    mi = torch.where(better, ij, torch.where(dj == md, tied, mi))
    return torch.minimum(md, dj), mi


def _merge_sorted_k(ad, ai, bd_, bi_):
    """Merge two per-query sorted k-lists [..., k, TQ] → the k smallest.
    Candidates are disjoint across virtual tiles, so nothing repeats."""
    k = ad.shape[-2]
    outs_d = [ad[..., s, :] for s in range(k)]
    outs_i = [ai[..., s, :] for s in range(k)]
    for t in range(k):
        cd, ci = bd_[..., t, :], bi_[..., t, :]
        for s in range(k):
            take = cd < outs_d[s]
            nd = torch.where(take, cd, outs_d[s])
            ni = torch.where(take, ci, outs_i[s])
            cd = torch.where(take, outs_d[s], cd)
            ci = torch.where(take, outs_i[s], ci)
            outs_d[s], outs_i[s] = nd, ni
    return torch.stack(outs_d, dim=-2), torch.stack(outs_i, dim=-2)


def _plain_parents(points, qmask, q_rows, cand_t, ncols, vrows, max_dist, k):
    """The composition both parent-form plain versions share (``k`` 0:
    K7's) → per-query rows of ``(d2, id)``, ``[..., N]`` or ``[..., N, k]``."""
    bf, tp, tq, tv, _, _ = _parent_shape(points, qmask, q_rows, cand_t, ncols,
                                         vrows)
    lead, (n, d) = points.shape[:-2], points.shape[-2:]
    q, _ = _queries(points, q_rows, tp)
    q = _by_parent(q, _parents_of(vrows, bf, tv)).reshape(bf * tv, tq, DPAD)
    ct = cand_t.reshape(bf * tv, DPAD, -1)
    if k == 0:
        bd, bi = apply_max_dist(*tile_sweep_plain(q, ct, d), max_dist)
        md, mi = _merge_rows(bd.reshape(bf, tv, tq), bi.reshape(bf, tv, tq),
                             vrows, _combine_min)
        md, mi, tail = md.reshape(-1), mi.reshape(-1), ()
    else:
        bd, bi = apply_max_dist(*tile_sweep_k_plain(q, ct, d, k), max_dist)
        md, mi = _merge_rows(bd.reshape(bf, tv, k, tq),
                             bi.reshape(bf, tv, k, tq), vrows, _merge_sorted_k)
        md = md.transpose(-1, -2).reshape(-1, k)           # [Bf·Tp·TQ, k]
        mi = mi.transpose(-1, -2).reshape(-1, k)
        tail = (k,)
    if q_rows is None:
        out_d, out_i = md.reshape(*lead, n, *tail), mi.reshape(*lead, n, *tail)
    else:
        out_d = _scatter_rows(md, q_rows, n, float("inf"))
        out_i = _scatter_rows(mi, q_rows, n, -1)
    keep = qmask if k == 0 else qmask[..., None]
    return torch.where(keep, out_d, float("inf")), torch.where(keep, out_i, -1)


def tile_sweep_parents_plain(points, qmask, q_rows, cand_t, ncols, vrows,
                             max_dist: float):
    """Plain version of the parent-form K7 (:func:`tile_sweep_parents`):
    the queries gathered per virtual tile, :func:`tile_sweep_plain`,
    ``maxDist`` on each virtual tile, :func:`_combine_min` over each
    parent's virtual tiles in ``vrows`` order, the scatter to the rows and
    the mask. ``ncols`` is not read: the columns past a table's live prefix
    are padding, which no distance takes."""
    return _plain_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                          max_dist, 0)


def tile_sweep_k_parents_plain(points, qmask, q_rows, cand_t, ncols, vrows,
                               max_dist: float, k: int):
    """Plain version of the parent-form K8 (:func:`tile_sweep_k_parents`),
    as :func:`tile_sweep_parents_plain` with :func:`tile_sweep_k_plain`
    and :func:`_merge_sorted_k`."""
    return _plain_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                          max_dist, k)


# ------------------------------------------------------------ the kernels
def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned(cand_t) -> None:
    if cand_t.data_ptr() % 16:
        raise ValueError("cand_t must start on a 16-byte boundary (the kernels "
                         "read it as float4)")


def _ptr(x):
    return None if x is None else x.data_ptr()


def _teams(tq: int, depth: int) -> int:
    """K7's warps a block for a parent's virtual tiles: ``TEAMS`` (at most
    the merge depth) where one warp holds the parent's queries, else 1."""
    return max(1, min(TEAMS, depth)) if tq <= 64 else 1


def _launch_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                    max_dist: float, k: int):
    """One K7 (``k`` 0) or K8 launch in the parent form → ``(d2, id)``."""
    bf, tp, tq, tv, kd, m = _parent_shape(points, qmask, q_rows, cand_t,
                                          ncols, vrows)
    lib = build()
    d = points.shape[-1]
    pts, qm, ct = points.contiguous(), qmask.contiguous(), cand_t.contiguous()
    _aligned(ct)
    vr = vrows.to(torch.int32).contiguous()
    nc = None if ncols is None else ncols.to(torch.int32).contiguous()
    qr = None if q_rows is None else q_rows.to(torch.int64).contiguous()
    shape = (*points.shape[:-1], *((k,) if k else ()))
    if q_rows is None:                 # the kernel writes every row
        out_d = torch.empty(shape, dtype=torch.float32, device=points.device)
        out_i = torch.empty(shape, dtype=torch.int32, device=points.device)
    else:                              # rows absent from the tiling
        out_d = torch.full(shape, float("inf"), device=points.device)
        out_i = torch.full(shape, -1, dtype=torch.int32, device=points.device)
    r2 = float("inf") if max_dist == float("inf") else radius2(max_dist)
    args = (pts.data_ptr(), d, qm.data_ptr(), _ptr(qr), ct.data_ptr(), _ptr(nc),
            vr.data_ptr(), bf * tp, tp, tq, tv, kd, m, d, r2)
    if k == 0:
        err = lib.pm_tile_nn1(*args, _teams(tq, kd), out_d.data_ptr(),
                              out_i.data_ptr(), _stream(points))
        LIBRARY.check(err, "tile 1-NN kernel")
        tile_sweep.launches += 1
    else:
        err = lib.pm_tile_nnk(*args, k, 0, out_d.data_ptr(), out_i.data_ptr(),
                              _stream(points))
        LIBRARY.check(err, "tile top-k kernel")
        tile_sweep_k.launches += 1
    return out_d, out_i


def tile_sweep_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                       max_dist: float):
    """K7 in the parent form: exact bounded-radius 1-NN of the reading's
    queries over their parent tiles' virtual tiles → ``(d2 [..., N],
    id [..., N])``, (+inf, −1) beyond ``max_dist``, for masked rows and for
    rows absent from the tiling.

    ``points [..., N, d]`` and ``qmask [..., N]``: without ``q_rows`` the
    reading is in tile order (row t·TQ + r is parent tile t's query r, the
    leading dimensions scans); with ``q_rows [Tp, TQ]`` (one scan) the
    query rows of each tile. ``cand_t [..., Tv, 8, M]`` the virtual tiles'
    tables, ``ncols [..., Tv]`` their live prefixes (multiples of 64; None:
    all M), ``vrows [..., K, Tp]`` each parent's virtual tiles in merge
    order. One launch; the merge is :func:`_combine_min`'s."""
    if points.device.type == "cpu":
        return tile_sweep_parents_plain(points, qmask, q_rows, cand_t, ncols,
                                        vrows, max_dist)
    return _launch_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                           max_dist, 0)


def tile_sweep_k_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                         max_dist: float, k: int):
    """K8 in the parent form, 1 ≤ k ≤ ``TILE_KNN_MAX``: the k-NN form of
    :func:`tile_sweep_parents` → ``(d2 [..., N, k], id [..., N, k])``
    ascending per row. One launch; the merge is :func:`_merge_sorted_k`'s."""
    if not 1 <= k <= TILE_KNN_MAX:
        raise ValueError(f"k must be in 1..{TILE_KNN_MAX}, got {k}")
    if points.device.type == "cpu":
        return tile_sweep_k_parents_plain(points, qmask, q_rows, cand_t,
                                          ncols, vrows, max_dist, k)
    return _launch_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                           max_dist, k)


def _launch_tiles(q, cand_t, dim: int, k: int):
    """One K7 (``k`` 0) or K8 launch in the per-tile form: each tile its
    own parent, every column and query live, no radius."""
    lib = build()
    q, cand_t = q.contiguous(), cand_t.contiguous()
    _aligned(cand_t)
    T, tq, _ = q.shape
    shape = (T, k, tq) if k else (T, tq)
    out_d = torch.empty(shape, dtype=torch.float32, device=q.device)
    out_i = torch.empty(shape, dtype=torch.int32, device=q.device)
    args = (q.data_ptr(), DPAD, None, None, cand_t.data_ptr(), None, None, T,
            T, tq, T, 1, cand_t.shape[2], dim, float("inf"))
    if k == 0:
        err = lib.pm_tile_nn1(*args, 1, out_d.data_ptr(), out_i.data_ptr(),
                              _stream(q))
        LIBRARY.check(err, "tile 1-NN kernel")
        tile_sweep.launches += 1
    else:
        err = lib.pm_tile_nnk(*args, k, 1, out_d.data_ptr(), out_i.data_ptr(),
                              _stream(q))
        LIBRARY.check(err, "tile top-k kernel")
        tile_sweep_k.launches += 1
    return out_d, out_i


def tile_sweep(q, cand_t, dim: int):
    """K7 in the per-tile form: 1-NN → ``(d2 [T, TQ], id [T, TQ])``."""
    _check(q, cand_t, dim)
    if q.device.type == "cpu":
        return tile_sweep_plain(q, cand_t, dim)
    return _launch_tiles(q, cand_t, dim, 0)


def tile_sweep_k(q, cand_t, dim: int, k: int):
    """K8 in the per-tile form: top-k, 1 ≤ k ≤ ``TILE_KNN_MAX`` → ``(d2
    [T, k, TQ], id [T, k, TQ])`` ascending along k, (+inf, −1) past the
    candidates."""
    if not 1 <= k <= TILE_KNN_MAX:
        raise ValueError(f"k must be in 1..{TILE_KNN_MAX}, got {k}")
    _check(q, cand_t, dim)
    if q.device.type == "cpu":
        return tile_sweep_k_plain(q, cand_t, dim, k)
    return _launch_tiles(q, cand_t, dim, k)


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


def t4_team(tq: int) -> int:
    """T4's threads a tile: the fewest of 8, 16, .., ``T4_THREADS`` whose
    ``T4_QUERIES`` queries each cover ``tq``; a block holds
    ``T4_THREADS // team`` tiles, and a tile of more queries is cut into
    slices of ``T4_QUERIES * T4_THREADS`` on the grid."""
    team = 8
    while team * T4_QUERIES < tq and team < T4_THREADS:
        team *= 2
    return team


def t5_shape(tq: int, m: int) -> tuple:
    """T5's block → ``(team, slices, span)``: ``team`` threads hold the
    tile's queries four each (T4's rule, :func:`t4_team`, up to
    ``T5_THREADS``), ``slices = T5_THREADS // team`` teams split its ``m``
    columns into runs of ``span`` (whole groups of 8; the last runs may be
    short or empty); a tile of more than ``4 * team`` queries is cut into
    slices of that many on the grid."""
    team = min(t4_team(tq), T5_THREADS)
    slices = T5_THREADS // team
    groups = -(-m // 8)
    return team, slices, -(-groups // slices) * 8


def _launch_min(fn, q, cand_t, dim: int, kernel: int):
    _check(q, cand_t, dim, multiple=1)
    if q.device.type == "cpu":
        return tile_min_plain(q, cand_t, dim)
    lib = build()
    q, cand_t = q.contiguous(), cand_t.contiguous()
    T, tq, _ = q.shape
    team = t4_team(tq) if kernel == 4 else t5_shape(tq, cand_t.shape[2])[0]
    out = torch.empty((T, tq), dtype=torch.float32, device=q.device)
    err = lib.pm_tile_min(q.data_ptr(), cand_t.data_ptr(), T, tq,
                          cand_t.shape[2], dim, kernel, team, out.data_ptr(),
                          torch.cuda.current_stream(q.device).cuda_stream)
    LIBRARY.check(err, f"tile min-only kernel T{kernel}")
    fn.launches += 1
    return out


def tile_min_only(q, cand_t, dim: int):
    """T4: each query's minimum d² over its tile's candidates, four queries
    a thread, the tables staged by ``cp.async`` through two buffers →
    ``d2 [T, TQ]``."""
    return _launch_min(tile_min_only, q, cand_t, dim, 4)


def tile_min_one(q, cand_t, dim: int):
    """T5: T4's function, one tile a block, its whole candidate list in one
    step, swept in column slices by teams of four queries a thread
    (:func:`t5_shape`; M ≤ ``MIN_ONE_MAX``) → ``d2 [T, TQ]``."""
    if cand_t.shape[-1] > MIN_ONE_MAX:
        raise ValueError(f"T5 takes at most {MIN_ONE_MAX} candidates a tile, "
                         f"got {cand_t.shape[-1]}")
    return _launch_min(tile_min_one, q, cand_t, dim, 5)


def reset_launch_counts() -> None:
    for fn in (tile_sweep, tile_sweep_k, tile_min_only, tile_min_one):
        fn.launches = 0


reset_launch_counts()
