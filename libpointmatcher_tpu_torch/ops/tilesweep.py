"""Tile-sweep bounded-radius k-NN (counterpart of
``libpointmatcher_tpu.ops.tilesweep``): culling whose work scales with the
candidates touched, not with N·M.

The host side is numpy, the JAX package's own algorithm, copied so that the
port imports nothing of that package:

1. **Fixed 8-point sub-blocks** (:func:`build_sub_blocks`, once per
   reference): the reference is cell-sorted and each cell's points split
   into sub-blocks of 8 rows, gathered in units of ``GATHER_G`` sub-blocks
   (64 rows) into one table ``units [U+1, 64, d+1]`` whose last column is
   the original row id; unit U is all padding.
2. **Query tiles with per-tile candidate lists** (:func:`assign_tiles`,
   once per registration): valid queries are sorted in the Morton order of
   their cells and grouped into tiles of TQ; each tile's candidates are the
   units of the 3^d cells around its queries' cells. A tile whose union
   exceeds ``block_cap`` rows is split into virtual tiles that share its
   queries (the JAX package's bound on TPU VMEM); the card's kernels sweep
   a parent's virtual tiles in one block and merge them there.

On the device, :func:`gather_candidates` builds the loop-static candidate
tables ``cand_t [T, 8, M]`` with one torch index, :func:`live_columns`
gives each table's live prefix, and each iteration makes one K7 (1-NN) or
K8 (top-k) launch (:mod:`.tile_cuda`, the parent form) over every parent
tile of every scan, which merges the parent's virtual tiles and applies
``maxDist`` and the mask in the kernel. Exact within ``maxDist`` as long
as no query moves farther than the cell edge minus ``maxDist`` from where
it was assigned (the matcher's ``motionBound``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..cloud import bucket_size
from .tile_cuda import (CID_ROW, DPAD, PEN_ROW, TILE_KNN_MAX,  # noqa: F401
                        _by_parent, _combine_min, _merge_rows, _merge_sorted_k,
                        tile_sweep_k_parents, tile_sweep_parents)

__all__ = ["SubBlocks", "TileAssign", "build_sub_blocks", "assign_tiles",
           "gather_candidates", "live_columns", "tile_nn1",
           "tile_nn1_from_candidates", "tile_knnk_from_candidates",
           "bucket_size", "TILE_KNN_MAX", "SB", "GATHER_G"]

SB = 8        # sub-block rows
#: sub-blocks per gather unit: a tile's slot list is almost a run of
#: consecutive slots, so 64-row units cut the gather's rows ~7x for ~11%
#: more padded candidates. A unit's extra rows lie in cells outside the
#: tile's union, hence beyond maxDist, and the radius mask drops them.
GATHER_G = 8


class SubBlocks(NamedTuple):
    """Cell-sorted reference in 8-row sub-blocks (host numpy)."""

    pts: np.ndarray       # [S+1, SB, d] coordinates (slot S: empty)
    ids: np.ndarray       # [S+1, SB] int32 original row ids (-1 = pad)
    units: np.ndarray     # [U+1, GATHER_G·SB, d+1] float32, unit U all pad
    ulins: np.ndarray     # [Cn] sorted linear ids of the non-empty cells
    start: np.ndarray     # [Cn] first sub-block slot of each cell
    nsub: np.ndarray      # [Cn] sub-blocks of each cell
    pcount: np.ndarray    # [Cn] valid points of each cell
    origin: np.ndarray    # [d]
    cell_size: float
    dims: Tuple[int, ...]


class TileAssign(NamedTuple):
    """One registration's query tiling (host numpy, int32)."""

    q_rows: np.ndarray    # [Tp, TQ] parent-tile query rows (-1 = pad)
    blocks: np.ndarray    # [Tv, B] virtual-tile gather units (U = pad)
    touched: int          # (query, candidate) pairs per sweep
    parent: np.ndarray    # [Tv] parent tile of each virtual tile
    vrows: np.ndarray     # [K, Tp] virtual tile merged at step j (K: depth)

    def vtile_q_rows(self) -> np.ndarray:
        """Query rows per virtual tile [Tv, TQ]."""
        return self.q_rows[self.parent]


def _linearize(coords: np.ndarray, dims) -> np.ndarray:
    lin = coords[:, 0].copy()
    stride = int(dims[0])
    for a in range(1, coords.shape[1]):
        lin += coords[:, a] * stride
        stride *= int(dims[a])
    return lin


def _morton(coords: np.ndarray) -> np.ndarray:
    """Z-order key of nonnegative integer cell coords [N, d], d ∈ {2, 3}."""
    d = coords.shape[1]

    def spread3(x):
        x = x.astype(np.uint64) & np.uint64(0x1FFFFF)
        x = (x | (x << 32)) & np.uint64(0x1F00000000FFFF)
        x = (x | (x << 16)) & np.uint64(0x1F0000FF0000FF)
        x = (x | (x << 8)) & np.uint64(0x100F00F00F00F00F)
        x = (x | (x << 4)) & np.uint64(0x10C30C30C30C30C3)
        x = (x | (x << 2)) & np.uint64(0x1249249249249249)
        return x

    def spread2(x):
        x = x.astype(np.uint64) & np.uint64(0xFFFFFFFF)
        x = (x | (x << 16)) & np.uint64(0x0000FFFF0000FFFF)
        x = (x | (x << 8)) & np.uint64(0x00FF00FF00FF00FF)
        x = (x | (x << 4)) & np.uint64(0x0F0F0F0F0F0F0F0F)
        x = (x | (x << 2)) & np.uint64(0x3333333333333333)
        x = (x | (x << 1)) & np.uint64(0x5555555555555555)
        return x

    if d == 3:
        return (spread3(coords[:, 0])
                | (spread3(coords[:, 1]) << np.uint64(1))
                | (spread3(coords[:, 2]) << np.uint64(2)))
    return spread2(coords[:, 0]) | (spread2(coords[:, 1]) << np.uint64(1))


def build_sub_blocks(points: np.ndarray, mask: np.ndarray,
                     cell_size: float) -> SubBlocks:
    """The reference's sub-blocks and gather units (once per reference)."""
    pts = np.asarray(points, np.float64)
    valid = np.flatnonzero(np.asarray(mask, bool))
    d = pts.shape[1]
    if pts.shape[0] >= 1 << 24:
        # row ids ride a float32 row of the candidate table, exact below 2^24
        raise ValueError("tile sweep supports references below 2^24 rows "
                         f"(got {pts.shape[0]}); shard the cloud instead")
    if len(valid) == 0:
        empty_units = np.zeros((2, GATHER_G * SB, d + 1), np.float32)
        empty_units[..., d] = -1.0
        return SubBlocks(
            pts=np.zeros((1, SB, d), np.float32),
            ids=np.full((1, SB), -1, np.int32), units=empty_units,
            ulins=np.zeros(0, np.int64), start=np.zeros(0, np.int64),
            nsub=np.zeros(0, np.int64), pcount=np.zeros(0, np.int64),
            origin=np.zeros(d), cell_size=float(cell_size), dims=(1,) * d)
    vp = pts[valid]
    origin = vp.min(axis=0)
    coords = np.floor((vp - origin) / cell_size).astype(np.int64)
    dims = tuple(int(c) + 1 for c in coords.max(axis=0))
    lin = _linearize(coords, dims)

    order = np.argsort(lin, kind="stable")
    ulins, starts_pt, counts = np.unique(lin[order], return_index=True,
                                         return_counts=True)
    nsub = -(-counts // SB)
    sub_start = np.concatenate([[0], np.cumsum(nsub)])[:-1]
    S = int(nsub.sum())

    # each point's slot: its cell's first slot + its rank in the cell / SB
    rank = np.arange(len(order)) - np.repeat(starts_pt, counts)
    slot = np.repeat(sub_start, counts) + rank // SB
    blocks = np.zeros((S + 1, SB, d), np.float32)
    ids = np.full((S + 1, SB), -1, np.int64)
    rows = valid[order]
    blocks[slot, rank % SB] = pts[rows]
    ids[slot, rank % SB] = rows

    # gather units: slots padded to a multiple of GATHER_G, plus the
    # all-pad unit U at the end
    U = -(-(S + 1) // GATHER_G)
    units = np.zeros(((U + 1) * GATHER_G * SB, d + 1), np.float32)
    units[..., d] = -1.0
    flat_n = (S + 1) * SB
    units[:flat_n, :d] = blocks.reshape(flat_n, d)
    units[:flat_n, d] = ids.reshape(flat_n)
    return SubBlocks(
        pts=blocks, ids=ids.astype(np.int32),
        units=units.reshape(U + 1, GATHER_G * SB, d + 1), ulins=ulins,
        start=sub_start, nsub=nsub, pcount=counts, origin=origin,
        cell_size=float(cell_size), dims=dims)


def assign_tiles(query: np.ndarray, mask: np.ndarray, sub: SubBlocks,
                 tile_q: int = 256, pad_tiles_to: int = 0,
                 pad_blocks_to: int = 0, block_cap: int = 1024) -> TileAssign:
    """One registration's tiling of ``query`` (host numpy, int32).

    ``pad_tiles_to`` / ``pad_blocks_to`` force minimum output shapes. The
    block axis stays even, so that M = B·64 is a multiple of 128: an odd
    ``pad_blocks_to`` is rounded up (the JAX package takes it as given)."""
    pts = np.asarray(query, np.float64)
    d = pts.shape[1]
    keep = np.flatnonzero(np.asarray(mask, bool))
    U = int(sub.units.shape[0]) - 1          # the all-pad unit
    pad_blocks_to += pad_blocks_to % 2
    if len(keep) == 0 or len(sub.ulins) == 0:
        T = max(16, pad_tiles_to)
        return TileAssign(
            q_rows=np.full((T, tile_q), -1, np.int32),
            blocks=np.full((T, max(16, pad_blocks_to)), U, np.int32),
            touched=0, parent=np.zeros((T,), np.int32),
            vrows=np.full((1, T), T - 1, np.int32))

    coords = np.floor((pts[keep] - sub.origin) / sub.cell_size).astype(np.int64)
    # queries in the Morton order of their (unclamped) cells
    qlin = _morton(coords - coords.min(axis=0)).astype(np.int64)
    order = np.argsort(qlin, kind="stable")
    rows_sorted = keep[order]
    qlin_sorted = qlin[order]

    nq = len(rows_sorted)
    T = -(-nq // tile_q)
    T_pad = max(int(bucket_size(T, granule=16)), pad_tiles_to)
    q_rows = np.full((T_pad, tile_q), -1, np.int64)
    q_rows.reshape(-1)[:nq] = rows_sorted

    # (tile, distinct query cell) pairs
    tile_of = np.arange(nq) // tile_q
    new_cell = np.empty(nq, bool)
    new_cell[0] = True
    new_cell[1:] = ((qlin_sorted[1:] != qlin_sorted[:-1])
                    | (tile_of[1:] != tile_of[:-1]))
    pair_idx = np.flatnonzero(new_cell)
    p_tile = tile_of[pair_idx]
    p_coord = coords[order[pair_idx]]
    p_qcount = np.diff(np.concatenate([pair_idx, [nq]]))

    # 3^d neighbourhoods → reference cells hit
    offs = np.stack(np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij"),
                    axis=-1).reshape(-1, d)
    nc = p_coord[:, None, :] + offs[None, :, :]
    dims = np.asarray(sub.dims)
    in_grid = np.all((nc >= 0) & (nc < dims), axis=-1)
    nlin = _linearize(np.clip(nc, 0, dims - 1).reshape(-1, d),
                      sub.dims).reshape(len(p_coord), -1)
    pos = np.clip(np.searchsorted(sub.ulins, nlin), 0, len(sub.ulins) - 1)
    hit = in_grid & (sub.ulins[pos] == nlin)
    cand_pts = np.where(hit, sub.pcount[pos], 0).sum(axis=1)
    touched = int((cand_pts * p_qcount).sum())

    # hit cells expanded to their slot runs, tagged by tile, deduplicated
    # as (tile, gather unit)
    hp = hit.reshape(-1)
    flat_pos = pos.reshape(-1)[hp]
    flat_tile = np.repeat(p_tile, hit.shape[1])[hp]
    run_len = sub.nsub[flat_pos]
    total = int(run_len.sum())
    base = np.repeat(sub.start[flat_pos], run_len)
    within = np.arange(total) - np.repeat(
        np.concatenate([[0], np.cumsum(run_len)])[:-1], run_len)
    sub_slots = base + within
    sub_tiles = np.repeat(flat_tile, run_len)
    ukey = np.unique(sub_tiles * np.int64(U + 1) + sub_slots // GATHER_G)
    u_tile = ukey // (U + 1)
    u_unit = ukey % (U + 1)

    # per-(virtual-)tile unit lists; capu keeps M = capu·64 a multiple of 128
    t_starts = np.searchsorted(u_tile, np.arange(T_pad))
    t_counts = np.diff(np.concatenate([t_starts, [len(ukey)]]))
    within_t = np.arange(len(ukey)) - np.repeat(t_starts, t_counts)
    capu = max((block_cap // (SB * GATHER_G)) // 2 * 2, 2)
    maxc = max(int(t_counts.max()), 1)

    # parent tile t becomes ceil(count_t / capu) consecutive virtual tiles;
    # parents without candidates point at the reserved all-pad vtile Tv
    k_t = -(-t_counts // capu)
    vbase = np.concatenate([[0], np.cumsum(k_t)])[:-1]
    Tv = int(k_t.sum())
    Tv_pad = max(int(bucket_size(Tv + 1, granule=16)), pad_tiles_to)
    parent = np.zeros(Tv_pad, np.int64)
    parent[:Tv] = np.repeat(np.arange(T_pad), k_t)
    B = min(int(bucket_size(maxc, granule=4)), capu)
    if B > 32:
        B = -(-B // 32) * 32
    B = max(B, pad_blocks_to)
    blocks = np.full((Tv_pad, B), U, np.int64)
    blocks[vbase[u_tile] + within_t // capu, within_t % capu] = u_unit
    vb = np.full(T_pad, Tv, np.int64)
    has = k_t > 0
    vb[has] = vbase[has]
    K = max(int(k_t.max()), 1)
    # merge rows past a parent's own vtiles point at the all-pad vtile: a
    # no-op for the min merge and for the k-list merge
    vcand = vb[None, :] + np.arange(K)[:, None]
    last = vb + np.maximum(k_t, 1) - 1
    vrows = np.where(vcand <= last[None, :], vcand, Tv)
    return TileAssign(q_rows=q_rows.astype(np.int32),
                      blocks=blocks.astype(np.int32), touched=touched,
                      parent=parent.astype(np.int32),
                      vrows=vrows.astype(np.int32))


def gather_candidates(units: torch.Tensor, blocks: torch.Tensor):
    """Candidate tables of an assignment's virtual tiles, with one index of
    the unit table ``units [U+1, 64, d+1]`` by ``blocks [..., T, B]`` →
    ``cand_t [..., T, 8, M]``, M = 64·B: rows 0..d−1 the coordinates, row 6
    the pad penalty (0 / +inf), row 7 the original row id as a float."""
    *lead, T, B = blocks.shape
    d = units.shape[-1] - 1
    M = B * units.shape[1]
    g = units[blocks.long()].reshape(*lead, T, M, d + 1).transpose(-1, -2)
    cidf = g[..., d, :]
    cand_t = torch.zeros((*lead, T, DPAD, M), dtype=torch.float32,
                         device=units.device)
    cand_t[..., :d, :] = g[..., :d, :]
    cand_t[..., PEN_ROW, :] = torch.where(cidf >= 0, 0.0, float("inf"))
    cand_t[..., CID_ROW, :] = cidf
    return cand_t


def live_columns(blocks: np.ndarray, pad_unit: int) -> np.ndarray:
    """Each virtual tile's live prefix of its candidate table: 64 × the
    entries of its row of ``blocks [..., Tv, B]`` that are not the all-pad
    unit ``pad_unit`` (an assignment fills a row from the left, so they
    come first) → int32 ``[..., Tv]``."""
    blocks = np.asarray(blocks)
    return (SB * GATHER_G * (blocks != pad_unit).sum(axis=-1)).astype(np.int32)


def tile_nn1_from_candidates(points, qmask, q_rows, cand_t, max_dist: float,
                             parent, vrows, ncols=None):
    """Exact bounded-radius 1-NN through pre-gathered candidate tables →
    ``(dists2 [..., N], ids [..., N])``, (+inf, −1) beyond ``max_dist``,
    for rows absent from the assignment and for masked rows. Each parent
    tile's virtual tiles are merged by (min distance, min row id on ties).

    ``q_rows=None``: the reading is in tile order (the serving drivers
    permute it once), row t·TQ + r being parent tile t's query r, and
    ``points`` may carry leading batch dimensions (``cand_t`` [..., Tv, 8,
    M], ``vrows`` [..., K, Tp], ``ncols`` [..., Tv]): one K7 launch serves
    every scan. With ``q_rows [Tp, TQ]`` (one scan), queries are read and
    results written by row. ``ncols`` holds each table's live prefix
    (:func:`live_columns`; None: every column). ``parent`` is the JAX
    package's argument and is not read: the kernel reads each parent's
    virtual tiles from ``vrows`` (it may be None)."""
    return tile_sweep_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                              max_dist)


def tile_knnk_from_candidates(points, qmask, q_rows, cand_t, max_dist: float,
                              parent, vrows, k: int, ncols=None):
    """Exact bounded-radius k-NN through pre-gathered candidate tables, the
    k > 1 form of :func:`tile_nn1_from_candidates` → ``(dists2 [..., N, k],
    ids [..., N, k])`` ascending per row, (+inf, −1) beyond the radius or
    missing. One K8 launch."""
    return tile_sweep_k_parents(points, qmask, q_rows, cand_t, ncols, vrows,
                                max_dist, k)


def tile_nn1(points, qmask, assign: TileAssign, units, max_dist: float):
    """Exact bounded-radius 1-NN of ``points`` [N, d] through the host
    assignment ``assign`` of their tiles, gathering the candidate tables
    on the way (the engine gathers them once per registration)."""
    t = lambda a: torch.as_tensor(a, device=units.device)
    cand_t = gather_candidates(units, t(assign.blocks))
    ncols = live_columns(assign.blocks, units.shape[0] - 1)
    return tile_nn1_from_candidates(points, qmask, t(assign.q_rows), cand_t,
                                    max_dist, None, t(assign.vrows), t(ncols))
