"""Block-grid bounded-radius 1-NN by dense cell-block sweeps (counterpart
of ``libpointmatcher_tpu.ops.cellblocks``): the earlier form of the tile
sweep that ``BlockGridMatcher`` now runs, kept for the sharded op
:func:`..parallel.sharding.sharded_block_nn1`.

The host side is numpy, the JAX package's own algorithm, copied so that
the port imports nothing of that package:

1. **Reference blocks** (:func:`build_ref_blocks`, once per reference): the
   reference sorted by cell, each non-empty cell padded to the fullest
   cell's size, ``[Cn+1, M, d]`` (the last block the empty sentinel).
2. **Query blocks** (:func:`assign_query_blocks`, once per registration):
   valid queries grouped by cell, ``rows [Cq, Q]``, each group with the
   slots of the 3^d cells around it, ``nb_slots [Cq, 3^d]`` (a missing or
   out-of-grid cell resolves to the sentinel).

:func:`block_nn1` then sweeps each query block against its candidate
blocks in plain torch, as the JAX package leaves it to XLA (it has no
Pallas kernel, and the port no CUDA one): the exact difference form
``((dx² + dy²) + dz²)``, the radius, the first of equal minima, and the
result written at each query's row. It walks the query blocks in slices of
about 2^24 distances, so the ``[Cq, Q, 3^d·M]`` tensor is never whole.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .tilesweep import bucket_size

__all__ = ["RefBlocks", "QueryBlocks", "build_ref_blocks",
           "assign_query_blocks", "block_nn1"]

#: distances a slice of :func:`block_nn1` forms at a time
_SLICE = 1 << 24


def _round8(n: int) -> int:
    return max(((n + 7) // 8) * 8, 8)


class RefBlocks(NamedTuple):
    """Compact cell-sorted reference (host-built, static per init)."""

    blocks: torch.Tensor     # [Cn+1, M, d] padded cell contents (last = empty)
    block_ids: torch.Tensor  # [Cn+1, M] int32 original row ids (-1 = pad)
    ulins: np.ndarray        # [Cn] sorted linear ids of non-empty cells
    origin: np.ndarray       # [d] grid origin
    cell_size: float
    dims: Tuple[int, ...]    # grid extent in cells
    counts: np.ndarray = None  # [Cn+1] valid points per slot (sentinel: 0)


class QueryBlocks(NamedTuple):
    """Per-registration query grouping (host-built at loop start)."""

    rows: torch.Tensor       # [Cq, Q] int32 query row indices (-1 = pad)
    nb_slots: torch.Tensor   # [Cq, 3^d] int32 slots into RefBlocks.blocks
    #: (query, candidate) pairs swept per iteration
    touched: int = 0


def _linearize(coords: np.ndarray, dims: Tuple[int, ...]) -> np.ndarray:
    lin = coords[:, 0].copy()
    stride = dims[0]
    for a in range(1, len(dims)):
        lin += coords[:, a] * stride
        stride *= dims[a]
    return lin


def build_ref_blocks(points, mask, cell_size: float, device=None) -> RefBlocks:
    """Host build, once per reference; the tables on ``device`` (the card
    unless ``device="cpu"``)."""
    dev = resolve_device(device)
    pts = np.asarray(points, np.float64)
    valid = np.flatnonzero(np.asarray(mask, bool))
    d = pts.shape[1]
    if len(valid) == 0:
        return RefBlocks(
            blocks=torch.zeros((1, 8, d), dtype=torch.float32, device=dev),
            block_ids=torch.full((1, 8), -1, dtype=torch.int32, device=dev),
            ulins=np.zeros(0, np.int64), origin=np.zeros(d),
            cell_size=float(cell_size), dims=(1,) * d,
            counts=np.zeros(1, np.int64))
    vp = pts[valid]
    origin = vp.min(axis=0)
    coords = np.floor((vp - origin) / cell_size).astype(np.int64)
    dims = tuple(int(c) + 1 for c in coords.max(axis=0))
    lin = _linearize(coords, dims)

    order = np.argsort(lin, kind="stable")
    ulins, starts, counts = np.unique(lin[order], return_index=True,
                                      return_counts=True)
    cn = len(ulins)
    m = _round8(int(counts.max()))
    rank = np.arange(len(order)) - np.repeat(starts, counts)
    slot = np.repeat(np.arange(cn), counts)
    blocks = np.zeros((cn + 1, m, d), np.float32)
    block_ids = np.full((cn + 1, m), -1, np.int64)
    rows = valid[order]
    blocks[slot, rank] = pts[rows]
    block_ids[slot, rank] = rows
    return RefBlocks(
        blocks=torch.as_tensor(blocks, device=dev),
        block_ids=torch.as_tensor(block_ids.astype(np.int32), device=dev),
        ulins=ulins, origin=origin, cell_size=float(cell_size), dims=dims,
        counts=np.concatenate([counts, [0]]))


def assign_query_blocks(query, mask, ref: RefBlocks) -> QueryBlocks:
    """Host assignment of queries to grid cells, on the device of
    ``ref``'s tables. A query's candidates are the 3^d cells around its
    unclamped cell coordinates; out-of-grid or empty cells resolve to the
    sentinel block (no clamping, which could alias far queries onto border
    cells). Both block axes are bucketed as in the JAX package: ``Cq`` on
    the 256-granule ladder, ``Q`` on the granule-8 one."""
    dev = ref.blocks.device
    pts = np.asarray(query, np.float64)
    d = pts.shape[1]
    dims = np.asarray(ref.dims)
    coords = np.floor((pts - ref.origin) / ref.cell_size).astype(np.int64)
    keep = np.flatnonzero(np.asarray(mask, bool))
    if len(keep) == 0:
        return QueryBlocks(
            rows=torch.full((1, 8), -1, dtype=torch.int32, device=dev),
            nb_slots=torch.full((1, 3 ** d), len(ref.ulins), dtype=torch.int32,
                                device=dev))
    kc = coords[keep]
    lo = kc.min(axis=0)
    ext = tuple(int(e) + 1 for e in (kc.max(axis=0) - lo))
    qlin = _linearize(kc - lo, ext)
    order = np.argsort(qlin, kind="stable")
    uq, starts, counts = np.unique(qlin[order], return_index=True,
                                   return_counts=True)
    cq = int(bucket_size(len(uq)))
    q = int(bucket_size(int(counts.max()), granule=8))
    rows = np.full((cq, q), -1, np.int64)
    rank = np.arange(len(order)) - np.repeat(starts, counts)
    qslot = np.repeat(np.arange(len(uq)), counts)
    rows[qslot, rank] = keep[order]

    rep = kc[order[starts]]
    offs = np.stack(np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij"),
                    axis=-1).reshape(-1, d)
    nc = rep[:, None, :] + offs[None, :, :]
    in_grid = np.all((nc >= 0) & (nc < dims), axis=-1)
    nlin = _linearize(np.clip(nc, 0, dims - 1).reshape(-1, d),
                      ref.dims).reshape(len(uq), -1)
    cn = len(ref.ulins)
    if cn == 0:
        slots = np.zeros_like(nlin)
    else:
        pos = np.clip(np.searchsorted(ref.ulins, nlin), 0, cn - 1)
        hit = in_grid & (ref.ulins[pos] == nlin)
        slots = np.where(hit, pos, cn)
    full_slots = np.full((cq, slots.shape[1]), max(cn, 0), np.int64)
    full_slots[:len(uq)] = slots
    touched = 0
    if ref.counts is not None:
        touched = int((ref.counts[slots].sum(axis=1) * counts).sum())
    return QueryBlocks(
        rows=torch.as_tensor(rows.astype(np.int32), device=dev),
        nb_slots=torch.as_tensor(full_slots.astype(np.int32), device=dev),
        touched=touched)


def block_nn1(points: torch.Tensor, qb: QueryBlocks, blocks: torch.Tensor,
              block_ids: torch.Tensor, max_dist: float):
    """Exact bounded-radius 1-NN of ``points`` [N, d] through the block
    structure → ``(dists2 [N], ids [N] int32)``, (+inf, −1) beyond the
    radius and for rows absent from ``qb``. Among equal distances the
    first candidate of the query block's list wins."""
    n, d = points.shape
    dev = points.device
    r2 = float(np.float32(max_dist) * np.float32(max_dist))
    out_d = torch.full((n,), float("inf"), dtype=torch.float32, device=dev)
    out_i = torch.full((n,), -1, dtype=torch.int32, device=dev)
    cq, qn = qb.rows.shape
    om = qb.nb_slots.shape[1] * blocks.shape[1]
    step = max(1, _SLICE // max(qn * om, 1))
    for c0 in range(0, cq, step):
        rows = qb.rows[c0:c0 + step].long()                 # [c, Q]
        slots = qb.nb_slots[c0:c0 + step].long()            # [c, O]
        q = points[rows.clamp(min=0)]                       # [c, Q, d]
        cand = blocks[slots].reshape(len(rows), om, d)      # [c, OM, d]
        cid = block_ids[slots].reshape(len(rows), om)       # [c, OM]
        d2 = None
        for a in range(d):
            diff = q[:, :, None, a] - cand[:, None, :, a]
            d2 = diff * diff if d2 is None else d2 + diff * diff
        inf = torch.full_like(d2, float("inf"))
        d2 = torch.where(cid[:, None, :] >= 0, d2, inf)
        d2 = torch.where(d2 <= r2, d2, inf)
        best = torch.argmin(d2, dim=2)                      # first of equal minima
        bd = torch.gather(d2, 2, best[..., None])[..., 0]
        bi = torch.gather(cid, 1, best)
        bi = torch.where(torch.isfinite(bd), bi, torch.full_like(bi, -1))
        ok = rows >= 0
        out_d[rows[ok]] = bd[ok]
        out_i[rows[ok]] = bi[ok]
    return out_d, out_i
