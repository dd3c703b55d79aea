"""Exact self-k-NN of a large cloud through the tile sweep and a dense
fallback (counterpart of ``libpointmatcher_tpu.ops.knn_self``).

The prep filters (``SurfaceNormal``) need the true k nearest neighbours with
no radius bound (reference: SurfaceNormal.cpp:82-290). A dense sweep costs
N² pairs, so from ``CULL_MIN_POINTS`` valid points on:

1. the cell edge is chosen so that an edge-cube holds ~4k points at the
   cloud's mean density;
2. one tile-sweep top-k (K8) runs at radius ``edge``: a row whose k-th
   neighbour lies within ``edge`` is exact, since the 3^d cells around its
   own cover the whole ball;
3. the rows left (sparse regions, gaps) run the dense search (K5) against
   the whole cloud.

Exactness never rests on the density guess: a bad edge only moves rows
between the two passes.
"""

from __future__ import annotations

import numpy as np
import torch

from .dispatch import apply_max_dist, knn_search, radius2
from .tilesweep import (TILE_KNN_MAX, assign_tiles, build_sub_blocks,
                        gather_candidates, live_columns,
                        tile_knnk_from_candidates, tile_nn1_from_candidates)

__all__ = ["knn_self_culled", "CULL_MIN_POINTS"]

#: valid points from which SurfaceNormal takes this path (the JAX
#: package's measured crossover)
CULL_MIN_POINTS = 60_000


def knn_self_culled(points, mask, k: int, max_dist: float = np.inf):
    """k-NN of a cloud ``points [N, d]`` against itself → ``(dists2 [N, k],
    ids [N, k])`` ascending, (+inf, −1) invalid: the contract of
    ``dispatch.knn_search(points, mask, points, mask, k)`` with
    ``max_dist`` applied, exact."""
    def dense():
        d, i = knn_search(points, mask, points, mask, k=k)
        return apply_max_dist(d, i, max_dist)

    if k > TILE_KNN_MAX:
        return dense()
    pts_h, mask_h = points.cpu().numpy(), mask.cpu().numpy()
    valid = pts_h[mask_h]
    n_valid, d = valid.shape if valid.size else (0, pts_h.shape[1])
    if n_valid < 2:
        return dense()

    extent = np.maximum(valid.max(axis=0) - valid.min(axis=0), 1e-9)
    edge = float(1.0 * (np.prod(extent) * 4.0 * k / n_valid) ** (1.0 / d))
    edge = min(edge, float(extent.max()))
    sweep_r = min(edge, float(max_dist))

    sub = build_sub_blocks(pts_h, mask_h, edge)
    ta = assign_tiles(pts_h, mask_h, sub, tile_q=256, block_cap=1024)
    dev = points.device
    t = lambda a: torch.as_tensor(a, device=dev)
    cand_t = gather_candidates(t(sub.units), t(ta.blocks))
    ncols = t(live_columns(ta.blocks, len(sub.units) - 1))
    if k == 1:
        d1, i1 = tile_nn1_from_candidates(points, mask, t(ta.q_rows), cand_t,
                                          sweep_r, None, t(ta.vrows), ncols)
        dk, ik = d1[:, None], i1[:, None]
    else:
        dk, ik = tile_knnk_from_candidates(points, mask, t(ta.q_rows), cand_t,
                                           sweep_r, None, t(ta.vrows), k,
                                           ncols)
    if max_dist <= edge:
        return dk, ik                  # the sweep covered the whole radius

    # rows whose k-th hit is not provably inside the covered ball
    bad = mask & (dk[:, k - 1] > radius2(edge))
    rows = torch.nonzero(bad, as_tuple=True)[0]
    if rows.numel() == 0:
        return dk, ik
    dd, di = knn_search(points[rows], torch.ones_like(rows, dtype=torch.bool),
                        points, mask, k=k)
    dd, di = apply_max_dist(dd, di, max_dist)
    dk[rows] = dd
    ik[rows] = di
    return dk, ik
