"""Cell-grid (cell-list) bounded-radius k-NN (counterpart of
``libpointmatcher_tpu.ops.cellgrid``), in plain torch.

- **build** (host, once per reference): hash the valid points into cubic
  cells of edge ``cell_size``, sort them by cell, and record each cell's
  start offset in the sorted order;
- **query** (the reference's device, per call): each query gathers the
  candidates of the 3^d cells around its own, a ``[tile, 3^d, mc]`` gather
  (``mc``: the fullest cell, rounded up to a power of two), and reduces
  their squared distances.

Exact within the radius: a reference point within ``max_dist`` (at most the
cell edge) of a query lies in one of the 3^d cells around the query's
clamped cell. Matches beyond the radius, and invalid queries, get
(+inf, −1). The arithmetic is the JAX package's: the build assigns cells in
float64 as ``floor((p - origin) / cell_size)``, a query in float32 as
``floor((q - origin32) * float32(1 / cell_size))``; the squared distance is
``dx² + dy² (+ dz²)`` summed in that order; k = 1 keeps the first minimum
in candidate order (neighbour cell, then slot) and k > 1 a stable sort's
first k, which breaks ties as ``jax.lax.top_k`` does. The JAX package pads
``cell_start`` and ``order`` to a bucket and clips its gather positions;
here both hold their exact lengths and the positions are clamped to them
(a clamped slot is never a valid candidate).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = ["CellGrid", "build_cell_grid", "cell_knn", "QUERY_TILE"]

#: queries per gather, which bounds the [tile, 3^d, mc] candidate tensors
#: (the JAX package's ``_cell_knn`` tile)
QUERY_TILE = 16384


class CellGrid(NamedTuple):
    origin: torch.Tensor      # [d] float32 grid origin
    inv_cell: torch.Tensor    # float32 scalar, float32(1 / cell_size)
    dims: Tuple[int, ...]     # cells per axis
    cell_start: torch.Tensor  # [C + 1] int64 offsets into ``order``
    order: torch.Tensor       # [M_valid] int64 reference rows sorted by cell
    max_per_cell: int         # mc: the fullest cell, rounded up to 2^j


def build_cell_grid(points: np.ndarray, mask: np.ndarray, cell_size: float,
                    device="cpu") -> CellGrid:
    """Host build over the valid rows of ``points`` [M, d] (reference:
    MatchersImpl.cpp:78-83, the kd-tree build at ``init``); the tables go to
    ``device``. A reference with no valid row gets one cell holding row 0,
    as in the JAX package."""
    pts = np.asarray(points, np.float64)
    valid_idx = np.flatnonzero(np.asarray(mask, bool))
    vp = pts[valid_idx]
    if len(vp) == 0:
        vp = np.zeros((1, pts.shape[1]))
        valid_idx = np.zeros(1, np.int64)
    origin = vp.min(axis=0)
    coords = np.floor((vp - origin) / cell_size).astype(np.int64)
    dims = tuple(int(c) + 1 for c in coords.max(axis=0))
    lin = coords[:, 0]
    stride = dims[0]
    for a in range(1, pts.shape[1]):
        lin = lin + coords[:, a] * stride
        stride *= dims[a]
    sort = np.argsort(lin, kind="stable")
    cell_start = np.searchsorted(lin[sort], np.arange(int(stride) + 1))
    max_per_cell = int(np.diff(cell_start).max())
    mc = 1
    while mc < max_per_cell:
        mc *= 2
    return CellGrid(
        origin=torch.as_tensor(origin.astype(np.float32), device=device),
        inv_cell=torch.tensor(np.float32(1.0 / cell_size), device=device),
        dims=dims,
        cell_start=torch.as_tensor(cell_start.astype(np.int64), device=device),
        order=torch.as_tensor(valid_idx[sort].astype(np.int64), device=device),
        max_per_cell=mc)


def _offsets(d: int, device) -> torch.Tensor:
    """The 3^d neighbour-cell offsets [3^d, d], the first axis slowest."""
    axes = torch.meshgrid(*([torch.tensor([-1, 0, 1])] * d), indexing="ij")
    return torch.stack([a.reshape(-1) for a in axes], dim=1).to(device)


def cell_knn(query: torch.Tensor, query_mask: torch.Tensor,
             ref_points: torch.Tensor, grid: CellGrid, max_dist: float,
             k: int = 1):
    """k-NN of ``query`` [..., N, d] among the grid's reference points
    within ``max_dist`` → ``(dists2 [..., N, k] ascending, ids [..., N, k]
    int32)``, (+inf, −1) beyond the radius and for invalid queries. Leading
    batch dimensions are flattened into the query axis (each query's result
    depends on it alone), which is then cut into ``QUERY_TILE`` rows."""
    lead, d = query.shape[:-1], query.shape[-1]
    q, qm = query.reshape(-1, d), query_mask.reshape(-1)
    parts = [_cell_knn_tile(q[s:s + QUERY_TILE], qm[s:s + QUERY_TILE],
                            ref_points, grid, max_dist, k)
             for s in range(0, q.shape[0], QUERY_TILE)]
    if not parts:
        return (torch.empty(*lead, k, device=query.device),
                torch.empty(*lead, k, dtype=torch.int32, device=query.device))
    return (torch.cat([p[0] for p in parts]).reshape(*lead, k),
            torch.cat([p[1] for p in parts]).reshape(*lead, k))


def _cell_knn_tile(q, qm, ref_points, grid: CellGrid, max_dist: float, k: int):
    n, d = q.shape
    dev = q.device
    dims = torch.tensor(grid.dims, device=dev)
    # the query's cell, clamped into the grid; clamping in float32 before
    # the conversion gives what a saturating conversion then a clip gives
    c = torch.floor((q - grid.origin) * grid.inv_cell)
    c = torch.minimum(torch.clamp(torch.nan_to_num(c, nan=0.0), min=0.0),
                      (dims - 1).to(c.dtype)).to(torch.int64)
    nb = c[:, None, :] + _offsets(d, dev)[None]               # [n, 3^d, d]
    in_grid = ((nb >= 0) & (nb < dims)).all(dim=-1)
    nbc = torch.minimum(torch.clamp(nb, min=0), dims - 1)
    lin = nbc[..., 0]
    stride = grid.dims[0]
    for a in range(1, d):
        lin = lin + nbc[..., a] * stride
        stride *= grid.dims[a]
    start = grid.cell_start[lin]
    count = torch.where(in_grid, grid.cell_start[lin + 1] - start, 0)
    slot = torch.arange(grid.max_per_cell, device=dev)
    cand_pos = start[..., None] + slot                        # [n, 3^d, mc]
    cand_valid = slot < count[..., None]
    cand_ids = grid.order[cand_pos.clamp(max=grid.order.shape[0] - 1)]
    d2 = None
    for a in range(d):
        diff = q[:, a, None, None] - ref_points[:, a][cand_ids]
        d2 = diff * diff if d2 is None else d2 + diff * diff
    inf = torch.tensor(float("inf"), device=dev)
    d2 = torch.where(cand_valid, d2, inf)
    r2 = float(np.float32(max_dist) * np.float32(max_dist))
    d2 = torch.where(d2 <= r2, d2, inf)
    flat_d, flat_i = d2.reshape(n, -1), cand_ids.reshape(n, -1)
    if k == 1:
        pos = torch.argmin(flat_d, dim=1, keepdim=True)   # the first minimum
    else:
        pos = torch.sort(flat_d, dim=1, stable=True).indices[:, :k]
    bd = torch.where(qm[:, None], torch.gather(flat_d, 1, pos), inf)
    bi = torch.where(torch.isfinite(bd), torch.gather(flat_i, 1, pos), -1)
    return bd, bi.to(torch.int32)
