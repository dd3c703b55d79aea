"""The survivor-sweep exact 1-NN step (counterpart of
``libpointmatcher_tpu.ops.knn_sweep2``, its host tables and its step glue).

The map is Morton-sorted and cut into 128-row chunks, and two tables are
built once per map on the host: per-chunk boxes (:func:`chunk_summaries`)
and the chunked map itself (:func:`chunked_ref_table`). Each serving
iteration then runs two kernels (:mod:`.sweep_cuda`):

- K2 bounds each query's nearest-neighbour distance from above by the
  chunk boxes and the bound carried from the previous iteration, and flags
  per 256-query tile the chunks that may hold any query's neighbour;
- K3 (map up to ``SKIP_MAX_MPAD`` rows) or K4 (larger maps; on the card
  the same schedule) sweeps, for each query, only the chunks flagged for
  its own 256-query tile; for k = 2..4 neighbours K6 sweeps them into a
  top-k (resident maps only). The JAX package sweeps the OR of four bound
  tiles (its ``sweep_tile_q`` of 1024), with the same result.

The result is exact: the chunk of a valid query's true neighbour always
survives, both bounds being inflated outward by 4 ulp, and every winner
comes from the exact difference-form sweep.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import telemetry
from . import sweep_cuda

__all__ = ["chunk_summaries", "chunked_ref_table", "nn1_sorted_v2",
           "nnk_sorted_v2", "query_table", "FAR", "UP", "SKIP_MAX_MPAD"]

#: box and penalty sentinel of empty chunks and invalid queries
FAR = 1.0e15
#: float32(1 + 4e-7), the outward inflation of a bound
UP = float(np.float32(1.0 + 4e-7))
#: largest padded map served by K3 (resident in the TPU's VMEM); above it
#: K4, which the card runs on K3's schedule
SKIP_MAX_MPAD = 32768

_CHUNK = 128
_ROWS = 8


def chunk_summaries(pts_sorted, mask_sorted) -> np.ndarray:
    """Host, once per map: ``[8, nch_pad]`` float32 per-chunk table. Rows
    0..2 the box's lo and 3..5 its hi over valid rows, pushed outward by
    4e-7·(|lo| + |hi|) in float64; row 6 the chunk's valid count; empty and
    padding chunks at ``FAR`` with count 0. ``nch_pad`` is a multiple of 128."""
    pts = np.asarray(pts_sorted, np.float64)
    mask = np.asarray(mask_sorted, bool)
    n, d = pts.shape
    npad = -(-n // _CHUNK) * _CHUNK
    p = np.full((npad, d), np.nan)
    p[:n] = np.where(mask[:, None], pts, np.nan)
    p = p.reshape(-1, _CHUNK, d)
    nch = p.shape[0]
    nch_pad = -(-nch // 128) * 128
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nanmin(p, axis=1)
        hi = np.nanmax(p, axis=1)
    empty = np.isnan(lo[:, 0])
    span = np.where(empty[:, None], 0.0, np.abs(hi) + np.abs(lo))
    lo = np.where(empty[:, None], FAR, lo - 4e-7 * span)
    hi = np.where(empty[:, None], FAR, hi + 4e-7 * span)
    out = np.full((_ROWS, nch_pad), np.float32(FAR))
    out[:d, :nch] = lo.T.astype(np.float32)
    out[3:3 + d, :nch] = hi.T.astype(np.float32)
    out[6:, :] = 0.0
    cnt = np.zeros((npad,), np.float32)
    cnt[:n] = mask.astype(np.float32)
    out[6, :nch] = cnt.reshape(-1, _CHUNK).sum(axis=1)
    return out


def chunked_ref_table(pts_sorted, mask_sorted) -> np.ndarray:
    """Host, once per map: ``[nch, 8, 128]`` float32 chunked map. Rows
    0..2 the coordinates, row 3 the penalty (0 valid, +inf invalid or
    padding), the rest 0."""
    pts = np.asarray(pts_sorted, np.float32)
    mask = np.asarray(mask_sorted, bool)
    n, d = pts.shape
    npad = -(-n // _CHUNK) * _CHUNK
    out = np.zeros((npad // _CHUNK, _ROWS, _CHUNK), np.float32)
    p = np.zeros((npad, d), np.float32)
    p[:n] = pts
    pen = np.full((npad,), np.inf, np.float32)
    pen[:n] = np.where(mask, 0.0, np.inf)
    out[:, :d, :] = p.reshape(-1, _CHUNK, d).transpose(0, 2, 1)
    out[:, 3, :] = pen.reshape(-1, _CHUNK)
    return out


def query_table(qs: torch.Tensor, qm: torch.Tensor,
                ub_t: torch.Tensor) -> torch.Tensor:
    """``qs [..., n, d]`` → the ``[B·n_pad, 8]`` query table of the
    flattened batch: each scan padded to ``n_pad``, a multiple of 2048 rows
    (eight bound tiles, two sweep tiles), so that no tile holds rows of two
    scans. Cols 0..d−1 coordinates, col 3 0 (valid) or ``FAR``, col 4 the
    transported bound (+inf where unknown and on padding)."""
    *bshape, n, d = qs.shape
    b = int(np.prod(bshape, dtype=np.int64))
    step = max(8 * sweep_cuda.BOUND_TILE, sweep_cuda.SWEEP_TILE)
    n_pad = -(-n // step) * step
    qp = torch.zeros((b, n_pad, _ROWS), dtype=torch.float32, device=qs.device)
    qp[:, :n, :d] = qs.reshape(b, n, d)
    qp[:, :, 3] = FAR
    qp[:, :n, 3] = torch.where(qm.reshape(b, n), 0.0, FAR)
    qp[:, :, 4] = float("inf")
    qp[:, :n, 4] = ub_t.reshape(b, n)
    return qp.reshape(b * n_pad, _ROWS)


def _survivor_step(qs, qm, ub_t, rt3, ct, k, sweep):
    """Query table → K2 (bounding the k-th neighbour) → ``sweep(qp, rt3,
    surv)`` on K2's own flags, one row per 256 queries; masked ``(d2 [...,
    n, k'], ids [..., n, k'])``. At the ``detail`` telemetry level, the
    share of (1024-query tile, chunk) pairs that survive, per scan (the JAX
    package's diagnostic at its default ``sweep_tile_q``), is recorded as
    ``survivor_share``."""
    *bshape, n, _ = qs.shape
    nch = rt3.shape[0]
    qp = query_table(qs, qm, ub_t)
    _, surv_b = sweep_cuda.survivors_and_bounds(qp, ct, k, nch=nch)
    if telemetry.detail():
        fold = sweep_cuda.SWEEP_TILE // sweep_cuda.BOUND_TILE
        surv = surv_b.reshape(-1, fold, surv_b.shape[1]).amax(dim=1)
        per_scan = surv.reshape(*bshape, -1, surv.shape[1])
        telemetry.sample("survivor_share", (
            per_scan[..., :nch].sum(dim=(-2, -1)).to(torch.float32)
            / (per_scan.shape[-2] * max(nch, 1))))
    d2, ids = sweep(qp, rt3, surv_b)
    n_pad = qp.shape[0] // max(int(np.prod(bshape, dtype=np.int64)), 1)
    d2 = d2.reshape(*bshape, n_pad, -1)[..., :n, :]
    ids = ids.reshape(*bshape, n_pad, -1)[..., :n, :]
    finite = torch.isfinite(d2)
    valid = qm[..., None]
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    ids = torch.where(valid & finite, ids, torch.full_like(ids, -1))
    return d2, ids


def nn1_sorted_v2(qs: torch.Tensor, qm: torch.Tensor, ub_t: torch.Tensor,
                  rt3: torch.Tensor, ct: torch.Tensor, stream: bool = False):
    """One serving iteration's matching: bounds → survivors → exact sweep,
    for every scan of the batch at once.

    ``qs [..., n, d]`` Morton-sorted queries at the current pose, ``qm``
    their validity, ``ub_t [..., n]`` the transported bound on each
    query's neighbour distance (+inf unknown); ``rt3``, ``ct`` the map's
    tables. One K2 launch and one K3 (``stream=False``) or K4 launch serve
    all scans. Each query sweeps the chunks K2 flagged for its own
    256-query tile (the JAX package's default sweeps the OR of four,
    ``sweep_tile_q=1024``, with the same result). Returns ``(d2 [..., n],
    ids [..., n])``: ids index the sorted map, (+inf, −1) at invalid
    queries (the survivor share: :func:`_survivor_step`)."""
    sweep = (sweep_cuda.nn1_survivor_sweep_stream if stream
             else sweep_cuda.nn1_survivor_sweep)
    d2, ids = _survivor_step(qs, qm, ub_t, rt3, ct, 1, sweep)
    return d2[..., 0], ids[..., 0]


def nnk_sorted_v2(qs: torch.Tensor, qm: torch.Tensor, ub_t: torch.Tensor,
                  rt3: torch.Tensor, ct: torch.Tensor, k: int):
    """The top-k (k = 2..4) counterpart of :func:`nn1_sorted_v2` on a
    resident map: K2 bounds the k-th neighbour (only chunks holding k valid
    rows may bind it), and K6 sweeps, for each query, the chunks flagged for
    its own 256-query tile: every chunk that holds any of a valid query's k
    nearest rows survives for its tile, so the result is the JAX package's
    at its 1024-query fold, ties included. ``ub_t`` transports the previous
    iteration's k-th distance. Returns ``(d2 [..., n, k], ids [..., n,
    k])``, ascending, (+inf, −1) at invalid queries and empty slots."""
    def sweep(qp, rt3_, surv):
        return sweep_cuda.nnk_survivor_sweep(qp, rt3_, surv, k)

    return _survivor_step(qs, qm, ub_t, rt3, ct, k, sweep)
