"""The v1 skip route's host tables and step glue (counterpart of
``libpointmatcher_tpu.ops.knn_skip``): an opt-in serving route of
``KDTreeMatcher`` beside the survivor sweep of :mod:`.sweep`.

Under ``PMTPU_SKIP_V1=1``, on a resident map (up to ``sweep.SKIP_MAX_MPAD``
rows) with knn = 1, each serving iteration:

- bounds each query's squared neighbour distance from above by the
  transported bound of the previous iteration and, under
  ``PMTPU_SKIP_MXU_BOUND=1`` as well, by K10's expansion-form minimum over
  the whole map plus :func:`bound_margin`;
- flags per (256-query tile, 512-row super-chunk of the Morton-sorted map)
  whether the super-chunk's box lies farther from the tile's box than the
  tile's largest bound (:func:`build_skip_mask`);
- runs K11, the exact 1-NN over every super-chunk not flagged.

The result is exact: no flagged super-chunk can hold a valid query's true
neighbour, and every winner comes from the difference-form sweep. The
tables (:func:`chunk_bboxes`, :func:`augmented_ref_table`,
:func:`v1_tables`) are built once per map on the host, in float64 where the
JAX package does, so that they equal its arrays.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from .. import telemetry
from . import skip_cuda

__all__ = ["BOUND_BIG", "BOUND_ERR_C", "chunk_bboxes", "augmented_ref_table",
           "v1_tables", "augment_queries", "bound_margin", "skip_gaps",
           "build_skip_mask", "nn1_sorted_v1"]

#: ‖r‖² of invalid and padding map columns in K10's table. Any value that
#: loses every minimum would do on the card; 1e30 keeps the table equal to
#: the JAX package's.
BOUND_BIG = 1.0e30
#: safety factor of :func:`bound_margin`; the derivation for the port's
#: arithmetic is in the header of csrc/skip.cu
BOUND_ERR_C = 8.0
_EPS = float(np.float32(1.1920929e-07))
_DPAD = 8


def chunk_bboxes(pts_sorted, mask_sorted, chunk: int) -> np.ndarray:
    """Host, once per map: ``[nch, 2, d]`` float32 boxes (lo, hi) of the
    valid rows of each ``chunk`` consecutive rows of the sorted map, formed
    in float64; an empty chunk gets (+inf, −inf), which no tile reaches."""
    pts = np.asarray(pts_sorted, np.float64)
    mask = np.asarray(mask_sorted, bool)
    n, d = pts.shape
    npad = -(-n // chunk) * chunk
    p = np.full((npad, d), np.nan)
    p[:n] = np.where(mask[:, None], pts, np.nan)
    p = p.reshape(-1, chunk, d)
    with np.errstate(invalid="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nanmin(p, axis=1)
        hi = np.nanmax(p, axis=1)
    lo = np.where(np.isnan(lo), np.inf, lo)
    hi = np.where(np.isnan(hi), -np.inf, hi)
    return np.stack([lo, hi], axis=1).astype(np.float32)


def augmented_ref_table(rs_sorted, rmask_sorted, m_pad: int):
    """Host, once per map: the sorted map → (``[8, m_pad]`` float32 table of
    K10, the largest ‖r‖² of a valid row). Rows 0..d−1 the coordinates, row
    3 ‖r‖² (summed in float64) or ``BOUND_BIG`` at invalid and padding
    columns, row 4 ones, the rest zero: q_aug · r_aug = ‖q‖² + ‖r‖² − 2q·r."""
    rs = np.asarray(rs_sorted, np.float32)
    rm = np.asarray(rmask_sorted, bool)
    m, d = rs.shape
    ra = np.zeros((_DPAD, m_pad), np.float32)
    ra[:d, :m] = rs.T
    r2 = np.sum(rs.astype(np.float64) ** 2, axis=1)
    ra[3, :] = BOUND_BIG
    ra[3, :m] = np.where(rm, r2, BOUND_BIG).astype(np.float32)
    ra[4, :] = 1.0
    return ra, float(np.where(rm, r2, 0.0).max(initial=0.0))


def v1_tables(rs_sorted, rmask_sorted, m_pad: int):
    """Host, once per map: K11's tables of the sorted map → (``rt [8,
    m_pad]``, coordinates in rows 0..d−1, zero elsewhere; ``rpen [1,
    m_pad]``, 0 at valid rows, +inf at invalid and padding ones)."""
    rs = np.asarray(rs_sorted, np.float32)
    rm = np.asarray(rmask_sorted, bool)
    m, d = rs.shape
    rt = np.zeros((_DPAD, m_pad), np.float32)
    rt[:d, :m] = rs.T
    rpen = np.full((1, m_pad), np.inf, np.float32)
    rpen[0, :m] = np.where(rm, 0.0, np.inf)
    return rt, rpen


def augment_queries(qs: torch.Tensor, n_pad: int):
    """``qs [..., n, d]`` → (``qa [..., n_pad, 8]``: −2q in columns 0..d−1,
    1 in column 3, ‖q‖² in column 4, padding rows zero but for column 3;
    ``q2 [..., n]``, ‖q‖² = (q0² + q1²) + q2²)."""
    *b, n, d = qs.shape
    sq = qs * qs
    q2 = sq[..., 0]
    for c in range(1, d):
        q2 = q2 + sq[..., c]
    qa = torch.zeros((*b, n_pad, _DPAD), dtype=torch.float32, device=qs.device)
    qa[..., :n, :d] = -2.0 * qs
    qa[..., 3] = 1.0
    qa[..., :n, 4] = q2
    return qa, q2


def bound_margin(q2: torch.Tensor, amin: torch.Tensor) -> torch.Tensor:
    """Per-query absolute error margin of K10's minimum ``amin`` (which may
    be slightly negative) over queries of squared norm ``q2``:
    ``BOUND_ERR_C · eps · (8 (q2 + max(amin, 0)) + 1e-6)``. The 1e-6 keeps
    it above 0 for a query at the origin."""
    return (BOUND_ERR_C * _EPS) * (8.0 * (q2 + amin.clamp(min=0.0)) + 1e-6)


def skip_gaps(qs, qm, ub2, cbox, tile_q: int = skip_cuda.TILE_Q):
    """The two sides of :func:`build_skip_mask`'s test → (``mind2 [..., ni,
    nsg]``, the squared distance between each tile's box of valid queries
    and each super-chunk's box, summed (g0² + g1²) + g2²; ``U2 [..., ni]``,
    the tile's largest bound over its valid queries, −inf for a tile with
    none)."""
    *b, n, d = qs.shape
    ni = -(-n // tile_q)
    pad = ni * tile_q - n
    qsp = torch.nn.functional.pad(qs, (0, 0, 0, pad))
    qmp = torch.nn.functional.pad(qm, (0, pad))
    ub2p = torch.nn.functional.pad(ub2, (0, pad))
    inf = torch.tensor(float("inf"), device=qs.device)
    lo = torch.where(qmp[..., None], qsp, inf).reshape(*b, ni, tile_q, d).amin(-2)
    hi = torch.where(qmp[..., None], qsp, -inf).reshape(*b, ni, tile_q, d).amax(-2)
    U2 = torch.where(qmp, ub2p, -inf).reshape(*b, ni, tile_q).amax(-1)
    cbox = cbox.to(qs.device)
    gap = torch.maximum(lo[..., :, None, :] - cbox[:, 1, :],
                        cbox[:, 0, :] - hi[..., :, None, :]).clamp(min=0.0)
    g2 = gap * gap
    mind2 = g2[..., 0]
    for c in range(1, d):
        mind2 = mind2 + g2[..., c]
    return mind2, U2


def build_skip_mask(qs, qm, ub2, cbox, tile_q: int = skip_cuda.TILE_Q):
    """Skip flags, exact by the bound: ``qs [..., n, d]`` sorted queries at
    their current pose, ``qm`` their validity, ``ub2 [..., n]`` an upper
    bound on each one's squared neighbour distance (+inf unknown), ``cbox``
    the map's super-chunk boxes → int32 ``[..., ni, nsg]``, 1 where the
    super-chunk lies farther from the tile than its largest bound, so that
    it holds no valid query's neighbour. A tile with no valid query skips
    every super-chunk."""
    mind2, U2 = skip_gaps(qs, qm, ub2, cbox, tile_q)
    return (mind2 > U2[..., None]).to(torch.int32)


def nn1_sorted_v1(qs: torch.Tensor, qm: torch.Tensor, ub2: torch.Tensor,
                  rt: torch.Tensor, rpen: torch.Tensor, cbox: torch.Tensor,
                  ra=None):
    """One serving iteration's matching on the v1 route, for every scan of
    the batch at once.

    ``qs [..., n, d]`` Morton-sorted queries at the current pose, ``qm``
    their validity, ``ub2 [..., n]`` the transported bound on each query's
    squared neighbour distance (+inf unknown); ``rt``, ``rpen``, ``cbox``
    the map's tables. With ``ra`` (K10's table), one K10 launch tightens
    the bound first. Then one K11 launch serves all scans. Returns ``(d2
    [..., n], ids [..., n])``: ids index the sorted map, (+inf, −1) at
    invalid queries. At the ``detail`` telemetry level the share of (tile,
    super-chunk) steps skipped, per scan, is recorded as ``skip_share``."""
    if ra is not None:
        n = qs.shape[-2]
        n_pad = -(-n // skip_cuda.TILE_Q) * skip_cuda.TILE_Q
        qa, q2 = augment_queries(qs, n_pad)
        amin = skip_cuda.approx_min_sorted(qa, ra)[..., :n]
        ub2 = torch.minimum(ub2, amin + bound_margin(q2, amin))
    skip = build_skip_mask(qs, qm, ub2, cbox)
    *b, n, d = qs.shape
    d2, ids = skip_cuda.nn1_sorted_skip(qs.reshape(-1, n, d), qm.reshape(-1, n),
                                        rt, rpen, skip.reshape(-1, *skip.shape[-2:]))
    if telemetry.detail():
        telemetry.sample("skip_share", skip.to(torch.float32).mean(dim=(-2, -1)))
    return d2.reshape(*b, n), ids.reshape(*b, n)
