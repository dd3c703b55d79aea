"""Continuous-batching scan-to-map serving, the queue (counterpart of
``libpointmatcher_tpu.parallel.stream``).

A lockstep batch runs every scan to the slowest one's stop. The queue does
not: the whole queue of Q prepped scans sits on the device as a pool, L
lanes step in lockstep (``ICP._run_queue``), and the moment a lane's
checkers stop, its scan's pose, iteration count, code and statistics go to
the scan's output slot and the next queued scan takes the lane, with its
loop state started afresh. Each scan thus costs its own iteration count.
The loop stays driven from the host, with one read of the ``[L]`` flags
per iteration, from which the swaps are decided.

Per scan the queue gives what ``register_batch_to_map`` gives: the same
prep (scan i's chain draws from ``fold_in(PRNGKey(seed), i)``, as the
batch's scan i does), and every per-scan quantity of a step is
independent of the other lanes (the sweep tiles never mix scans). On the tile route (``BlockGridMatcher``)
the pool also holds every scan's candidate tables, and a lane swap gathers
the new scan's tables and starts its displacement bound afresh.

Coarse-to-fine (``coarse=(decim, max_iter[, tol_mult])``): the reference's
graduated resolution (``FixStepSampling``'s schedule, reference:
ICP.cpp:373-379) as two queue passes in one frame. Pass 1 registers every
``decim``-th surviving row of each scan under the chain's checkers with the
counter capped at ``max_iter`` and the differential thresholds loosened
``tol_mult``-fold (2.0 by default); pass 2 runs the full-resolution loop
from each scan's pass-1 pose. ``info["iterations"]`` counts pass 2.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import telemetry
from ..checkers import (CounterTransformationChecker,
                        DifferentialTransformationChecker)
from ..cloud import PointCloud
from ..utils import se3
from .batch import (PendingRegistration, _host_path, _info, _initial_poses,
                    _prep_scans, _prep_tile_scans, _serving_route, _tile_route,
                    _traceable, recorded, register_batch_to_map)

__all__ = ["register_queue_to_map", "queue_eligible"]


def _queue_mode(seq) -> str:
    """Serving mode of the queue: ``"tile"`` (``BlockGridMatcher``'s
    per-scan tile tables, pooled and swapped with the lanes), ``"skip"``
    (the matcher's survivor-sweep loop state, built by ``serving_loop_aux``
    for the current map), ``"dense"`` (no matcher loop state), or ``""``
    when the chain asks for what the JAX package's queue program does not
    hold: a reading filter that is not ``TRACEABLE`` (it runs a host step
    per scan, as SamplingSurfaceNormal's median split does), an
    ``acceleration``, a step filter without a schedule, an inspector that
    dumps iterations, or a matcher that the batch serves on its host path
    (``KDTreeVarDistMatcher``). Such a chain serves through
    :func:`register_batch_to_map`, as in the JAX package. A step filter
    with a schedule (FixStepSampling) stays in the queue, each lane at its
    own iteration."""
    if seq.acceleration is not None or _host_path(seq):
        return ""
    if not _traceable(seq):
        return ""
    if _tile_route(seq):
        return "tile"
    if getattr(seq.matcher, "_skip_shared", None) is not None:
        return "skip"
    return "dense"


def queue_eligible(seq) -> bool:
    """True when the chain serves through the queue."""
    return bool(_queue_mode(seq))


@recorded("register_queue_to_map")
def register_queue_to_map(seq, readings: Sequence[PointCloud],
                          T_inits: Optional[Sequence] = None, seed: int = 0,
                          lanes: int = 8, compact_rows="auto",
                          coarse: Optional[Tuple] = None, block: bool = True):
    """Register a queue of readings against the map of ``seq`` (an
    ``ICPSequence`` after ``set_map``) with continuous batching over
    ``lanes`` lanes; ``coarse=(decim, max_iter[, tol_mult])`` adds the
    coarse pass (``decim`` < 2 disables it; the tile route ignores it, as
    the JAX package does: decimation and compaction would void its tile
    assignments).

    Returns ``(T [Q, d+1, d+1] numpy, info)`` exactly as
    :func:`register_batch_to_map` does, or a :class:`PendingRegistration`
    with ``block=False``; scans are matched by queue index, so scan i gets
    what a batch's scan i gets from the same ``seed``. An ineligible chain
    (see :func:`queue_eligible`) or an empty queue goes to
    :func:`register_batch_to_map`."""
    if not seq.has_map():
        raise RuntimeError("set_map first")
    seq._require_modules()
    reference = seq.get_prefiltered_internal_map()
    with telemetry.span("prep"):
        permute, ref_loop, aux = _serving_route(seq, reference)
        mode = _queue_mode(seq) if readings else ""
        if mode:
            q = len(readings)
            dim = readings[0].dim
            Trm = seq._T_refIn_refMean
            T_rmd = se3.inverse(Trm) @ _initial_poses(T_inits, q, dim,
                                                      seq.device)
            T0 = se3.identity(dim, seq.device).expand(q, dim + 1,
                                                      dim + 1).clone()
            coarse_pool = None
            if mode == "tile":
                pool, pool_aux = _prep_tile_scans(seq, readings, T_inits,
                                                  T_rmd, seed)
                overflow = np.zeros(q, bool)
            else:
                pool, overflow, cap = _prep_scans(seq, readings, T_rmd, seed,
                                                  compact_rows, permute)
                if coarse is not None and int(coarse[0]) >= 2:
                    decim, c_iters = int(coarse[0]), int(coarse[1])
                    tol_mult = float(coarse[2]) if len(coarse) > 2 else 2.0
                    base = (cap if cap is not None
                            else max(rd.num_points for rd in readings))
                    n_c = -(-base // decim)
                    cap_c = max(512, 512 * -(-n_c // 512))
                    coarse_pool = _compact_rows(_decimate_mask(pool, decim),
                                                cap_c)
    if not mode:
        return register_batch_to_map(seq, readings, T_inits, seed,
                                     compact_rows=compact_rows, block=block)
    if mode == "tile":
        T_iter, iters, codes, stats = seq._run_queue(
            pool, reference, T0, lanes, pool_aux=pool_aux)
    else:
        if coarse_pool is not None:
            T0, _, _, _ = seq._run_queue(
                coarse_pool, ref_loop, T0, lanes,
                _coarse_checkers(seq, c_iters, tol_mult), aux)
        T_iter, iters, codes, stats = seq._run_queue(pool, ref_loop, T0, lanes,
                                                     matcher_aux=aux)
    return _finish(seq, Trm @ T_iter @ T_rmd, iters, codes, stats, overflow,
                   block)


def _finish(seq, T_out, iters, codes, stats, overflow, block: bool):
    """``(T, info)`` on the host, or its :class:`PendingRegistration`."""
    seq.last_stats = stats

    def finish():
        with telemetry.span("finish"):
            telemetry.sync(T_out.device)
            return T_out.cpu().numpy(), _info(iters, codes, stats, overflow,
                                              seq.matcher)

    return finish() if block else PendingRegistration(finish)


def _decimate_mask(cloud: PointCloud, decim: int) -> PointCloud:
    """Keep every ``decim``-th valid row of each scan, in row order:
    FixStepSampling's step applied once (reference:
    DataPointsFilters/FixStepSampling.cpp). On the survivor route the rows
    are in Morton order, so the subsample stays spatially uniform."""
    rank = torch.cumsum(cloud.mask.to(torch.int64), dim=-1) - 1
    return cloud.with_mask(rank % decim == 0)


def _compact_rows(cloud: PointCloud, cap: int) -> PointCloud:
    """Each scan's valid rows packed to the front in their order, the batch
    cut to ``cap`` rows (which hold every valid row here)."""
    order = torch.argsort((~cloud.mask).to(torch.uint8), dim=-1,
                          stable=True)[..., :cap]

    def take(x):
        return torch.gather(x, -2, order[..., None].expand(*order.shape,
                                                            x.shape[-1]))

    return PointCloud(take(cloud.points), torch.gather(cloud.mask, -1, order),
                      {k: take(v) for k, v in cloud.descriptors.items()})


def _coarse_checkers(seq, c_iters: int, tol_mult: float = 2.0) -> list:
    """The coarse pass's stop rule: the chain's checkers with the counter
    capped at ``c_iters`` (one is added if the chain has none) and the
    differential thresholds loosened ``tol_mult``-fold, as the coarse
    subsample's pose noise is higher."""
    out = []
    has_counter = False
    for c in seq.checkers:
        if isinstance(c, CounterTransformationChecker):
            has_counter = True
            out.append(CounterTransformationChecker({
                "maxIterationCount": str(min(int(c.maxIterationCount),
                                             c_iters))}))
        elif isinstance(c, DifferentialTransformationChecker):
            out.append(DifferentialTransformationChecker({
                "minDiffRotErr": str(min(tol_mult * c.minDiffRotErr, 6.28)),
                "minDiffTransErr": str(tol_mult * c.minDiffTransErr),
                "smoothLength": str(c.smoothLength)}))
        else:
            out.append(c)
    if not has_counter:
        out.append(CounterTransformationChecker(
            {"maxIterationCount": str(c_iters)}))
    return out
