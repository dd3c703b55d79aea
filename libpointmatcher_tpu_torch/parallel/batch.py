"""Batched registration (counterpart of ``libpointmatcher_tpu.parallel.batch``):
scan-to-map serving, ``register_batch_to_map``, and pair-parallel one-shot
ICP, ``register_batch``.

The map of an ``ICPSequence`` is filtered, centred and given its matcher
tables once (``set_map``, then the first serving batch). Each batch of
scans then runs one lockstep loop against it (``ICP._run_loop``): every
scan's reading chain draws from its own generators, its filtered rows are
stacked into one ``[B, rows, d]`` cloud, and every kernel launch of an
iteration serves all B scans, which share the map. Two routes, picked per
map by the matcher (``KDTreeMatcher.serving_loop_aux``):

- dense: one K1 launch per iteration over all scans' rows;
- survivor sweep (maps of 16 384 rows or more): each scan is put in its
  Morton order first, the loop runs against the Morton-sorted map, and
  each iteration makes one K2 launch and one K3, K4 or (knn 2..4) K6
  launch.

``register_batch`` stacks the pairs' references as well as their readings
and runs the same loop, each reading against its own reference.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..cloud import PointCloud
from ..filters.base import apply_filter_chain
from ..icp import (READING_STREAM, REFERENCE_STREAM, _apply_transform,
                   _center_cloud)
from ..ops.morton import morton_argsort_device
from ..utils import se3

__all__ = ["register_batch", "register_batch_to_map", "PendingRegistration"]


class PendingRegistration:
    """Handle of a serving batch dispatched with ``block=False``: the
    loop's work is queued on the card, and ``result()`` makes the one
    synchronising copy of the poses and the info to the host."""

    def __init__(self, finisher: Callable[[], tuple]):
        self._finisher = finisher
        self._out = None

    def result(self) -> tuple:
        if self._out is None:
            self._out = self._finisher()
            self._finisher = None
        return self._out


def _serve_compact_cap(keep_rate: float, rows: int, compact_rows="auto"):
    """Row capacity of each filtered scan (None: no cap). "auto" scales the
    first scan's keep rate to the batch's stacked rows with 8% headroom
    and a 512-row granule, as the JAX package sizes it; an int pins it.
    Scans with more filtered rows are cut, and reported in
    ``info['compact_overflow']``."""
    cap = None
    if compact_rows == "auto":
        worst = keep_rate * rows
        cap = min(rows, 512 * -(-int(worst * 1.08 + 512) // 512))
    elif compact_rows:
        cap = min(int(compact_rows), rows)
    if cap is not None and cap >= rows:
        cap = None
    return cap


def _stack(clouds: Sequence[PointCloud], rows: int = 1) -> PointCloud:
    """Pad to a common row count, at least ``rows`` (padding rows masked),
    and stack."""
    rows = max(rows, max(c.num_points for c in clouds))
    names = list(clouds[0].descriptors)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))

    return PointCloud(
        torch.stack([pad(c.points) for c in clouds]),
        torch.stack([torch.nn.functional.pad(c.mask, (0, rows - c.num_points))
                     for c in clouds]),
        {k: torch.stack([pad(c.descriptors[k]) for c in clouds]) for k in names})


def _initial_poses(T_inits, b: int, dim: int, dev) -> torch.Tensor:
    if T_inits is None:
        T_inits = [np.eye(dim + 1, dtype=np.float32)] * b
    return torch.stack([torch.as_tensor(np.asarray(t, np.float32), device=dev)
                        for t in T_inits])


def _prep_scans(seq, readings: Sequence[PointCloud], T_rmd: torch.Tensor,
                seed: int, compact_rows, permute: bool):
    """The serving prep of every scan: its reading chain (scan i draws from
    its own generators), the Morton order on the survivor route, the
    compaction cap, stacking and the pre-transform by ``T_rmd [B, d+1,
    d+1]`` → ``(batch [B, rows, d], overflow [B] bool numpy, cap)``, cap
    None when no scan is cut."""
    dev = seq.device
    filtered = [apply_filter_chain(seq.reading_filters, rd.to(dev), seed,
                                   READING_STREAM, scan=i, allow_empty=True)
                for i, rd in enumerate(readings)]
    rows = max(rd.num_points for rd in readings)
    keep_rate = filtered[0].count_host() / max(readings[0].count_host(), 1)
    cap = _serve_compact_cap(keep_rate, rows, compact_rows)
    prepped = []
    overflow = []
    for c in filtered:
        if permute:
            c = c.permute_rows(morton_argsort_device(c.points, c.mask))
        n = c.count_host()
        overflow.append(cap is not None and n > cap)
        if cap is not None and n > cap:
            c = PointCloud(c.points[:cap], c.mask[:cap],
                           {k: v[:cap] for k, v in c.descriptors.items()})
        prepped.append(c)
    # stacked at the cap when there is one, as the JAX package compacts to
    # it: a scan's rows, and with them every per-scan sum of the loop, are
    # then the same in any batch or queue that shares the cap
    batch = _apply_transform(seq.transformations, _stack(prepped, cap or 1),
                             T_rmd)
    return batch, np.asarray(overflow, bool), cap


def _serving_route(seq, reference):
    """The matcher's route for this map → ``(permute, loop reference,
    aux)``: aux is None on the dense route."""
    if not seq.matcher.serving_loop_aux(reference):
        return False, reference, None
    seq.matcher.survivor_fractions = []
    return (seq.matcher.SERVING_PERMUTES_READING,
            seq.matcher.serving_reference(reference), seq.matcher.serving_aux())


def _info(iters, codes, stats, overflow=None) -> dict:
    """The serving functions' per-scan ``info`` on the host."""
    info = {
        "iterations": iters.cpu().numpy(),
        "codes": codes.cpu().numpy(),
        "point_used_ratio": stats.point_used_ratio.cpu().numpy(),
        "weighted_point_used_ratio":
            stats.weighted_point_used_ratio.cpu().numpy(),
        "residual": stats.residual.cpu().numpy(),
    }
    if overflow is not None:
        info["compact_overflow"] = overflow
    return info


def register_batch_to_map(seq, readings: Sequence[PointCloud],
                          T_inits: Optional[Sequence] = None, seed: int = 0,
                          compact_rows="auto", block: bool = True):
    """Register every scan of ``readings`` against the map of ``seq`` (an
    ``ICPSequence`` after ``set_map``) at once.

    Returns ``(T [B, d+1, d+1] numpy, info)``, or with ``block=False`` a
    :class:`PendingRegistration` whose ``result()`` gives the same. ``info``
    holds one entry per scan: ``iterations``, ``codes``,
    ``point_used_ratio``, ``weighted_point_used_ratio``, ``residual`` and
    ``compact_overflow`` (True where the scan's filtered rows exceeded the
    ``compact_rows`` capacity and were cut). A scan that its filters empty
    stops with the no-inliers code (4) instead of raising. ``seed`` seeds
    each scan's reading filters."""
    if not seq.has_map():
        raise RuntimeError("set_map first")
    seq._require_modules()
    reference = seq.get_prefiltered_internal_map()
    Trm = seq._T_refIn_refMean
    T_rmd = se3.inverse(Trm) @ _initial_poses(T_inits, len(readings),
                                              readings[0].dim, seq.device)
    permute, ref_loop, aux = _serving_route(seq, reference)
    batch, overflow, _ = _prep_scans(seq, readings, T_rmd, seed,
                                     compact_rows, permute)
    T_iter, iters, codes, stats = seq._run_loop(batch, ref_loop, aux)
    T_out = Trm @ T_iter @ T_rmd
    seq.last_stats = stats

    def finish():
        return T_out.cpu().numpy(), _info(iters, codes, stats, overflow)

    return finish() if block else PendingRegistration(finish)


def register_batch(icp, readings: Sequence[PointCloud],
                   references: Sequence[PointCloud],
                   T_inits: Optional[Sequence] = None, seed: int = 0):
    """Register ``readings[i]`` onto ``references[i]`` for every i at once
    (pair-parallel one-shot ICP, the counterpart of the JAX package's
    per-pair path of ``register_batch``).

    Per pair, as ``ICP.compute``: the reference chain and centring, the
    reading chain and the pre-transform; pair i's filters draw from
    generators of their own, seeded with i. Then one lockstep loop runs
    every pair, each reading against its own reference (one K1 launch per
    iteration for all pairs, with a pair axis), and each pose is composed
    back into its pair's frame. A filter that empties a cloud raises
    ``ConvergenceError``, as in ``ICP.compute``.

    Returns ``(T [B, d+1, d+1] numpy, info)`` with ``iterations``,
    ``codes``, ``point_used_ratio``, ``weighted_point_used_ratio`` and
    ``residual`` per pair."""
    if len(readings) != len(references) or not readings:
        raise ValueError("register_batch takes as many readings as "
                         "references, at least one")
    icp._require_modules()
    dev = icp.device
    dim = readings[0].dim
    T_inits = _initial_poses(T_inits, len(readings), dim, dev)
    prepped_r, prepped_f, T_rm, T_rmd = [], [], [], []
    for i, (reading, reference) in enumerate(zip(readings, references)):
        reference = apply_filter_chain(icp.reference_filters, reference.to(dev),
                                       seed, REFERENCE_STREAM, scan=i)
        reference, Trm = _center_cloud(reference)
        Trd = se3.inverse(Trm) @ T_inits[i]
        reading = apply_filter_chain(icp.reading_filters, reading.to(dev),
                                     seed, READING_STREAM, scan=i)
        prepped_r.append(_apply_transform(icp.transformations, reading, Trd))
        prepped_f.append(reference)
        T_rm.append(Trm)
        T_rmd.append(Trd)
    T_iter, iters, codes, stats = icp._run_loop(_stack(prepped_r),
                                                _stack(prepped_f))
    icp.last_stats = stats
    T_out = torch.stack(T_rm) @ T_iter @ torch.stack(T_rmd)
    return T_out.cpu().numpy(), _info(iters, codes, stats)
