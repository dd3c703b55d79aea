"""Batched scan-to-map serving (counterpart of
``libpointmatcher_tpu.parallel.batch.register_batch_to_map``).

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
  each iteration makes one K2 launch and one K3 or K4 launch.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from ..cloud import PointCloud
from ..filters.base import apply_filter_chain
from ..icp import READING_STREAM, _apply_transform
from ..ops.morton import morton_argsort_device
from ..utils import se3

__all__ = ["register_batch_to_map", "PendingRegistration"]


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


def _stack(clouds: Sequence[PointCloud]) -> PointCloud:
    """Pad to a common row count (padding rows masked) and stack."""
    rows = max(1, max(c.num_points for c in clouds))
    names = list(clouds[0].descriptors)

    def pad(x):
        return torch.nn.functional.pad(x, (0, 0, 0, rows - x.shape[0]))

    return PointCloud(
        torch.stack([pad(c.points) for c in clouds]),
        torch.stack([torch.nn.functional.pad(c.mask, (0, rows - c.num_points))
                     for c in clouds]),
        {k: torch.stack([pad(c.descriptors[k]) for c in clouds]) for k in names})


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
    dev = seq.device
    b = len(readings)
    dim = readings[0].dim
    if T_inits is None:
        T_inits = [np.eye(dim + 1, dtype=np.float32)] * b
    T_inits = torch.stack([torch.as_tensor(t, dtype=torch.float32, device=dev)
                           for t in T_inits])
    Trm = seq._T_refIn_refMean
    T_rmd = se3.inverse(Trm) @ T_inits

    survivor = seq.matcher.serving_loop_aux(reference)
    permute = survivor and seq.matcher.SERVING_PERMUTES_READING
    filtered = [apply_filter_chain(seq.reading_filters, rd.to(dev), seed,
                                   READING_STREAM, scan=i)
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
    batch = _apply_transform(seq.transformations, _stack(prepped), T_rmd)
    if survivor:
        seq.matcher.survivor_fractions = []
        ref_loop = seq.matcher.serving_reference(reference)
        aux = seq.matcher.serving_aux()
    else:
        ref_loop, aux = reference, None
    T_iter, iters, codes, stats = seq._run_loop(batch, ref_loop, aux)
    T_out = Trm @ T_iter @ T_rmd
    seq.last_stats = stats

    def finish():
        info = {
            "iterations": iters.cpu().numpy(),
            "codes": codes.cpu().numpy(),
            "point_used_ratio": stats.point_used_ratio.cpu().numpy(),
            "weighted_point_used_ratio":
                stats.weighted_point_used_ratio.cpu().numpy(),
            "residual": stats.residual.cpu().numpy(),
            "compact_overflow": np.asarray(overflow, bool),
        }
        return T_out.cpu().numpy(), info

    return finish() if block else PendingRegistration(finish)
