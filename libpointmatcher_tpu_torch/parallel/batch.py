"""Batched registration (counterpart of ``libpointmatcher_tpu.parallel.batch``):
scan-to-map serving, ``register_batch_to_map``, and pair-parallel one-shot
ICP, ``register_batch``.

The map of an ``ICPSequence`` is filtered, centred and given its matcher
tables once (``set_map``, then the first serving batch). Each batch of
scans then runs one lockstep loop against it (``ICP._run_loop``): every
scan's reading chain draws from its own key, ``fold_in(PRNGKey(seed), i)``
for scan i as in the JAX serving drivers, its filtered rows are
stacked into one ``[B, rows, d]`` cloud, and every kernel launch of an
iteration serves all B scans, which share the map. Three routes, picked
per map by the matcher (``KDTreeMatcher.serving_loop_aux``, or a
``BlockGridMatcher``):

- dense: one K1 launch per iteration over all scans' rows;
- survivor sweep (maps of 16 384 rows or more): each scan is put in its
  Morton order first, the loop runs against the Morton-sorted map, and
  each iteration makes one K2 launch and one K3, K4 or (knn 2..4) K6
  launch; under ``PMTPU_SKIP_V1=1`` (knn = 1, a resident map) one K11
  launch instead, after one K10 launch under ``PMTPU_SKIP_MXU_BOUND=1``.
  The device orders each scan's filtered rows; under
  ``PMTPU_SKIP_HOST_MORTON=1`` the batch (not the queue) orders its raw
  rows on the host instead, as the JAX package's switch does;
- tile sweep (``BlockGridMatcher`` with a reading chain that only masks
  rows): each scan's tile assignment is built on the host from its raw rows
  at its initial pose, the assignments are stacked and their candidate
  tables gathered on the device once, each scan is put in tile order, and
  each iteration makes one K7 launch (K8 for knn > 1) over the tiles of
  every scan.

``register_batch`` stacks the pairs' references as well as their readings
and runs the same loop, each reading against its own reference.
"""

from __future__ import annotations

import functools
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .. import telemetry
from ..cloud import PointCloud
from ..filters.base import ScanKeys, apply_filter_chain, chain_is_traceable
from ..icp import _apply_transform, _center_cloud
from ..loggers import log_warning
from ..matchers import (BlockGridMatcher, KDTreeMatcher, Matcher,
                        has_host_tables, tile_aux_to_device)
from ..ops.morton import morton_argsort_device
from ..utils import prng, se3
from .sharding import all_gather, all_reduce, shard_cloud

__all__ = ["register_batch", "register_batch_to_map", "PendingRegistration"]


def recorded(entry: str):
    """Decorator: the serving function ``entry(engine, readings, ...)``
    runs inside a telemetry call record on the engine's device."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(engine, readings, *args, **kwargs):
            with telemetry.call(entry, engine.device):
                return fn(engine, readings, *args, **kwargs)
        return run
    return wrap


class PendingRegistration:
    """Handle of a serving batch dispatched with ``block=False``: the
    loop's work is queued on the card, and ``result()`` makes the one
    synchronising copy of the poses and the info to the host, adding its
    ``finish`` span and host syncs to the dispatching call's telemetry
    record."""

    def __init__(self, finisher: Callable[[], tuple]):
        self._finisher = finisher
        self._record = telemetry.current()
        self._out = None

    def result(self) -> tuple:
        if self._out is None:
            with telemetry.resume(self._record):
                self._out = self._finisher()
            self._finisher = self._record = None
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


def _channels(c: PointCloud) -> tuple:
    return (tuple((k, v.shape[-1], v.dtype) for k, v in c.descriptors.items()),
            tuple((k, v.shape[-1]) for k, v in c.times.items()))


def _upload(readings: Sequence[PointCloud], dev) -> list:
    """Each scan's raw cloud on ``dev``. Where every scan lies in host
    memory with the same channels, their rows are padded and stacked in
    numpy and copied to ``dev`` once (one copy per field for the whole
    batch), each scan then a view of its rows of the stack; otherwise each
    scan is moved on its own. The values are the same either way
    (``chip_smoke.py`` phase 27 times both paths). The stack's rows are a
    multiple of 64, so that every view starts on an aligned address."""
    if not (all(rd.device.type == "cpu" for rd in readings)
            and len({_channels(rd) for rd in readings}) == 1):
        return [rd.to(dev) for rd in readings]
    first = readings[0]
    b, d = len(readings), first.dim
    rows = 64 * -(-max(rd.num_points for rd in readings) // 64)

    def zeros(t):
        return np.zeros((b, rows, t.shape[-1]), t.numpy().dtype)

    pts, mask = np.zeros((b, rows, d), np.float32), np.zeros((b, rows), bool)
    descs = {k: zeros(v) for k, v in first.descriptors.items()}
    times = {k: zeros(v) for k, v in first.times.items()}
    for i, rd in enumerate(readings):
        n = rd.num_points
        pts[i, :n], mask[i, :n] = rd.points.numpy(), rd.mask.numpy()
        for out, src in ((descs, rd.descriptors), (times, rd.times)):
            for k, v in src.items():
                out[k][i, :n] = v.numpy()
    stack = PointCloud(torch.from_numpy(pts), torch.from_numpy(mask),
                       {k: torch.from_numpy(v) for k, v in descs.items()},
                       {k: torch.from_numpy(v) for k, v in times.items()}).to(dev)
    out = []
    for i, rd in enumerate(readings):
        n = rd.num_points
        c = PointCloud(stack.points[i, :n], stack.mask[i, :n],
                       {k: v[i, :n] for k, v in stack.descriptors.items()},
                       {k: v[i, :n] for k, v in stack.times.items()})
        c._count_cache = rd._count_cache
        out.append(c)
    return out


def _initial_poses(T_inits, b: int, dim: int, dev) -> torch.Tensor:
    if T_inits is None:
        T_inits = [np.eye(dim + 1, dtype=np.float32)] * b
    telemetry.sync(torch.device(dev), b, copy=True)     # one copy a pose
    return torch.stack([torch.as_tensor(np.asarray(t, np.float32), device=dev)
                        for t in T_inits])


def _host_orders(seq, readings: Sequence[PointCloud], T_inits) -> list:
    """Each scan's Morton order (``PMTPU_SKIP_HOST_MORTON=1``), computed on
    the host by the matcher's ``prepare_loop_host_batch`` from the scan's
    raw rows and mask moved by Trm⁻¹·T_init in float64 and stored into
    float32, as the JAX package's batch computes it (its rows and scale,
    so another order than the device's, which sorts the filtered rows
    before the pre-transform) → one int64 order of the raw rows per scan."""
    dim = readings[0].dim
    rows = max(rd.num_points for rd in readings)
    trm_inv = np.linalg.inv(seq.trm_host())
    pts_b = np.zeros((len(readings), rows, dim), np.float32)
    mask_b = np.zeros((len(readings), rows), bool)
    for i, rd in enumerate(readings):
        pts, mask = rd.host_rows()
        T = trm_inv @ np.asarray(np.eye(dim + 1) if T_inits is None
                                 else T_inits[i], np.float64)
        pts_b[i, :len(pts)] = pts @ T[:dim, :dim].T + T[:dim, dim]
        mask_b[i, :len(pts)] = mask
    orders = seq.matcher.prepare_loop_host_batch(pts_b, mask_b)["qorder"]
    # the invalid rows sort last, in row order: a scan's first rows are
    # a permutation of its own
    return [torch.as_tensor(orders[i, :rd.num_points], dtype=torch.int64,
                            device=seq.device) for i, rd in enumerate(readings)]


def scan_keys(seed: int, count: int, rows: int, device) -> ScanKeys:
    """The serving drivers' chain keys: scan i's reading chain draws from
    ``fold_in(PRNGKey(seed), i)``, as in the JAX package's batch and queue
    (no stream is folded), formed for all scans at once over ``rows``."""
    base = prng.prng_key(seed)
    return ScanKeys([prng.fold_in(base, i) for i in range(count)], rows, device)


def _prep_scans(seq, readings: Sequence[PointCloud], T_rmd: torch.Tensor,
                seed: int, compact_rows, permute: bool, host_orders=None):
    """The serving prep of every scan: its reading chain (scan i's key
    from :func:`scan_keys`), the Morton order on the survivor route, the
    compaction cap, stacking and the pre-transform by ``T_rmd [B, d+1,
    d+1]`` → ``(batch [B, rows, d], overflow [B] bool numpy, cap)``, cap
    None when no scan is cut. With ``host_orders`` (:func:`_host_orders`),
    the chain keeps the raw rows, each scan is put in its host order and
    then compacted, which keeps that order; else the device orders the
    filtered rows."""
    span = telemetry.span
    dev = seq.device
    rows = max(rd.num_points for rd in readings)
    with span("prep.upload"):
        uploaded = _upload(readings, dev)
    with span("prep.chain"):
        keys = scan_keys(seed, len(readings), rows, dev)
        filtered = [apply_filter_chain(seq.reading_filters, rd, keys,
                                       scan=i, allow_empty=True,
                                       compact=host_orders is None,
                                       traced=_traceable(seq) and seq._fused())
                    for i, rd in enumerate(uploaded)]
    with span("prep.order"):
        keep_rate = filtered[0].count_host() / max(readings[0].count_host(), 1)
        cap = _serve_compact_cap(keep_rate, rows, compact_rows)
        prepped = []
        overflow = []
        for i, c in enumerate(filtered):
            if host_orders is not None:
                c = c.permute_rows(host_orders[i]).compact()
            elif permute:
                c = c.permute_rows(morton_argsort_device(c.points, c.mask))
            n = c.count_host()
            overflow.append(cap is not None and n > cap)
            if cap is not None and n > cap:
                c = PointCloud(c.points[:cap], c.mask[:cap],
                               {k: v[:cap] for k, v in c.descriptors.items()})
            prepped.append(c)
    with span("prep.stack"):
        # stacked at the cap when there is one, as the JAX package compacts
        # to it: a scan's rows, and with them every per-scan sum of the
        # loop, are then the same in any batch or queue that shares the cap
        batch = _apply_transform(seq.transformations,
                                 _stack(prepped, cap or 1), T_rmd)
    return batch, np.asarray(overflow, bool), cap


def _traceable(seq) -> bool:
    """True when every reading filter only masks rows (``TRACEABLE``), so
    that a table built from a scan's raw rows stays valid after the chain;
    the JAX package's serving program then runs the chain with no
    compaction between filters."""
    return chain_is_traceable(seq.reading_filters)


def _host_path(seq) -> bool:
    """True where the JAX package's batch takes its host path: a chain whose
    loop its serving program cannot hold (not ``seq._fused()``), or a
    matcher that builds per-registration state in ``prepare_loop`` with no
    per-scan serving form (``KDTreeVarDistMatcher``)."""
    m = seq.matcher
    return not seq._fused() or (type(m).prepare_loop is not Matcher.prepare_loop
                                and not has_host_tables(m))


def _tile_route(seq) -> bool:
    """True when the matcher serves through tile tables (a
    ``BlockGridMatcher`` with its map's sub-blocks) and the reading chain
    is :func:`_traceable`, so that the assignment built from the raw rows
    stays valid after it. Otherwise serving runs the matcher's dense
    fallback, as the JAX package's host path does."""
    m = seq.matcher
    return (getattr(m, "units", None) is not None
            and has_host_tables(m) and _traceable(seq))


def _pad_tile_aux_np(pers, sentinel: int) -> dict:
    """Align and stack per-scan host tile assignments (their tile and block
    counts differ) → ``[B, ...]`` numpy arrays.

    ``sentinel`` is the all-pad gather unit U, ``units.shape[0] − 1``:
    padded candidate slots point at it and read (+inf, −1). The JAX
    package's queue passes the sub-block count S instead, an index past
    the unit table that a JAX gather clamps to the last unit and a torch
    index refuses. Padded parent tiles carry −1 query rows; extra merge
    steps and padded ``vrows`` columns point at virtual tile
    ``max_tv − 1``, all-pad in every scan (``assign_tiles`` keeps at least
    one trailing all-pad virtual tile), a no-op merge. Padded virtual tiles
    have no live column (``ncols`` 0)."""
    b = len(pers)
    tq = pers[0]["q_rows"].shape[1]
    max_tp = max(p["q_rows"].shape[0] for p in pers)
    max_tv = max(p["blocks"].shape[0] for p in pers)
    max_b = max(p["blocks"].shape[1] for p in pers)
    max_k = max(p["vrows"].shape[0] for p in pers)
    q_rows = np.full((b, max_tp, tq), -1, np.int32)
    blocks = np.full((b, max_tv, max_b), sentinel, np.int32)
    parent = np.zeros((b, max_tv), np.int32)
    vrows = np.full((b, max_k, max_tp), max_tv - 1, np.int32)
    ncols = np.zeros((b, max_tv), np.int32)
    for i, p in enumerate(pers):
        tp = p["q_rows"].shape[0]
        tv, bb = p["blocks"].shape
        q_rows[i, :tp] = p["q_rows"]
        blocks[i, :tv, :bb] = p["blocks"]
        parent[i, :tv] = p["parent"]
        vrows[i, :p["vrows"].shape[0], :tp] = p["vrows"]
        ncols[i, :tv] = p["ncols"]
    return {"q_rows": q_rows, "blocks": blocks, "parent": parent,
            "vrows": vrows, "ncols": ncols}


def _prep_tile_scans(seq, readings: Sequence[PointCloud], T_inits,
                     T_rmd: torch.Tensor, seed: int):
    """The tile route's prep of every scan → ``(batch [B, Tp·TQ, d], aux)``.

    Each scan's assignment is built on the host, in a thread pool, from its
    raw rows and mask moved by its T_rmd in float64, the JAX package's
    data, so that tiles, virtual splits and the row order of the loop's
    sums are its own. The assignments are stacked, copied once, and their
    candidate tables gathered on the device. The reading chain runs without
    compaction (the assignment's row ids address raw rows), and each scan
    is then put in tile order: row t·TQ + r is tile t's query r, a padding
    slot a masked row. ``aux`` holds ``[B, ...]`` tables."""
    dev = seq.device
    dim = readings[0].dim
    matcher = seq.matcher
    trm_inv = np.linalg.inv(seq.trm_host())
    eye = np.eye(dim + 1)

    def assign(i):
        pts, mask = readings[i].host_rows()
        T = trm_inv @ np.asarray(eye if T_inits is None else T_inits[i],
                                 np.float64)
        return matcher.prepare_loop_host(pts @ T[:dim, :dim].T + T[:dim, dim],
                                         mask)

    span = telemetry.span
    with span("prep.order"):
        with ThreadPoolExecutor(max_workers=min(len(readings), 8)) as ex:
            pers = list(ex.map(assign, range(len(readings))))
        # the pairs each iteration sweeps: per scan, and summed for the batch
        matcher.touched_per_scan = [int(p["touched"]) for p in pers]
        matcher._loop_touched = sum(matcher.touched_per_scan)
        aux = tile_aux_to_device(
            _pad_tile_aux_np(pers, int(matcher.units.shape[0]) - 1),
            matcher.units)
        q_rows = aux.pop("q_rows").reshape(len(readings), -1)
    with span("prep.upload"):
        uploaded = _upload(readings, dev)
    with span("prep.chain"):
        # each scan's chain, then the scan in tile order
        scans = []
        keys = scan_keys(seed, len(readings),
                         max(rd.num_points for rd in readings), dev)
        for i, rd in enumerate(uploaded):
            c = apply_filter_chain(seq.reading_filters, rd, keys,
                                   scan=i, allow_empty=True, compact=False)
            safe = q_rows[i].clamp(min=0)
            scans.append(PointCloud(
                c.points[safe], (q_rows[i] >= 0) & c.mask[safe],
                {k: v[safe] for k, v in c.descriptors.items()}))
    with span("prep.stack"):
        return _apply_transform(seq.transformations, _stack(scans), T_rmd), aux


def _serving_route(seq, reference):
    """The matcher's route for this map → ``(permute, loop reference,
    aux)``: aux is None on the dense route."""
    if not seq.matcher.serving_loop_aux(reference):
        return False, reference, None
    return (seq.matcher.SERVING_PERMUTES_READING,
            seq.matcher.serving_reference(reference), seq.matcher.serving_aux())


def _info(iters, codes, stats, overflow=None, matcher=None) -> dict:
    """The serving functions' per-scan ``info`` on the host; with a
    tracked displacement bound, ``motion_bound_exceeded`` per scan (True
    where it passed the matcher's ``motionBound``: matches beyond the
    cells assigned at the initial pose may have been missed), logged."""
    telemetry.sync(iters.device, 5 + (stats.motion_max is not None))
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
    if stats.motion_max is not None:
        motion = stats.motion_max.cpu().numpy()
        bound = float(matcher.motionBound)
        exceeded = motion > bound
        info["motion_bound_exceeded"] = exceeded
        if exceeded.any():
            log_warning(f"{int(exceeded.sum())}/{len(exceeded)} scans exceeded "
                        f"motionBound {bound:.3f} (max displacement bound "
                        f"{float(motion.max()):.3f}): matches beyond the "
                        f"assigned cells may have been missed; raise "
                        f"motionBound or tighten the priors")
    return info


def _map_mesh(seq, mesh, map_axis: str) -> None:
    """Refuse a map mesh this rank or this matcher cannot serve."""
    mesh.require(map_axis)
    if not isinstance(seq.matcher, (KDTreeMatcher, BlockGridMatcher)):
        raise ValueError(f"{type(seq.matcher).__name__} serves no map laid out "
                         f"over a mesh (KDTreeMatcher and BlockGridMatcher do)")


@recorded("register_batch_to_map")
def register_batch_to_map(seq, readings: Sequence[PointCloud],
                          T_inits: Optional[Sequence] = None, seed: int = 0,
                          compact_rows="auto", mesh=None,
                          map_axis: str = "points", block: bool = True):
    """Register every scan of ``readings`` against the map of ``seq`` (an
    ``ICPSequence`` after ``set_map``) at once.

    Returns ``(T [B, d+1, d+1] numpy, info)``, or with ``block=False`` a
    :class:`PendingRegistration` whose ``result()`` gives the same. ``info``
    holds one entry per scan: ``iterations``, ``codes``,
    ``point_used_ratio``, ``weighted_point_used_ratio``, ``residual`` and
    ``compact_overflow`` (True where the scan's filtered rows exceeded the
    ``compact_rows`` capacity and were cut; never on the tile route, which
    keeps each scan's raw rows) and, on the tile route,
    ``motion_bound_exceeded``. A scan that its filters empty stops with the
    no-inliers code (4) instead of raising. ``seed`` seeds each scan's
    reading filters. On the tile route the matcher's ``touched_per_scan``
    holds each scan's swept pairs per iteration.

    A chain whose loop the JAX package's serving program cannot hold (a
    step filter without a schedule, or an inspector that dumps
    iterations), or a matcher with per-registration state and no per-scan
    serving form (``KDTreeVarDistMatcher``), takes the JAX package's host
    path (:func:`_host_path`): the scans' chains compacted without a cap,
    and the lockstep loop against the map without loop tables. As in the
    JAX package, that loop drops such step filters and makes no dumps, where
    a one-shot ``compute`` applies both.

    With ``mesh`` (:func:`.sharding.make_mesh`, on every rank of it, each
    holding every scan after the same ``set_map``), the map's rows are laid
    out over the mesh (``map_axis``, :func:`.sharding.shard_cloud`) and the
    loop holds only this rank's rows of it; every rank returns the same
    result, equal bit for bit to single-device serving where ties do not
    part them. The scans' prep, the outlier filters, the minimizer and the
    checkers run replicated. Matching runs on the dense route, as in the
    JAX package: each rank searches its rows (K1, K5 for knn > 1) and the
    ranks merge (:meth:`.sharding.ShardedCloud.knn`), against the
    Morton-sorted map with each scan in its Morton order where the
    single-device run takes a survivor route, so that rows and sums keep
    its order. A ``BlockGridMatcher`` keeps its tile route, each rank
    sweeping (K7, K8) the candidates it owns before the merge. Matched rows
    are read through ``minimizers.gather_rows``' sharded case. Only
    ``KDTreeMatcher`` and ``BlockGridMatcher`` take a mesh."""
    if not seq.has_map():
        raise RuntimeError("set_map first")
    seq._require_modules()
    if mesh is not None:
        _map_mesh(seq, mesh, map_axis)
    span = telemetry.span
    with span("prep"):
        reference = seq.get_prefiltered_internal_map()
        Trm = seq._T_refIn_refMean
        T_rmd = se3.inverse(Trm) @ _initial_poses(T_inits, len(readings),
                                                  readings[0].dim, seq.device)
        shard = ((lambda ref: ref) if mesh is None
                 else (lambda ref: shard_cloud(ref, mesh, map_axis)))
        if _host_path(seq):
            batch, overflow, _ = _prep_scans(seq, readings, T_rmd, seed, None,
                                             permute=False)
            ref_loop, aux = shard(reference), None
        elif _tile_route(seq):
            batch, aux = _prep_tile_scans(seq, readings, T_inits, T_rmd, seed)
            overflow = np.zeros(len(readings), bool)
            ref_loop = shard(reference)
            if mesh is not None:
                aux["cand_t"] = ref_loop.own_candidates(aux["cand_t"])
        else:
            permute, ref_loop, aux = _serving_route(seq, reference)
            if mesh is not None:
                ref_loop, aux = shard(ref_loop), None
            host = (permute and _traceable(seq)
                    and (not getattr(seq.matcher, "SERVING_DEVICE_ORDER", True)
                         or os.environ.get("PMTPU_SKIP_HOST_MORTON", "0") == "1"))
            orders = None
            if host:
                with span("prep.order"):
                    orders = _host_orders(seq, readings, T_inits)
            batch, overflow, _ = _prep_scans(seq, readings, T_rmd, seed,
                                             compact_rows, permute, orders)
    T_iter, iters, codes, stats = seq._run_loop(batch, ref_loop, aux)
    T_out = Trm @ T_iter @ T_rmd
    seq.last_stats = stats

    def finish():
        with span("finish"):
            telemetry.sync(T_out.device)
            return T_out.cpu().numpy(), _info(iters, codes, stats, overflow,
                                              seq.matcher)

    return finish() if block else PendingRegistration(finish)


def _gather_batch(mesh, values):
    """Every rank's ``[b/n, ...]`` tensors → the whole batch's, in rank
    order (one ``all_gather`` each)."""
    return [torch.cat(all_gather(mesh, v)) for v in values]


@recorded("register_batch")
def register_batch(icp, readings: Sequence[PointCloud],
                   references: Sequence[PointCloud],
                   T_inits: Optional[Sequence] = None, seed: int = 0,
                   mesh=None, axis_name: str = "pairs"):
    """Register ``readings[i]`` onto ``references[i]`` for every i at once
    (pair-parallel one-shot ICP, the counterpart of the JAX package's
    per-pair path of ``register_batch``).

    Per pair, as ``ICP.compute``: the reference chain and centring, the
    reading chain and the pre-transform; pair i's reading chain draws from
    ``fold_in(PRNGKey(seed), 2i)`` and its reference chain from
    ``fold_in(PRNGKey(seed), 2i + 1)``, as in the JAX package's per-pair
    path. Then one lockstep loop runs
    every pair, each reading against its own reference (one K1 launch per
    iteration for all pairs, with a pair axis), and each pose is composed
    back into its pair's frame. A filter that empties a cloud raises
    ``ConvergenceError``, as in ``ICP.compute``.

    Returns ``(T [B, d+1, d+1] numpy, info)`` with ``iterations``,
    ``codes``, ``point_used_ratio``, ``weighted_point_used_ratio`` and
    ``residual`` per pair.

    With ``mesh`` (:func:`.sharding.make_mesh`, on every rank of it, each
    holding every pair), the pair axis (``axis_name``) is split into
    contiguous blocks, one a rank (B must divide the mesh): each rank
    prepares and registers its own pairs, with the keys of their global
    indices, stacked at the whole batch's row counts (one
    ``all_reduce(MAX)``), and the poses, counts and statistics are
    gathered, so that every rank returns the whole batch's result."""
    if len(readings) != len(references) or not readings:
        raise ValueError("register_batch takes as many readings as "
                         "references, at least one")
    icp._require_modules()
    lo, hi = 0, len(readings)
    if mesh is not None:
        mesh.require(axis_name)
        if len(readings) % mesh.size:
            raise ValueError(f"{len(readings)} pairs do not divide the mesh "
                             f"({mesh.size})")
        lo, hi = mesh.span(len(readings))
    span = telemetry.span
    dev = icp.device
    dim = readings[0].dim
    with span("prep"):
        T_inits = _initial_poses(T_inits, len(readings), dim, dev)
        base = prng.prng_key(seed)
        keys_r, keys_f = (ScanKeys([prng.fold_in(base, 2 * i + side)
                                    for i in range(len(readings))],
                                   max(c.num_points for c in clouds), dev)
                          for side, clouds in ((0, readings), (1, references)))
        # both chains as the JAX package's one-program pair path runs them
        traced = (chain_is_traceable(icp.reading_filters)
                  and chain_is_traceable(icp.reference_filters)
                  and icp._step_chain_traced()
                  and type(icp.matcher).prepare_loop is Matcher.prepare_loop)
        prepped_r, prepped_f, T_rm, T_rmd = [], [], [], []
        with span("prep.chain"):
            for i in range(lo, hi):
                reading, reference = readings[i], references[i]
                reference = apply_filter_chain(icp.reference_filters,
                                               reference.to(dev), keys_f,
                                               scan=i, traced=traced)
                reference, Trm = _center_cloud(reference)
                Trd = se3.inverse(Trm) @ T_inits[i]
                reading = apply_filter_chain(icp.reading_filters,
                                             reading.to(dev), keys_r, scan=i,
                                             traced=traced)
                prepped_r.append(_apply_transform(icp.transformations, reading,
                                                  Trd))
                prepped_f.append(reference)
                T_rm.append(Trm)
                T_rmd.append(Trd)
        with span("prep.stack"):
            rows = [max(c.num_points for c in cl)
                    for cl in (prepped_r, prepped_f)]
            if mesh is not None:
                telemetry.sync(dev, copy=True)
                telemetry.sync(dev)
                rows = all_reduce(mesh, torch.tensor(rows, device=dev),
                                  "max").tolist()
            batch_r = _stack(prepped_r, rows[0])
            batch_f = _stack(prepped_f, rows[1])
    T_iter, iters, codes, stats = icp._run_loop(batch_r, batch_f)
    with span("finish"):
        T_out = torch.stack(T_rm) @ T_iter @ torch.stack(T_rmd)
        if mesh is not None:
            fields = ("point_used_ratio", "weighted_point_used_ratio",
                      "residual")
            if stats.covariance is not None:
                fields += ("covariance",)
            T_out, iters, codes, *vals = _gather_batch(
                mesh, [T_out, iters, codes] + [getattr(stats, f) for f in fields])
            stats = stats._replace(**dict(zip(fields, vals)))
        icp.last_stats = stats
        telemetry.sync(T_out.device)
        return T_out.cpu().numpy(), _info(iters, codes, stats)
