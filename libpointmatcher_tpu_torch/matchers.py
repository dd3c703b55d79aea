"""Matchers: associate each reading point with its nearest reference points
(counterpart of ``libpointmatcher_tpu.matchers``; reference:
PointMatcher.h:470-494, MatchersImpl.{h,cpp}).

``KDTreeMatcher`` keeps the reference's name and parameters; it is served by
the exact dense search of :func:`.ops.dispatch.knn_search`, which launches
the K1, K9 or K5 kernel on the card. Matches are row-major ``[N, knn]``, or
``[B, N, knn]`` for a batch of scans, against one shared reference or, with
a reference ``[B, M, d]``, each scan against its own; invalid entries
carry dist = +inf, id = −1.

Serving (``parallel.register_batch_to_map``, ``register_queue_to_map``)
takes, on maps of 16 384 rows or more, the survivor-sweep route of
:mod:`.ops.sweep`: the serving loop runs against a Morton-sorted copy of
the map, and each iteration bounds every query's neighbour distance by the
one it had in the previous iteration, carried as matcher loop state. Two
opt-in switches of the JAX package take another route on a resident map
with knn = 1: ``PMTPU_SKIP_V1=1`` the predicated sweep of :mod:`.ops.skip`
(K11), and with it ``PMTPU_SKIP_MXU_BOUND=1`` its bound pass (K10).

``BlockGridMatcher`` serves bounded-radius matching through the tile sweep
of :mod:`.ops.tilesweep` (K7, or K8 for knn > 1): the map is cut into
sub-blocks at ``init``, and each registration's queries are tiled once at
loop start (:meth:`BlockGridMatcher.prepare_loop`).

``CellGridMatcher`` and ``KDTreeVarDistMatcher`` search through the cell
grid of :mod:`.ops.cellgrid` (plain torch gathers; the JAX package has no
kernel for it either): the first at its ``maxDist`` for any map, the second
at the reading's largest per-point radius on maps of ``CULL_MIN_MAP`` rows
or more, where it otherwise runs the dense search (K1, K5).
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .cloud import PointCloud
from .ops import skip, skip_cuda, sweep, sweep_cuda
from .ops.cellgrid import build_cell_grid, cell_knn
from .ops.dispatch import MXU_EPSILON_FLOOR, apply_max_dist, knn_search
from .ops.morton import morton_argsort, morton_argsort_batch
from .ops.tilesweep import (assign_tiles, bucket_size, build_sub_blocks,
                            gather_candidates, live_columns,
                            tile_knnk_from_candidates, tile_nn1_from_candidates)
from .registry import Param, Parametrizable, Registrar

__all__ = ["Matches", "Matcher", "NullMatcher", "KDTreeMatcher",
           "KDTreeVarDistMatcher", "CellGridMatcher", "BlockGridMatcher",
           "MatcherRegistrar", "tile_aux_to_device"]


class Matches(NamedTuple):
    """kNN result: squared distances and reference ids, both [N, knn]."""

    dists: torch.Tensor  # float32, +inf = invalid
    ids: torch.Tensor    # int32, -1 = invalid

    @property
    def knn(self) -> int:
        return self.dists.shape[1]


class Matcher(Parametrizable):
    """Interface (reference: PointMatcher.h:470-494)."""

    def __init__(self, params=None):
        super().__init__(params)
        self._reference: Optional[PointCloud] = None
        #: (query, candidate) pairs inspected, summed by the engine over
        #: the iterations it reports (the PointCountTouched statistic)
        self.visit_count = 0

    def init(self, reference: PointCloud, rows: Optional[int] = None) -> None:
        """Called by the engine with the filtered, centred reference.
        ``rows`` is the row count the JAX engine holds that reference at,
        for thresholds on the map's size: ``ICPSequence`` passes its map's
        (the valid count rounded up to 512); None means the one-shot
        engine's, the valid count's bucket (:func:`jax_rows`)."""
        self._reference = reference

    def find_closests(self, reading: PointCloud) -> Matches:
        """Match ``reading`` against the reference stored by :meth:`init`
        (reference: Matcher::findClosests)."""
        if self._reference is None:
            raise RuntimeError("matcher not initialized: call init first")
        return self.find_closests_in(reading, self._reference)

    def touched_per_iteration(self, reading: PointCloud,
                              reference: PointCloud) -> int:
        """The (query, candidate) pairs one search inspects (reference:
        MatchersImpl.cpp:86-101 counts its kd-tree visits): every valid
        reading row against every valid reference row for the dense
        search. Two host reads."""
        return reading.count_host() * reference.count_host()

    def get_visit_count(self) -> int:
        return self.visit_count

    def reset_visit_count(self) -> None:
        self.visit_count = 0

    def invalidate_loop_state(self) -> None:
        """Drop the per-registration tables of an earlier registration
        (the stepped driver searches without them). Default: none."""

    def find_closests_in(self, reading: PointCloud,
                         reference: PointCloud) -> Matches:
        raise NotImplementedError

    def prepare_loop(self, reading: PointCloud):
        """Called by the engine with the filtered, pre-transformed reading
        before the loop → the matcher's per-registration tables, passed to
        :meth:`find_closests_in` as ``aux``. Default: none."""
        return None

    #: True when serving must put each scan in its Morton order before the
    #: loop (the matcher's stateful route runs in sorted space)
    SERVING_PERMUTES_READING = False

    def serving_loop_aux(self, reference: PointCloud) -> bool:
        """Called once per serving batch with the map: True routes the
        serving loop through :meth:`find_closests_in_stateful` with the
        tables :meth:`serving_aux` returns. Default: no such route."""
        return False

    def serving_reference(self, reference: PointCloud) -> PointCloud:
        """The reference the serving loop runs against. Default:
        ``reference`` itself."""
        return reference

    def prepare_loop_host(self, pts, mask):
        """Host (numpy) tables of one scan's rows ``pts [n, d]`` at its
        initial pose, which the serving drivers stack, or None. Default:
        none; a matcher that overrides it serves from host tables
        (:func:`has_host_tables`)."""
        return None


MatcherRegistrar = Registrar("Matcher")


def has_host_tables(matcher: Matcher) -> bool:
    """True when ``matcher`` builds per-scan host tables for serving (it
    overrides :meth:`Matcher.prepare_loop_host`)."""
    return type(matcher).prepare_loop_host is not Matcher.prepare_loop_host


def jax_rows(reference: PointCloud, rows: Optional[int] = None) -> int:
    """``rows``, or the row count the JAX one-shot engine holds
    ``reference`` at: its valid count on the 1-1.5-2 bucket ladder."""
    return bucket_size(max(reference.count_host(), 1)) if rows is None else rows


def _dense_matches(reading, reference, knn: int, epsilon: float,
                   max_dist: float) -> Matches:
    """The exact dense search (K1, K9, K5) of every scan of ``reading``
    against a shared ``reference``, or with a reference ``[B, M, d]`` each
    scan against its own, ``max_dist`` applied. A reference laid out over a
    mesh (``parallel.sharding.ShardedCloud``) is searched on this rank's
    rows and merged over the mesh."""
    if getattr(reference, "mesh", None) is not None:
        b = reading.points.shape[:-2]
        dists, ids = reference.knn(reading.points.reshape(-1, reading.dim),
                                   reading.mask.reshape(-1), k=knn,
                                   epsilon=epsilon)
        return Matches(*apply_max_dist(dists.reshape(*b, -1, knn),
                                       ids.reshape(*b, -1, knn), max_dist))
    if reference.points.ndim == 3:
        dists, ids = knn_search(reading.points, reading.mask, reference.points,
                                reference.mask, k=knn, epsilon=epsilon)
        return Matches(*apply_max_dist(dists, ids, max_dist))
    b = reading.points.shape[:-2]
    dists, ids = knn_search(reading.points.reshape(-1, reading.dim),
                            reading.mask.reshape(-1), reference.points,
                            reference.mask, k=knn, epsilon=epsilon)
    return Matches(*apply_max_dist(dists.reshape(*b, -1, knn),
                                   ids.reshape(*b, -1, knn), max_dist))


@MatcherRegistrar.register
class NullMatcher(Matcher):
    """Does nothing, returns no valid matches (reference: MatchersImpl.cpp:40-52)."""

    def find_closests_in(self, reading, reference):
        n = reading.num_points
        return Matches(
            torch.full((n, 1), float("inf"), device=reading.device),
            torch.full((n, 1), -1, dtype=torch.int32, device=reading.device))

    def touched_per_iteration(self, reading, reference) -> int:
        return 0


@MatcherRegistrar.register
class KDTreeMatcher(Matcher):
    """Exact kNN matcher (reference: MatchersImpl.h:69-120 wraps libnabo)."""
    DESCRIPTION = """Exact kNN matcher (reference: MatchersImpl.h:69-120 wraps libnabo;
    here: MXU-tiled brute force, see module docstring)."""

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider", int, 1, min=1),
        # The docs are the JAX package's text, which list_modules prints
        # for both packages. The port's expansion-form kernel (K9) takes
        # over from ops.dispatch.MXU_EPSILON_FLOOR, not from 1e-5: below
        # that floor the port runs the exact kernel (K1).
        Param("epsilon", "approximation to use for the nearest-neighbor "
              "search: values >= 1e-5 opt into the MXU matmul-form kernel on "
              "TPU, whose only deviation is mis-ranking ~1e-6-relative "
              "distance ties — within the reference's (1+epsilon) contract "
              "above that floor, at ~2x throughput; values in [0, 1e-5) run "
              "the exact sweep (the magnitude is otherwise unused: the sweep "
              "inspects every candidate either way, so there is no "
              "work-vs-accuracy dial beyond the kernel choice; see "
              "ops/dispatch.knn_search)", float, 0.0, min=0.0),
        Param("searchType", "kd-tree search strategy in the reference "
              "(ignored: search is a tiled sweep)", int, 1, min=0, max=2),
        Param("maxDist", "maximum distance to consider for neighbors",
              float, "inf", min=0.0),
    )

    #: map rows (in the JAX package's 512-row granule) from which batch
    #: serving takes the survivor sweep by default
    SKIP_AUTO_MIN_MAP = 16384
    #: largest padded map the survivor sweep serves (K4 above
    #: ``ops.sweep.SKIP_MAX_MPAD``); larger maps go dense
    STREAM_MAX_MPAD = 131072
    #: queries per tile and 128-row chunks per super-chunk of the v1 route's
    #: skip flags (K11's own)
    SKIP_TILE_Q = skip_cuda.TILE_Q
    SKIP_GROUP = skip_cuda.GROUP
    SERVING_PERMUTES_READING = True
    #: the batch orders each scan on the device unless
    #: ``PMTPU_SKIP_HOST_MORTON=1`` asks for :meth:`prepare_loop_host_batch`
    SERVING_DEVICE_ORDER = True

    def __init__(self, params=None):
        super().__init__(params)
        self._skip_shared = None
        self._skip_for = None
        self._skip_sorted_ref = None
        self._skip_stream = False
        #: survivor share per serving iteration ([B] tensors), for diagnostics
        self.survivor_fractions = []
        #: skipped share of (tile, super-chunk) steps per v1 iteration ([B])
        self.skip_fractions = []

    def find_closests_in(self, reading, reference):
        return _dense_matches(reading, reference, self.knn,
                              float(self.epsilon), self.maxDist)

    # ---- survivor-sweep serving route (ops/sweep.py): the serving loop runs
    # in Morton-sorted space, the scans permuted once before the loop and the
    # map replaced by its sorted copy, so sorted ids index the loop's
    # reference directly.
    def serving_loop_aux(self, reference: PointCloud) -> bool:
        """Pick the route for a serving batch against ``reference`` and
        build the map's tables once per map. ``PMTPU_SERVE_SKIP`` = 0 / 1
        forces the dense / survivor route, ``auto`` (the default) takes the
        survivor route from ``SKIP_AUTO_MIN_MAP`` rows; ``PMTPU_SERVE_STREAM``
        = 0 keeps maps above ``ops.sweep.SKIP_MAX_MPAD`` rows dense. The
        row counts compared are the JAX package's (the valid count rounded
        up to 512), so a map takes the same route in both. knn 2..4 takes
        the top-k sweep (K6) only under an explicit ``PMTPU_SERVE_SKIP=1``
        and on a resident map (up to ``ops.sweep.SKIP_MAX_MPAD`` rows: K6
        has no streaming form); knn > 4, ε at or above the K9 floor and
        d > 3 go dense. A resident map with knn = 1 also gets the v1
        route's tables (``skip_rt``, ``skip_rpen``, ``skip_cbox``,
        ``skip_ra``), which ``PMTPU_SKIP_V1=1`` takes."""
        mode = os.environ.get("PMTPU_SERVE_SKIP", "auto")
        rows = 512 * math.ceil(max(reference.count_host(), 1) / 512)
        dense = (mode not in ("1", "auto")
                 or (mode == "auto"
                     and (rows < self.SKIP_AUTO_MIN_MAP or self.knn > 1))
                 or self.knn > sweep_cuda.SWEEPK_MAX
                 or float(self.epsilon) >= MXU_EPSILON_FLOOR
                 or reference.dim > 3)
        stream_ok = (os.environ.get("PMTPU_SERVE_STREAM", "auto") != "0"
                     and rows <= self.STREAM_MAX_MPAD and self.knn == 1)
        if dense or (rows > sweep.SKIP_MAX_MPAD and not stream_ok):
            self._skip_shared = None
            return False
        self._skip_stream = rows > sweep.SKIP_MAX_MPAD
        if self._skip_shared is not None and self._skip_for is reference:
            return True
        pts, mask = reference.host_rows()
        rorder, _ = morton_argsort(pts, mask)
        rs, rmask = pts[rorder], mask[rorder]
        tables = {"skip_rt3": sweep.chunked_ref_table(rs, rmask),
                  "skip_ct": sweep.chunk_summaries(rs, rmask)}
        if not self._skip_stream and self.knn == 1:
            m_pad = 128 * math.ceil(len(rs) / 128)
            tables["skip_rt"], tables["skip_rpen"] = skip.v1_tables(rs, rmask,
                                                                    m_pad)
            tables["skip_cbox"] = skip.chunk_bboxes(rs, rmask,
                                                    128 * self.SKIP_GROUP)
            tables["skip_ra"] = skip.augmented_ref_table(rs, rmask, m_pad)[0]
        dev = reference.device
        self._skip_shared = {k: torch.as_tensor(v, device=dev)
                             for k, v in tables.items()}
        self._skip_sorted_ref = reference.permute_rows(
            torch.as_tensor(rorder, dtype=torch.int64, device=dev))
        self._skip_for = reference
        return True

    def serving_reference(self, reference: PointCloud) -> PointCloud:
        """The loop's reference: the Morton-sorted map on the survivor
        route, else ``reference`` itself."""
        if self._skip_shared is None or self._skip_for is not reference:
            return reference
        return self._skip_sorted_ref

    def serving_aux(self) -> dict:
        """The map's tables for :meth:`find_closests_in_stateful`."""
        return dict(self._skip_shared)

    def prepare_loop_host(self, pts, mask):
        """Host: the Morton order of one scan's rows ``pts [n, d]`` (at its
        initial pose in the map's frame) → ``{"qorder": int32 [n]}``, or
        None off the survivor route."""
        if self._skip_shared is None:
            return None
        return {"qorder": morton_argsort(pts, mask)[0]}

    def prepare_loop_host_batch(self, pts_b, mask_b):
        """:meth:`prepare_loop_host` of a stack of scans ``pts_b [b, n, d]``
        in one pass → ``{"qorder": int32 [b, n]}`` (invalid rows last)."""
        if self._skip_shared is None:
            return None
        return {"qorder": morton_argsort_batch(pts_b, mask_b)}

    def loop_state_init(self, reading: PointCloud, aux):
        """Per-scan loop state: each query's position at the previous sweep
        and its squared distance to the winner (the k-th one for knn > 1)
        found there (+inf: no sweep yet, so iteration 0 bounds by the boxes
        alone)."""
        return (reading.points,
                torch.full(reading.mask.shape, float("inf"),
                           device=reading.device))

    def find_closests_in_stateful(self, reading: PointCloud, ref: PointCloud,
                                  aux, state):
        """Exact kNN through the survivor sweep → ``(Matches, state)``.
        ``reading`` is Morton-sorted and ``ref`` is the sorted map. The
        bound on each query's neighbour distance is carried from the
        previous sweep by the triangle inequality, d(q, w_prev) ≤
        d(q_prev, w_prev) + ‖q − q_prev‖, w_prev being a real map point,
        and inflated by 4 ulp for its own roundings. For knn > 1 the k
        previous winners are real points within the k-th distance of
        q_prev, so the same transport bounds the k-th distance now.

        Under ``PMTPU_SKIP_V1=1``, with knn = 1 and the v1 tables (a
        resident map), the v1 route serves instead: the squared bound,
        inflated by 4 ulp, tightened by K10 under ``PMTPU_SKIP_MXU_BOUND=1``,
        gives the skip flags, and K11 sweeps (:func:`.ops.skip.nn1_sorted_v1`).
        A streaming map or knn > 1 stays on the survivor sweep, as in the
        JAX package."""
        qs, qm = reading.points, reading.mask
        prev_pos, prev_d2 = state
        step = torch.sqrt(torch.sum((qs - prev_pos) ** 2, dim=-1))
        if (self.knn == 1 and "skip_rt" in aux
                and os.environ.get("PMTPU_SKIP_V1", "0") == "1"):
            ub = torch.sqrt(prev_d2) + step          # inf-safe
            mxu = os.environ.get("PMTPU_SKIP_MXU_BOUND", "0") == "1"
            d_s, i_s, frac = skip.nn1_sorted_v1(
                qs, qm, (ub * ub) * sweep.UP, aux["skip_rt"], aux["skip_rpen"],
                aux["skip_cbox"], aux["skip_ra"] if mxu else None)
            self.skip_fractions.append(frac)
            matches = apply_max_dist(d_s[..., None], i_s[..., None], self.maxDist)
            return Matches(*matches), (qs, d_s)
        ub_t = (torch.sqrt(prev_d2) + step) * sweep.UP
        if self.knn > 1:
            dk, ik, frac = sweep.nnk_sorted_v2(qs, qm, ub_t, aux["skip_rt3"],
                                               aux["skip_ct"], int(self.knn))
            self.survivor_fractions.append(frac)
            return (Matches(*apply_max_dist(dk, ik, self.maxDist)),
                    (qs, dk[..., -1]))
        d_s, i_s, frac = sweep.nn1_sorted_v2(qs, qm, ub_t, aux["skip_rt3"],
                                             aux["skip_ct"],
                                             stream=self._skip_stream)
        self.survivor_fractions.append(frac)
        matches = apply_max_dist(d_s[..., None], i_s[..., None], self.maxDist)
        return Matches(*matches), (qs, d_s)


@MatcherRegistrar.register
class KDTreeVarDistMatcher(Matcher):
    """kNN with a per-point maximum radius taken from a reading descriptor
    (reference: MatchersImpl.cpp:132-150).

    Large maps get the reference's kd-tree efficiency back through the
    cell grid: ``prepare_loop`` reads the per-point radii once per
    registration (they are loop-static — filters only run in prep),
    builds a cell structure on the host at the GLOBAL max radius, and the
    per-iteration search touches only candidate cells; each point's own
    tighter radius is applied as the exact post-mask, so results match
    the dense sweep bit for bit. Small maps keep the dense sweep (the
    grid build would cost more than it saves)."""
    # On a map of ``CULL_MIN_MAP`` rows or more (counted as the JAX engine
    # holds it, see :meth:`Matcher.init`), :meth:`prepare_loop` builds the
    # cell grid at the radii's maximum, rounded up on a 1.25 ladder so that
    # scans with similar radii share a grid; else the search is the dense one
    # (K1, or K5 for knn > 1). The grid is matcher state, as in the JAX
    # package: a driver that does not call :meth:`prepare_loop` (the batch's
    # host path) searches with whatever grid the last registration left, and
    # the stepped driver drops it (:meth:`invalidate_loop_state`).

    #: map rows from which the cell grid serves (the JAX package's rows)
    CULL_MIN_MAP = 16384

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider", int, 1, min=1),
        Param("epsilon", "approximation to use for the nearest-neighbor search "
              "(accepted for config parity; search here is always exact)",
              float, 0.0, min=0.0),
        Param("searchType", "kd-tree search strategy in the reference "
              "(ignored: search is a tiled exact sweep)", int, 1, min=0, max=2),
        Param("maxDistField", "descriptor name holding the per-point max "
              "search radius", str, "maxSearchDist"),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self._ref_host = None
        self._ref_shape = None
        self._vd_grid = None
        self._vd_rmax = None
        self._vd_ref_shape = None

    def init(self, reference: PointCloud, rows: Optional[int] = None) -> None:
        """Keep the map's host rows when it is large enough for the grid;
        the same content initialised again keeps the grid it has."""
        super().init(reference, rows)
        self._ref_shape = tuple(reference.points.shape)
        if jax_rows(reference, rows) >= self.CULL_MIN_MAP:
            pts, mask = reference.host_rows()
            if (self._ref_host is not None
                    and self._ref_host[0].shape == pts.shape
                    and np.array_equal(self._ref_host[0], pts)
                    and np.array_equal(self._ref_host[1], mask)):
                return
            self._ref_host = (pts, mask)
        else:
            self._ref_host = None
        self._vd_grid = self._vd_rmax = self._vd_ref_shape = None

    def prepare_loop(self, reading: PointCloud):
        """Host, once per registration: the grid over the map at the
        reading's largest valid radius, rounded up to a power of 1.25
        (cached while that edge stays the same); dropped when the map is
        small, the reading has no radius or no positive finite one. Returns
        None: the search reads the grid from the matcher."""
        if self._ref_host is None or not reading.has_descriptor(self.maxDistField):
            self._drop_vd_grid()
            return None
        radius = torch.where(reading.mask,
                             reading.get_descriptor(self.maxDistField)[..., 0], 0.0)
        rmax = max(float(radius.max()), 0.0) if radius.numel() else 0.0
        if not math.isfinite(rmax) or rmax <= 0.0:
            self._drop_vd_grid()
            return None
        rq = 1.25 ** math.ceil(math.log(rmax, 1.25) - 1e-9)
        if self._vd_grid is not None and self._vd_rmax == rq:
            return None
        self._vd_grid = build_cell_grid(*self._ref_host, rq,
                                        device=self._reference.device)
        self._vd_rmax = rq
        self._vd_ref_shape = self._ref_shape
        return None

    def _drop_vd_grid(self) -> None:
        self._vd_grid = self._vd_rmax = self._vd_ref_shape = None

    def invalidate_loop_state(self) -> None:
        """The stepped driver does not call :meth:`prepare_loop`: drop the
        grid an earlier registration built at its own reading's radii."""
        self._drop_vd_grid()

    def find_closests_in(self, reading, reference, aux=None) -> Matches:
        """The grid's search when it was built for a reference of this
        shape, else the dense one; then each query's own radius."""
        radius = reading.get_descriptor(self.maxDistField)[..., 0]
        if (self._vd_grid is not None
                and tuple(reference.points.shape) == self._vd_ref_shape):
            m = Matches(*cell_knn(reading.points, reading.mask, reference.points,
                                  self._vd_grid, float(self._vd_rmax), self.knn))
        else:
            m = _dense_matches(reading, reference, self.knn, 0.0, float("inf"))
        keep = m.dists <= (radius * radius)[..., None]
        return Matches(torch.where(keep, m.dists, float("inf")),
                       torch.where(keep, m.ids, -1))


@MatcherRegistrar.register
class CellGridMatcher(Matcher):
    """Bounded-radius kNN via a cell list — the large-cloud matcher
    (extension beyond the reference registry; see ops/cellgrid.py).

    Requires a finite ``maxDist``: correctness within the radius is exact,
    points with no reference neighbor inside it get (+inf, -1) — the same
    contract as KDTreeMatcher with maxDist. Use when clouds are big enough
    (≳10⁵ after filtering) that the dense sweep's O(N·M) loses to culling."""
    # each query gathers the 3^d cells around its own; against a reference of
    # another shape than the one of ``init`` the search is the dense one,
    # with ``maxDist`` applied

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider", int, 1, min=1),
        Param("maxDist", "maximum distance to consider for neighbors "
              "(required finite; also the cell edge length)", float, 1.0,
              min=0.0000001),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self.grid = None
        self._grid_shape = None
        self._host_cells = None

    def init(self, reference: PointCloud, rows: Optional[int] = None) -> None:
        """Build the grid over the map, and a host copy of its cells'
        occupancy for :meth:`touched_per_iteration`."""
        super().init(reference, rows)
        pts, mask = reference.host_rows()
        cell = float(self.maxDist)
        self.grid = build_cell_grid(pts, mask, cell, device=reference.device)
        self._grid_shape = tuple(reference.points.shape)
        p = np.asarray(pts, np.float64)
        valid = np.asarray(mask, bool)
        vp = p[valid] if valid.any() else np.zeros((1, p.shape[1]))
        origin = vp.min(axis=0)
        lin, dims = _cell_index(np.floor((vp - origin) / cell).astype(np.int64),
                                None)
        ulins, counts = np.unique(lin, return_counts=True)
        self._host_cells = (origin, dims, ulins, counts)

    def find_closests_in(self, reading, reference, aux=None) -> Matches:
        if self.grid is None or tuple(reference.points.shape) != self._grid_shape:
            return _dense_matches(reading, reference, self.knn, 0.0,
                                  float(self.maxDist))
        return Matches(*cell_knn(reading.points, reading.mask, reference.points,
                                 self.grid, float(self.maxDist), self.knn))

    def touched_per_iteration(self, reading, reference) -> int:
        """The candidates each valid query inspects, summed: the occupancy
        of its 3^d cells, at the reading's current host rows (the loop-start
        positions in the engine)."""
        if self._host_cells is None:
            return super().touched_per_iteration(reading, reference)
        origin, dims, ulins, counts = self._host_cells
        pts, mask = reading.host_rows()
        q = np.asarray(pts, np.float64)[np.asarray(mask, bool)]
        if len(q) == 0:
            return 0
        d = q.shape[-1]
        qc = np.floor((q - origin) / float(self.maxDist)).astype(np.int64)
        offs = np.stack(np.meshgrid(*([[-1, 0, 1]] * d), indexing="ij"),
                        axis=-1).reshape(-1, d)
        nc = qc[:, None, :] + offs[None, :, :]
        in_grid = np.all((nc >= 0) & (nc < dims), axis=-1)
        lin, _ = _cell_index(nc, dims)
        pos = np.clip(np.searchsorted(ulins, lin), 0, max(len(ulins) - 1, 0))
        hit = in_grid & (len(ulins) > 0) & (ulins[pos] == lin)
        return int(np.where(hit, counts[pos], 0).sum())


def _cell_index(coords: np.ndarray, dims):
    """Linear cell index of integer cell coordinates [..., d], the first
    axis fastest → ``(lin, dims)``; ``dims`` None takes the coordinates'
    extent."""
    if dims is None:
        dims = coords.max(axis=0) + 1
    lin = coords[..., 0].copy()
    stride = int(dims[0])
    for a in range(1, coords.shape[-1]):
        lin += coords[..., a] * stride
        stride *= int(dims[a])
    return lin, dims


def tile_aux_to_device(per_scan: dict, units: torch.Tensor) -> dict:
    """A tile assignment in host form (numpy ``q_rows``, ``blocks``,
    ``parent``, ``vrows``, ``ncols``, of one scan or stacked ``[B, ...]``)
    → the tables :meth:`BlockGridMatcher.find_closests_in` takes, on the
    device of ``units``: the candidate tables gathered once from the map's
    sub-block units, each parent's virtual tiles ``vrows`` and their live
    columns ``ncols`` (int32; ``parent`` stays on the host: the kernels
    read ``vrows``). ``q_rows`` is kept only if given (the serving drivers
    consume it by putting each scan in tile order)."""
    dev = units.device
    t = lambda a, dt: torch.as_tensor(a, device=dev).to(dt)
    aux = {"cand_t": gather_candidates(units, t(per_scan["blocks"], torch.long)),
           "vrows": t(per_scan["vrows"], torch.int32),
           "ncols": t(per_scan["ncols"], torch.int32)}
    if "q_rows" in per_scan:
        aux["q_rows"] = t(per_scan["q_rows"], torch.long)
    return aux


@MatcherRegistrar.register
class BlockGridMatcher(Matcher):
    """Bounded-radius k-NN (k ≤ 32) through the tile sweep (an extension
    beyond the reference registry, as in the JAX package; see
    ops/tilesweep.py). The map is cut into 8-row sub-blocks at ``init`` and
    each registration's queries are tiled once at loop start
    (:meth:`prepare_loop`); every iteration is then one K7 launch (knn = 1)
    or one K8 launch (knn > 1) over all tiles. Exactness across the moving
    loop rests on the cell edge ``maxDist + motionBound``: as long as no
    reading point moves farther than ``motionBound`` from its loop-entry
    pose, the 3^d cells around its own cover its ``maxDist`` ball. The
    engine tracks a bound on that displacement and reports a violation
    (``ICP.motion_bound_exceeded``, the serving ``info`` entry). Points
    with no neighbour within ``maxDist`` get (+inf, −1), the contract of
    ``KDTreeMatcher`` with ``maxDist`` (reference: MatchersImpl.cpp:78-150).
    """
    DESCRIPTION = """Bounded-radius k-NN (k ≤ 16) via the tile sweep — the large-cloud /
    serving matcher built for the fused loop (extension beyond the
    reference registry; see ops/tilesweep.py for the design and
    ops/cellblocks.py for the earlier per-cell-padded variant it
    supersedes). knn is a free parameter like the reference matcher
    contract (MatchersImpl.h:69-120); k = 1 runs the running-min kernel,
    k > 1 the running-top-k kernel at ~k× the per-cell cost.

    Unlike :class:`CellGridMatcher` (per-point neighbor gathers, measured
    random-gather-bound on TPU), this matcher does dense tile sweeps with
    shapes fixed per registration: the reference is cell-sorted into
    8-row sub-blocks at ``init`` and queries are tiled once at loop start
    via the engine's :meth:`prepare_loop` hook. Exactness across the
    moving loop relies on the cell edge being ``maxDist + motionBound``:
    as long as no point moves farther than ``motionBound`` from its
    initial pose during the registration, the 3^d neighborhood always
    covers the true ``maxDist`` ball. Set ``motionBound`` to an upper
    bound on the expected ICP correction (prior error), e.g. the
    BoundTransformationChecker budget. Points with no neighbor inside
    ``maxDist`` get (+inf, -1) — the same contract as ``KDTreeMatcher``
    with ``maxDist`` (reference: MatchersImpl.cpp:78-150)."""

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider (the tile "
              "sweep serves k<=32 fused; per-iteration cost grows ~k)",
              int, 1, min=1, max=32),
        Param("maxDist", "maximum distance to consider for neighbors "
              "(required finite)", float, 1.0, min=0.0000001),
        Param("motionBound", "upper bound on how far any reading point "
              "moves during one registration (cell edge = maxDist + "
              "motionBound)", float, 1.0, min=0.0),
        Param("tileQueries", "queries per sweep tile (spatially coherent "
              "Morton groups; smaller tiles shrink candidate unions, "
              "larger tiles amortize per-step issue overhead)",
              int, 256, min=8),
        Param("blockCap", "candidate rows per virtual tile: tiles whose "
              "candidate union exceeds this are split, bounding the "
              "padded sweep at ceil(union/cap)*cap instead of the global "
              "max union (see ops/tilesweep.py)", int, 1024, min=128),
    )

    def __init__(self, params=None):
        super().__init__(params)
        self._blocks = None
        #: the map's sub-block units on its device (None before init)
        self.units: Optional[torch.Tensor] = None
        self._ref_shape = None
        #: the pairs the last tile assignment sweeps per iteration (one
        #: scan's, or the sum over a serving batch's scans); None when the
        #: search runs dense
        self._loop_touched: Optional[int] = None
        #: the serving batch's per-scan tile pairs, in scan order
        self.touched_per_scan: list = []

    @property
    def cell_size(self) -> float:
        return float(self.maxDist) + float(self.motionBound)

    def init(self, reference: PointCloud, rows: Optional[int] = None) -> None:
        """Cut the (filtered, centred) reference into sub-blocks."""
        super().init(reference, rows)
        pts, mask = reference.host_rows()
        self._blocks = build_sub_blocks(pts, mask, self.cell_size)
        self.units = torch.as_tensor(self._blocks.units, device=reference.device)
        self._ref_shape = tuple(reference.points.shape)

    def prepare_loop(self, reading: PointCloud):
        """The reading's tile assignment and candidate tables (one scan)."""
        self._loop_touched = None
        if self._blocks is None:
            return None
        pts, mask = reading.host_rows()
        per_scan = self.prepare_loop_host(pts, mask)
        self._loop_touched = per_scan["touched"]
        return tile_aux_to_device(per_scan, self.units)

    def invalidate_loop_state(self) -> None:
        self._loop_touched = None

    def touched_per_iteration(self, reading, reference) -> int:
        """The tile assignment's pairs (its candidates per query, summed)
        when the search runs through one, else the dense count."""
        if self._loop_touched is not None:
            return self._loop_touched
        return super().touched_per_iteration(reading, reference)

    def prepare_loop_host(self, pts, mask, pad_tiles_to: int = 0,
                          pad_blocks_to: int = 0) -> dict:
        """The tile assignment of host rows ``pts`` [N, d] in host form
        (numpy ``q_rows``, ``blocks``, ``parent``, ``vrows`` and each
        virtual tile's live columns ``ncols``, and the int ``touched``,
        its (query, candidate) pairs): the serving drivers build one per
        scan, stack them and make one copy."""
        ta = assign_tiles(pts, mask, self._blocks, tile_q=int(self.tileQueries),
                          pad_tiles_to=pad_tiles_to,
                          pad_blocks_to=pad_blocks_to,
                          block_cap=int(self.blockCap))
        return {"q_rows": ta.q_rows, "blocks": ta.blocks,
                "parent": ta.parent, "vrows": ta.vrows,
                "ncols": live_columns(ta.blocks, len(self._blocks.units) - 1),
                "touched": ta.touched}

    def find_closests_in(self, reading, reference, aux=None) -> Matches:
        """Through the tile sweep with ``aux`` (:meth:`prepare_loop`'s, or
        a serving driver's for readings in tile order, without ``q_rows``)
        against the reference of ``init``; else the exact dense search with
        ``maxDist`` applied. Against a reference laid out over a mesh
        (``parallel.sharding.ShardedCloud``), ``aux``'s candidate tables hold
        only this rank's rows (``ShardedCloud.own_candidates``), and the
        ranks' results are merged over the mesh."""
        sharded = getattr(reference, "mesh", None) is not None
        if aux is not None and (sharded or tuple(reference.points.shape)
                                == self._ref_shape):
            q_rows = aux.get("q_rows")
            if self.knn > 1:
                d, i = tile_knnk_from_candidates(
                    reading.points, reading.mask, q_rows, aux["cand_t"],
                    float(self.maxDist), None, aux["vrows"], int(self.knn),
                    aux["ncols"])
            else:
                d, i = tile_nn1_from_candidates(
                    reading.points, reading.mask, q_rows, aux["cand_t"],
                    float(self.maxDist), None, aux["vrows"], aux["ncols"])
                d, i = d[..., None], i[..., None]
            return Matches(*(reference.merge(d, i) if sharded else (d, i)))
        return _dense_matches(reading, reference, self.knn, 0.0, self.maxDist)
