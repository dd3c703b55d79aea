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
one it had in the previous iteration, carried as matcher loop state.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .cloud import PointCloud
from .ops import sweep, sweep_cuda
from .ops.dispatch import MXU_EPSILON_FLOOR, knn_search
from .ops.morton import morton_argsort
from .registry import Param, Parametrizable, Registrar

__all__ = ["Matches", "Matcher", "NullMatcher", "KDTreeMatcher",
           "MatcherRegistrar"]


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

    def init(self, reference: PointCloud) -> None:
        """Called by the engine with the filtered, centred reference."""
        self._reference = reference

    def find_closests_in(self, reading: PointCloud,
                         reference: PointCloud) -> Matches:
        raise NotImplementedError

    #: True when serving must put each scan in its Morton order before the
    #: loop (the matcher's stateful route runs in sorted space)
    SERVING_PERMUTES_READING = False

    def serving_loop_aux(self, reference: PointCloud) -> bool:
        """Called once per serving batch with the map: True routes the
        serving loop through :meth:`find_closests_in_stateful` with the
        tables :meth:`serving_aux` returns. Default: no such route."""
        return False


MatcherRegistrar = Registrar("Matcher")


@MatcherRegistrar.register
class NullMatcher(Matcher):
    """Returns no valid match (reference: MatchersImpl.cpp:40-52)."""

    def find_closests_in(self, reading, reference):
        n = reading.num_points
        return Matches(
            torch.full((n, 1), float("inf"), device=reading.device),
            torch.full((n, 1), -1, dtype=torch.int32, device=reading.device))


@MatcherRegistrar.register
class KDTreeMatcher(Matcher):
    """Exact kNN matcher (reference: MatchersImpl.h:69-120 wraps libnabo)."""

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider", int, 1, min=1),
        Param("epsilon", "approximation to use for the nearest-neighbor "
              "search: values >= ops.dispatch.MXU_EPSILON_FLOOR select the "
              "expansion-form kernel (K9), whose only deviation is "
              "mis-ranking near-equal distances, within the reference's "
              "(1+epsilon) contract above that floor; smaller values run "
              "the exact kernel", float, 0.0, min=0.0),
        Param("searchType", "kd-tree search strategy in the reference "
              "(ignored: the search is a dense sweep)", int, 1, min=0, max=2),
        Param("maxDist", "maximum distance to consider for neighbors",
              float, "inf", min=0.0),
    )

    #: map rows (in the JAX package's 512-row granule) from which batch
    #: serving takes the survivor sweep by default
    SKIP_AUTO_MIN_MAP = 16384
    #: largest padded map the survivor sweep serves (K4 above
    #: ``ops.sweep.SKIP_MAX_MPAD``); larger maps go dense
    STREAM_MAX_MPAD = 131072
    SERVING_PERMUTES_READING = True

    def __init__(self, params=None):
        super().__init__(params)
        self._skip_shared = None
        self._skip_for = None
        self._skip_sorted_ref = None
        self._skip_stream = False
        #: survivor share per serving iteration ([B] tensors), for diagnostics
        self.survivor_fractions = []

    def find_closests_in(self, reading, reference):
        if reference.points.ndim == 3:      # one reference per scan
            dists, ids = knn_search(reading.points, reading.mask,
                                    reference.points, reference.mask,
                                    k=self.knn, epsilon=float(self.epsilon))
            return self._apply_max_dist(Matches(dists, ids))
        b = reading.points.shape[:-2]
        dists, ids = knn_search(reading.points.reshape(-1, reading.dim),
                                reading.mask.reshape(-1),
                                reference.points, reference.mask, k=self.knn,
                                epsilon=float(self.epsilon))
        matches = Matches(dists.reshape(*b, -1, self.knn),
                          ids.reshape(*b, -1, self.knn))
        return self._apply_max_dist(matches)

    def _apply_max_dist(self, m: Matches) -> Matches:
        if self.maxDist == float("inf"):
            return m
        limit = float(np.float32(self.maxDist) * np.float32(self.maxDist))
        keep = m.dists <= limit
        return Matches(torch.where(keep, m.dists, torch.full_like(m.dists, float("inf"))),
                       torch.where(keep, m.ids, torch.full_like(m.ids, -1)))

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
        d > 3 go dense."""
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
        dev = reference.device
        self._skip_shared = {
            "skip_rt3": torch.as_tensor(sweep.chunked_ref_table(rs, rmask),
                                        device=dev),
            "skip_ct": torch.as_tensor(sweep.chunk_summaries(rs, rmask),
                                       device=dev),
        }
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
        q_prev, so the same transport bounds the k-th distance now."""
        qs, qm = reading.points, reading.mask
        prev_pos, prev_d2 = state
        step = torch.sqrt(torch.sum((qs - prev_pos) ** 2, dim=-1))
        ub_t = (torch.sqrt(prev_d2) + step) * sweep.UP
        if self.knn > 1:
            dk, ik, frac = sweep.nnk_sorted_v2(qs, qm, ub_t, aux["skip_rt3"],
                                               aux["skip_ct"], int(self.knn))
            self.survivor_fractions.append(frac)
            return self._apply_max_dist(Matches(dk, ik)), (qs, dk[..., -1])
        d_s, i_s, frac = sweep.nn1_sorted_v2(qs, qm, ub_t, aux["skip_rt3"],
                                             aux["skip_ct"],
                                             stream=self._skip_stream)
        self.survivor_fractions.append(frac)
        matches = Matches(d_s[..., None], i_s[..., None])
        return self._apply_max_dist(matches), (qs, d_s)
