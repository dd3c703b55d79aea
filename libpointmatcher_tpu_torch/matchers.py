"""Matchers: associate each reading point with its nearest reference points
(counterpart of ``libpointmatcher_tpu.matchers``; reference:
PointMatcher.h:470-494, MatchersImpl.{h,cpp}).

``KDTreeMatcher`` keeps the reference's name and parameters; it is served by
the exact dense search of :func:`.ops.dispatch.knn_search`, which launches
the K1, K9 or K5 kernel on the card. Matches are row-major ``[N, knn]``;
invalid entries carry dist = +inf, id = −1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .cloud import PointCloud
from .ops.dispatch import knn_search
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

    def find_closests_in(self, reading, reference):
        dists, ids = knn_search(reading.points, reading.mask, reference.points,
                                reference.mask, k=self.knn,
                                epsilon=float(self.epsilon))
        if self.maxDist == float("inf"):
            return Matches(dists, ids)
        limit = float(np.float32(self.maxDist) * np.float32(self.maxDist))
        keep = dists <= limit
        return Matches(torch.where(keep, dists, torch.full_like(dists, float("inf"))),
                       torch.where(keep, ids, torch.full_like(ids, -1)))
