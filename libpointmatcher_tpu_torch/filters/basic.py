"""Sampling filter of the default reading chain (counterpart of
``libpointmatcher_tpu.filters.basic.RandomSamplingDataPointsFilter``)."""

from __future__ import annotations

from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar

__all__ = ["RandomSamplingDataPointsFilter"]


@DataPointsFilterRegistrar.register
class RandomSamplingDataPointsFilter(DataPointsFilter):
    """Keeps each point with probability ``prob``
    (reference: DataPointsFilters/RandomSampling.cpp; the default reading
    filter, ICP.cpp:105)."""

    TRACEABLE = True
    PARAMS = (
        Param("prob", "probability to keep a point, one over decimation "
              "factor", float, 0.75, min=0.0, max=1.0),
    )

    def filter(self, cloud, key=None, scan=None):
        return cloud.with_mask(self.draw_uniform(cloud, key, scan) < self.prob)
