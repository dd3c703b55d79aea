"""Data-point filters of the default chain and SurfaceNormal."""

from .base import DataPointsFilter, DataPointsFilterRegistrar, apply_filter_chain
from .basic import RandomSamplingDataPointsFilter
from .normals import (SamplingSurfaceNormalDataPointsFilter,
                      SurfaceNormalDataPointsFilter)

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar", "apply_filter_chain",
           "RandomSamplingDataPointsFilter",
           "SamplingSurfaceNormalDataPointsFilter",
           "SurfaceNormalDataPointsFilter"]
