"""Data-point filters of the default chain."""

from .base import DataPointsFilter, DataPointsFilterRegistrar, apply_filter_chain
from .basic import RandomSamplingDataPointsFilter
from .normals import SamplingSurfaceNormalDataPointsFilter

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar", "apply_filter_chain",
           "RandomSamplingDataPointsFilter",
           "SamplingSurfaceNormalDataPointsFilter"]
