"""Data-point filters: the default chain's, SurfaceNormal, FixStepSampling
and SimpleSensorNoise."""

from .base import DataPointsFilter, DataPointsFilterRegistrar, apply_filter_chain
from .basic import (FixStepSamplingDataPointsFilter,
                    RandomSamplingDataPointsFilter,
                    SimpleSensorNoiseDataPointsFilter)
from .normals import (SamplingSurfaceNormalDataPointsFilter,
                      SurfaceNormalDataPointsFilter)

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar", "apply_filter_chain",
           "RandomSamplingDataPointsFilter", "FixStepSamplingDataPointsFilter",
           "SimpleSensorNoiseDataPointsFilter",
           "SamplingSurfaceNormalDataPointsFilter",
           "SurfaceNormalDataPointsFilter"]
