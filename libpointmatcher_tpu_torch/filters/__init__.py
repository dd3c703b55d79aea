"""Data-point filters: the 27 of the JAX package, under its registry names
(``filters/basic.py``, ``normals.py``, ``sampling.py``, ``descriptor.py``).
Importing this package registers every one with
``DataPointsFilterRegistrar``."""

from . import basic, descriptor, normals, sampling  # noqa: F401
from .base import DataPointsFilter, DataPointsFilterRegistrar, apply_filter_chain
from .basic import (BoundingBoxDataPointsFilter,
                    CutAtDescriptorThresholdDataPointsFilter,
                    DistanceLimitDataPointsFilter,
                    FixStepSamplingDataPointsFilter, IdentityDataPointsFilter,
                    IncidenceAngleDataPointsFilter, MaxDensityDataPointsFilter,
                    MaxDistDataPointsFilter, MaxPointCountDataPointsFilter,
                    MaxQuantileOnAxisDataPointsFilter, MinDistDataPointsFilter,
                    ObservationDirectionDataPointsFilter,
                    OrientNormalsDataPointsFilter,
                    RandomSamplingDataPointsFilter, RemoveNaNDataPointsFilter,
                    ShadowDataPointsFilter, SimpleSensorNoiseDataPointsFilter)
from .descriptor import (GestaltDataPointsFilter,
                         RemoveSensorBiasDataPointsFilter)
from .normals import (SamplingSurfaceNormalDataPointsFilter,
                      SphericalityDataPointsFilter,
                      SurfaceNormalDataPointsFilter)
from .sampling import (CovarianceSamplingDataPointsFilter,
                       ElipsoidsDataPointsFilter, NormalSpaceDataPointsFilter,
                       OctreeGridDataPointsFilter, VoxelGridDataPointsFilter)

__all__ = ["DataPointsFilter", "DataPointsFilterRegistrar", "apply_filter_chain",
           "BoundingBoxDataPointsFilter",
           "CutAtDescriptorThresholdDataPointsFilter",
           "DistanceLimitDataPointsFilter", "FixStepSamplingDataPointsFilter",
           "IdentityDataPointsFilter", "IncidenceAngleDataPointsFilter",
           "MaxDensityDataPointsFilter", "MaxDistDataPointsFilter",
           "MaxPointCountDataPointsFilter", "MaxQuantileOnAxisDataPointsFilter",
           "MinDistDataPointsFilter", "ObservationDirectionDataPointsFilter",
           "OrientNormalsDataPointsFilter", "RandomSamplingDataPointsFilter",
           "RemoveNaNDataPointsFilter", "ShadowDataPointsFilter",
           "SimpleSensorNoiseDataPointsFilter", "GestaltDataPointsFilter",
           "RemoveSensorBiasDataPointsFilter",
           "SamplingSurfaceNormalDataPointsFilter",
           "SphericalityDataPointsFilter", "SurfaceNormalDataPointsFilter",
           "CovarianceSamplingDataPointsFilter", "ElipsoidsDataPointsFilter",
           "NormalSpaceDataPointsFilter", "OctreeGridDataPointsFilter",
           "VoxelGridDataPointsFilter"]
