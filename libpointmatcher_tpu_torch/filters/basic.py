"""Per-row filters (counterpart of ``libpointmatcher_tpu.filters.basic``):
the geometric rules (MaxDist, MinDist, DistanceLimit, BoundingBox,
MaxQuantileOnAxis, RemoveNaN), the draws (RandomSampling, the default
reading filter; MaxDensity; MaxPointCount), FixStepSampling (the reading
step filter with a schedule over the iterations) and the descriptor rules
(Shadow, CutAtDescriptorThreshold, ObservationDirection, OrientNormals,
IncidenceAngle, SimpleSensorNoise).

A removal clears mask bits on the cloud's device; the chain compacts
after each filter. ``TRACEABLE`` is set on exactly the filters the JAX
package marks (its ``filters/basic.py:464-481``): the per-row rules with no
host step, which its queue serves. MaxPointCount (a host count decides
whether it acts) and FixStepSampling (a host schedule) are not among them.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..errors import InvalidField, InvalidParameter
from ..registry import Param
from ..utils import prng
from .base import DataPointsFilter, DataPointsFilterRegistrar

__all__ = ["IdentityDataPointsFilter", "RemoveNaNDataPointsFilter",
           "MaxDistDataPointsFilter", "MinDistDataPointsFilter",
           "DistanceLimitDataPointsFilter", "BoundingBoxDataPointsFilter",
           "MaxQuantileOnAxisDataPointsFilter", "MaxDensityDataPointsFilter",
           "RandomSamplingDataPointsFilter", "MaxPointCountDataPointsFilter",
           "FixStepSamplingDataPointsFilter", "ShadowDataPointsFilter",
           "CutAtDescriptorThresholdDataPointsFilter",
           "ObservationDirectionDataPointsFilter",
           "OrientNormalsDataPointsFilter", "IncidenceAngleDataPointsFilter",
           "SimpleSensorNoiseDataPointsFilter"]

_DIM_DOC = "dimension on which the filter will be applied. x=0, y=1, z=2, radius=-1"


def _norm(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Euclidean norm over the last axis; ``vector_norm`` rounds as
    ``jnp.linalg.norm`` does on the CPU (sqrt of a sum of squares does
    not)."""
    return torch.linalg.vector_norm(x, dim=-1, keepdim=keepdim)


def _axis_values(cloud, dim: int) -> torch.Tensor:
    """The value a distance rule thresholds: an axis coordinate, or the
    radial norm when ``dim`` is -1."""
    if dim == -1:
        return _norm(cloud.points)
    if dim >= cloud.dim:
        raise InvalidParameter(
            f"filtering on dimension {dim}, larger than authorized axis id "
            f"{cloud.dim - 1}")
    return cloud.points[..., dim]


def _require(cloud, filter_name: str, *names: str) -> None:
    """Raise the JAX package's error for a missing descriptor."""
    for name in names:
        if not cloud.has_descriptor(name):
            what = "observation directions" if name == "observationDirections" else name
            raise InvalidField(f"{filter_name}: cannot find {what} in descriptors")


@DataPointsFilterRegistrar.register
class IdentityDataPointsFilter(DataPointsFilter):
    """Does nothing (reference: DataPointsFilters/Identity.cpp)."""

    TRACEABLE = True

    def filter(self, cloud, key=None, scan=None):
        return cloud


@DataPointsFilterRegistrar.register
class RemoveNaNDataPointsFilter(DataPointsFilter):
    """Removes points with any non-finite coordinate
    (reference: DataPointsFilters/RemoveNaN.cpp)."""

    TRACEABLE = True

    def filter(self, cloud, key=None, scan=None):
        return cloud.with_mask(torch.isfinite(cloud.points).all(dim=-1))


@DataPointsFilterRegistrar.register
class MaxDistDataPointsFilter(DataPointsFilter):
    """Keeps points below a maximum distance on an axis or radially
    (reference: DataPointsFilters/MaxDist.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("dim", _DIM_DOC, int, -1, min=-1, max=2),
        Param("maxDist", "maximum distance authorized. If dim is -1 (radius) "
              "the absolute value is used. All points beyond are filtered.",
              float, 1.0),
    )

    def filter(self, cloud, key=None, scan=None):
        v = _axis_values(cloud, self.dim)
        limit = abs(self.maxDist) if self.dim == -1 else self.maxDist
        return cloud.with_mask(v < limit)


@DataPointsFilterRegistrar.register
class MinDistDataPointsFilter(DataPointsFilter):
    """Keeps points beyond a minimum distance on an axis or radially
    (reference: DataPointsFilters/MinDist.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("dim", _DIM_DOC, int, -1, min=-1, max=2),
        Param("minDist", "minimum value authorized. If dim is -1 (radius) "
              "the absolute value is used. All points before are filtered.",
              float, 1.0),
    )

    def filter(self, cloud, key=None, scan=None):
        v = _axis_values(cloud, self.dim)
        limit = abs(self.minDist) if self.dim == -1 else self.minDist
        return cloud.with_mask(v > limit)


@DataPointsFilterRegistrar.register
class DistanceLimitDataPointsFilter(DataPointsFilter):
    """Keeps points inside or outside a distance limit
    (reference: DataPointsFilters/DistanceLimit.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("dim", _DIM_DOC, int, -1, min=-1, max=2),
        Param("dist", "distance limit; absolute value used when dim == -1",
              float, 1.0),
        Param("removeInside", "1: remove points before the limit; 0: remove "
              "points beyond", bool, True),
    )

    def filter(self, cloud, key=None, scan=None):
        v = _axis_values(cloud, self.dim)
        limit = abs(self.dist) if self.dim == -1 else self.dist
        return cloud.with_mask(v > limit if self.removeInside else v < limit)


@DataPointsFilterRegistrar.register
class BoundingBoxDataPointsFilter(DataPointsFilter):
    """Removes points inside (or outside) an axis-aligned box
    (reference: DataPointsFilters/BoundingBox.cpp)."""
    # z is ignored in 2D

    TRACEABLE = True
    PARAMS = (
        Param("xMin", "minimum value on x-axis", float, -1.0),
        Param("xMax", "maximum value on x-axis", float, 1.0),
        Param("yMin", "minimum value on y-axis", float, -1.0),
        Param("yMax", "maximum value on y-axis", float, 1.0),
        Param("zMin", "minimum value on z-axis", float, -1.0),
        Param("zMax", "maximum value on z-axis", float, 1.0),
        Param("removeInside", "1: remove inside the box; 0: remove outside",
              bool, True),
    )

    def filter(self, cloud, key=None, scan=None):
        p = cloud.points
        bounds = ((self.xMin, self.xMax), (self.yMin, self.yMax),
                  (self.zMin, self.zMax))[:cloud.dim]
        inside = cloud.mask.new_ones(cloud.mask.shape)
        for a, (lo, hi) in enumerate(bounds):
            inside &= (p[..., a] > lo) & (p[..., a] < hi)
        return cloud.with_mask(~inside if self.removeInside else inside)


@DataPointsFilterRegistrar.register
class MaxQuantileOnAxisDataPointsFilter(DataPointsFilter):
    """Keeps points below the ratio-quantile of an axis coordinate
    (reference: DataPointsFilters/MaxQuantileOnAxis.cpp)."""
    # the quantile's index is the JAX package's: the valid count times
    # ``ratio`` as a float32 product, truncated, clipped to the rows

    TRACEABLE = True
    PARAMS = (
        Param("dim", "dimension on which the filter will be applied. "
              "x=0, y=1, z=2", int, 0, min=0, max=2),
        Param("ratio", "maximum quantile authorized; points beyond are "
              "filtered", float, 0.5, min=0.0000001, max=0.9999999),
    )

    def filter(self, cloud, key=None, scan=None):
        v = _axis_values(cloud, self.dim)
        s = torch.sort(torch.where(cloud.mask, v, float("inf"))).values
        ratio = torch.tensor(self.ratio, dtype=torch.float32, device=v.device)
        idx = (cloud.count().to(torch.float32) * ratio).to(torch.int64)
        limit = s[idx.clamp(0, cloud.num_points - 1)]
        return cloud.with_mask(v < limit)


@DataPointsFilterRegistrar.register
class MaxDensityDataPointsFilter(DataPointsFilter):
    """Probabilistically thins points whose local density exceeds maxDensity
    (reference: DataPointsFilters/MaxDensity.cpp; needs a prior
    SurfaceNormal/SamplingSurfaceNormal pass to produce 'densities')."""
    # the draw is JAX's from the chain key, one value per row

    TRACEABLE = True
    PARAMS = (
        Param("maxDensity", "Maximum density of points to target. Unit: "
              "number of points per m^3.", float, 10.0, min=0.0000001),
    )

    def filter(self, cloud, key=None, scan=None):
        if not cloud.has_descriptor("densities"):
            raise InvalidField(
                "MaxDensityDataPointsFilter: no densities found in descriptors")
        dens = cloud.get_descriptor("densities")[..., 0]
        masked = torch.where(cloud.mask, dens, float("-inf"))
        last = masked.amax(dim=-1, keepdim=True)
        n_sat = (masked == last).sum(dim=-1, keepdim=True).to(torch.float32)
        n = torch.clamp(cloud.count(), min=1)[..., None].to(torch.float32)
        # a true division, as JAX's (a Python number over a tensor is a
        # reciprocal and a product in torch)
        accept = torch.div(torch.tensor(self.maxDensity, dtype=torch.float32,
                                        device=dens.device),
                           torch.clamp(dens, min=1e-20))
        # saturation correction (reference: MaxDensity.cpp acceptRatio scaling)
        accept = torch.where(dens == last, accept * (1.0 - n_sat / n), accept)
        r = self.draw_uniform(cloud, key, scan)
        return cloud.with_mask((dens <= self.maxDensity) | (r < accept))


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


def _rank(mask: torch.Tensor) -> torch.Tensor:
    """Each row's rank among the valid rows of its scan (last axis)."""
    return torch.cumsum(mask.to(torch.int64), dim=-1) - 1


@DataPointsFilterRegistrar.register
class MaxPointCountDataPointsFilter(DataPointsFilter):
    """Keeps ``maxCount`` valid points at random when the cloud has more
    (reference: DataPointsFilters/MaxPointCount.cpp). As in the JAX
    package, the draw is ``uniform(PRNGKey(seed))`` over the rows, masked
    rows rank last, and a stable sort keeps the ``maxCount`` smallest
    draws: float32 draws collide (2^23 values in [0.5, 1)), and the tie
    order decides which rows stay."""
    DESCRIPTION = """Random subsample iff the cloud exceeds maxCount points
    (reference: DataPointsFilters/MaxPointCount.cpp). The reference's
    Fisher-Yates prefix swap with a fixed srand seed becomes a seeded
    ``jax.random`` permutation — same contract: deterministic for a given
    seed, keeps exactly maxCount points."""

    PARAMS = (
        Param("seed", "random seed", int, 1, min=0),
        Param("maxCount", "maximum number of points", int, 1000, min=0),
    )

    def filter(self, cloud, key=None, scan=None):
        if cloud.count_host() <= self.maxCount:
            return cloud
        r = prng.uniform(prng.prng_key(self.seed), cloud.num_points, cloud.device)
        r = torch.where(cloud.mask, r, float("inf"))
        rows = torch.argsort(r, stable=True)[:self.maxCount]
        keep = torch.zeros_like(cloud.mask)
        keep[rows] = True
        return cloud.with_mask(keep)


@DataPointsFilterRegistrar.register
class FixStepSamplingDataPointsFilter(DataPointsFilter):
    """Keeps every step-th point with a geometric step schedule across ICP
    iterations (reference: DataPointsFilters/FixStepSampling.cpp; the only
    filter whose ``init()`` matters)."""
    # The schedule is the host's float64 arithmetic of :meth:`filter`: the
    # step multiplied by ``stepMult`` after each call, clamped at ``endStep``,
    # truncated to an int when used. :meth:`mask_at_iteration` reads it from a
    # table built by replaying that arithmetic (:meth:`_schedule_table`):
    # a float32 power differs from it (startStep 25, stepMult 1.4, iteration
    # 2: 49 from the table, 48 from the power). A geometric schedule is
    # constant once clamped or at stepMult 1, so 512 saturating entries are
    # exact for any iteration count.

    PARAMS = (
        Param("startStep", "initial number of points to skip (initial "
              "decimation factor)", int, 10, min=1),
        Param("endStep", "maximal or minimal number of points to skip (final "
              "decimation factor)", int, 10, min=1),
        Param("stepMult", "multiplication factor to compute the new "
              "decimation factor for each iteration", float, 1.0,
              min=0.0000001),
    )
    SCHEDULE_TRACEABLE = True
    _SCHED_LEN = 512

    def __init__(self, params=None):
        super().__init__(params)
        self.step = float(self.startStep)
        self._table = self._schedule_table()
        #: the table on each device that asked for it (iterations per lane)
        self._tables: Dict[torch.device, torch.Tensor] = {}

    def init(self) -> None:
        self.step = float(self.startStep)

    def _advance(self, step: float) -> float:
        delta = self.startStep * self.stepMult - self.startStep
        step *= self.stepMult
        if delta < 0 and step < self.endStep:
            step = float(self.endStep)
        if delta > 0 and step > self.endStep:
            step = float(self.endStep)
        return step

    def filter(self, cloud, key=None, scan=None):
        istep = max(int(self.step), 1)
        self.step = self._advance(self.step)
        return cloud.with_mask(_rank(cloud.mask) % istep == 0)

    def _schedule_table(self) -> np.ndarray:
        """The step of iterations 0..511 → int32 [512]."""
        steps = np.empty((self._SCHED_LEN,), np.int32)
        step = float(self.startStep)
        for i in range(self._SCHED_LEN):
            steps[i] = max(int(step), 1)
            step = self._advance(step)
        return steps

    def mask_at_iteration(self, cloud, iteration):
        last = self._SCHED_LEN - 1
        if isinstance(iteration, torch.Tensor):
            table = self._tables.get(cloud.device)
            if table is None:
                table = torch.as_tensor(self._table.astype(np.int64),
                                        device=cloud.device)
                self._tables[cloud.device] = table
            istep = table[iteration.to(torch.int64).clamp(0, last)][..., None]
        else:
            istep = int(self._table[min(max(int(iteration), 0), last)])
        return cloud.with_mask(_rank(cloud.mask) % istep == 0)


@DataPointsFilterRegistrar.register
class ShadowDataPointsFilter(DataPointsFilter):
    """Removes shadow (veil) points whose normal is nearly orthogonal to the
    viewing direction (reference: DataPointsFilters/Shadow.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("eps", "Small angle (in rad) around which a normal shouldn't "
              "be observable", float, 0.1, min=0.0, max=3.1416),
    )

    def filter(self, cloud, key=None, scan=None):
        _require(cloud, "ShadowDataPointsFilter", "normals")
        normals = cloud.get_descriptor("normals")
        normals = normals / torch.clamp(_norm(normals, True), min=1e-20)
        pts = cloud.points / torch.clamp(_norm(cloud.points, True), min=1e-20)
        value = torch.abs((normals * pts).sum(dim=-1))
        return cloud.with_mask(value > self.eps)


@DataPointsFilterRegistrar.register
class CutAtDescriptorThresholdDataPointsFilter(DataPointsFilter):
    """Drops points whose named 1-D descriptor is above/below a threshold
    (reference: DataPointsFilters/CutAtDescriptorThreshold.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("descName", "Descriptor name used to cut points", str, "none"),
        Param("useLargerThan", "1: cut points with values above threshold; "
              "0: cut points below", bool, True),
        Param("threshold", "Value at which to cut.", float, 0.0),
    )

    def filter(self, cloud, key=None, scan=None):
        if not cloud.has_descriptor(self.descName):
            raise InvalidField(
                "CutAtDescriptorThresholdDataPointsFilter: field "
                f"'{self.descName}' not found in descriptors")
        v = cloud.get_descriptor(self.descName)[..., 0]
        keep = v <= self.threshold if self.useLargerThan else v >= self.threshold
        return cloud.with_mask(keep)


@DataPointsFilterRegistrar.register
class ObservationDirectionDataPointsFilter(DataPointsFilter):
    """Adds an 'observationDirections' descriptor pointing from each point to
    the sensor center (reference: DataPointsFilters/ObservationDirection.cpp)."""

    TRACEABLE = True
    PARAMS = (
        Param("x", "x-coordinate of sensor", float, 0.0),
        Param("y", "y-coordinate of sensor", float, 0.0),
        Param("z", "z-coordinate of sensor", float, 0.0),
    )

    def filter(self, cloud, key=None, scan=None):
        center = torch.tensor([self.x, self.y, self.z][:cloud.dim],
                              dtype=torch.float32, device=cloud.device)
        return cloud.with_descriptor("observationDirections", center - cloud.points)


@DataPointsFilterRegistrar.register
class OrientNormalsDataPointsFilter(DataPointsFilter):
    """Flips normals toward (or away from) the observation direction
    (reference: DataPointsFilters/OrientNormals.cpp)."""
    # a normal orthogonal to the observation direction is kept

    TRACEABLE = True
    PARAMS = (
        Param("towardCenter", "1: normals point toward the observation "
              "points; 0: away", bool, True),
    )

    def filter(self, cloud, key=None, scan=None):
        _require(cloud, "OrientNormalsDataPointsFilter", "normals",
                 "observationDirections")
        n = cloud.get_descriptor("normals")
        od = cloud.get_descriptor("observationDirections")
        scalar = (n * od).sum(dim=-1, keepdim=True)
        sign = torch.where(scalar < 0, -1.0, 1.0)
        if not self.towardCenter:
            sign = -sign
        return cloud.with_descriptor("normals", n * torch.where(scalar == 0, 1.0, sign))


@DataPointsFilterRegistrar.register
class IncidenceAngleDataPointsFilter(DataPointsFilter):
    """Adds the incidence angle acos(view·normal) as descriptor
    (reference: DataPointsFilters/IncidenceAngle.cpp)."""

    TRACEABLE = True

    def filter(self, cloud, key=None, scan=None):
        _require(cloud, "IncidenceAngleDataPointsFilter", "normals",
                 "observationDirections")
        n = cloud.get_descriptor("normals")
        od = cloud.get_descriptor("observationDirections")
        od = od / torch.clamp(_norm(od, True), min=1e-20)
        dot = torch.clamp((n * od).sum(dim=-1), -1.0, 1.0)
        return cloud.with_descriptor("incidenceAngles", torch.arccos(dot))


@DataPointsFilterRegistrar.register
class SimpleSensorNoiseDataPointsFilter(DataPointsFilter):
    r"""Adds a 'simpleSensorNoise' descriptor from an empirical sensor model
    (reference: DataPointsFilters/SimpleSensorNoise.cpp,
    \cite{Pomerleau2012Noise})."""

    TRACEABLE = True
    PARAMS = (
        Param("sensorType", "Type of the sensor used. 0=Sick LMS-1xx, "
              "1=Hokuyo URG-04LX, 2=Hokuyo UTM-30LX, 3=Kinect/Xtion, "
              "4=Sick Tim3xx", int, 0, min=0, max=4),
        Param("gain", "Uncertainty gain for untrusted sources", float, 1.0,
              min=1.0),
    )

    #: the laser sensors' (minimum radius, beam angle, beam constant)
    _LASER = {
        0: (0.012, 0.0068, 0.0008),
        1: (0.028, 0.0013, 0.0001),
        2: (0.018, 0.0006, 0.0015),
        4: (0.004, 0.0053, -0.0092),
    }

    def filter(self, cloud, key=None, scan=None):
        r = _norm(cloud.points)
        if self.sensorType == 3:
            noise = (r * r) * (0.5 * 0.00285)
        else:
            min_radius, beam_angle, beam_const = self._LASER[self.sensorType]
            noise = torch.clamp(beam_angle * r + beam_const, min=min_radius)
        return cloud.with_descriptor("simpleSensorNoise", self.gain * noise)
