"""Sampling and sensor-model filters (counterpart of filters of
``libpointmatcher_tpu.filters.basic``): RandomSampling (the default reading
filter), FixStepSampling (the reading step filter with a schedule over the
iterations) and SimpleSensorNoise."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar

__all__ = ["RandomSamplingDataPointsFilter", "FixStepSamplingDataPointsFilter",
           "SimpleSensorNoiseDataPointsFilter"]


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
class FixStepSamplingDataPointsFilter(DataPointsFilter):
    """Keeps every step-th valid row, the step following a geometric
    schedule from ``startStep`` towards ``endStep`` across the ICP
    iterations (reference: DataPointsFilters/FixStepSampling.cpp; the only
    filter whose ``init()`` matters).

    The schedule is the host's float64 arithmetic of :meth:`filter`: the
    step multiplied by ``stepMult`` after each call, clamped at ``endStep``,
    truncated to an int when used. :meth:`mask_at_iteration` reads it from a
    table built by replaying that arithmetic (:meth:`_schedule_table`):
    a float32 power differs from it (startStep 25, stepMult 1.4, iteration
    2: 49 from the table, 48 from the power). A geometric schedule is
    constant once clamped or at stepMult 1, so 512 saturating entries are
    exact for any iteration count."""

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
class SimpleSensorNoiseDataPointsFilter(DataPointsFilter):
    """Adds a ``simpleSensorNoise`` descriptor from an empirical model of
    the sensor's noise over range (reference:
    DataPointsFilters/SimpleSensorNoise.cpp, \\cite{Pomerleau2012Noise})."""

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
        r = torch.linalg.vector_norm(cloud.points, dim=-1)
        if self.sensorType == 3:
            noise = (r * r) * (0.5 * 0.00285)
        else:
            min_radius, beam_angle, beam_const = self._LASER[self.sensorType]
            noise = torch.clamp(beam_angle * r + beam_const, min=min_radius)
        return cloud.replace(descriptors={
            **cloud.descriptors, "simpleSensorNoise": (self.gain * noise)[..., None]})
