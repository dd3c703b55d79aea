"""The ICP engines: one-shot ``ICP`` and persistent-map ``ICPSequence``
(counterpart of ``libpointmatcher_tpu.icp``; reference: ICP.cpp:265-612).

The call structure mirrors ICP::compute:

1. reference filters → centre the reference at its mean (conditioning,
   ICP.cpp:291-299) → matcher init;
2. reading filters → pre-transform by T_refMean_dataIn;
3. the fixed-point loop: transform → match → outlier weights → minimize →
   checkers;
4. frame composition T_refIn_refMean · T_iter · T_refMean_dataIn.

The loop is driven from the host, one iteration at a time, and reads one
small tensor (continue flag, stop code) per iteration; everything else stays
on the engine's device. Iteration counts and stop codes are those of the JAX
engine's fused loop.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from .checkers import CODE_BOUND_ERROR, CODE_MAX_ITER, CODE_NAN_ERROR
from .cloud import PointCloud
from .device import resolve_device
from .errors import ConvergenceError
from .filters.base import apply_filter_chain
from .inspectors import NullInspector
from .loggers import log_info, log_warning
from .minimizers import MinimizerStats
from .outlierfilters import compute_outlier_weights
from .transformations import RigidTransformation
from .utils import se3

__all__ = ["ICP", "ICPSequence", "ICPChainBase", "CODE_NO_INLIERS"]

CODE_NO_INLIERS = 4

#: chain streams of the per-filter generators (filters/base.py)
REFERENCE_STREAM = 1
READING_STREAM = 2


class ICPChainBase:
    """Owns the module slots (reference: PointMatcher.h:652-696) and the
    device the engine runs on: the card unless ``device="cpu"``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reading_filters: List = []
        self.reference_filters: List = []
        self.matcher = None
        self.outlier_filters: List = []
        self.error_minimizer = None
        self.checkers: List = []
        self.inspector = NullInspector()
        self.transformations: List = [RigidTransformation()]
        self.prefiltered_reading_pts_count = 0
        self.prefiltered_reference_pts_count = 0
        self.max_num_iterations_reached = False
        self.last_stats: Optional[MinimizerStats] = None
        self.last_iteration_count = 0
        self.last_code = 0

    def set_default(self) -> None:
        """The reference's canonical chain (reference: ICP.cpp:100-113)."""
        from .checkers import (CounterTransformationChecker,
                               DifferentialTransformationChecker)
        from .filters.basic import RandomSamplingDataPointsFilter
        from .filters.normals import SamplingSurfaceNormalDataPointsFilter
        from .matchers import KDTreeMatcher
        from .minimizers import PointToPlaneErrorMinimizer
        from .outlierfilters import TrimmedDistOutlierFilter

        self.reading_filters = [RandomSamplingDataPointsFilter()]
        self.reference_filters = [SamplingSurfaceNormalDataPointsFilter()]
        self.matcher = KDTreeMatcher()
        self.outlier_filters = [TrimmedDistOutlierFilter()]
        self.error_minimizer = PointToPlaneErrorMinimizer()
        self.checkers = [CounterTransformationChecker(),
                         DifferentialTransformationChecker()]
        self.inspector = NullInspector()
        self.transformations = [RigidTransformation()]

    def load_from_yaml(self, source) -> None:
        """Configure from a reference-format YAML chain
        (reference: ICP.cpp:117-236)."""
        from .config import configure_chain_from_yaml

        configure_chain_from_yaml(self, source)

    def _require_modules(self):
        if self.matcher is None:
            raise RuntimeError("You must setup a matcher before running ICP")
        if self.error_minimizer is None:
            raise RuntimeError("You must setup an error minimizer before running ICP")

    def get_point_used_ratio(self) -> float:
        return float(self._stats().point_used_ratio)

    def get_weighted_point_used_ratio(self) -> float:
        return float(self._stats().weighted_point_used_ratio)

    def get_residual_error(self) -> float:
        return float(self._stats().residual)

    def get_nb_rejected_matches(self) -> int:
        return int(self._stats().nb_rejected_matches)

    def get_nb_rejected_points(self) -> int:
        return int(self._stats().nb_rejected_points)

    def _stats(self) -> MinimizerStats:
        if self.last_stats is None:
            raise RuntimeError("error minimizer needs to run at least once")
        return self.last_stats


def _apply_transform(transformations, cloud, T):
    for t in transformations:
        cloud = t.compute(cloud, T)
    return cloud


def _center_cloud(cloud: PointCloud):
    """Shift a cloud to its valid-point mean → (centred, T_refIn_refMean)."""
    d = cloud.dim
    pts = torch.where(cloud.mask[:, None], cloud.points,
                      torch.zeros_like(cloud.points))
    mean = pts.sum(dim=0) / torch.clamp(cloud.count(), min=1)
    T = se3.identity(d, cloud.device)
    T[:d, d] = mean
    return cloud.replace(points=cloud.points - mean[None, :]), T


class ICP(ICPChainBase):
    """One-shot registration engine (reference: ICP.cpp:242-452)."""

    def __call__(self, reading, reference, T_init=None, seed: int = 0):
        return self.compute(reading, reference, T_init, seed=seed)

    def _as_pose(self, T_init, dim):
        if T_init is None:
            return se3.identity(dim, self.device)
        if not isinstance(T_init, torch.Tensor):
            T_init = torch.from_numpy(np.asarray(T_init, np.float32))
        T = T_init.to(device=self.device, dtype=torch.float32)
        if T.shape != (dim + 1, dim + 1):
            raise RuntimeError("The initial transformation matrix must be "
                               f"(d+1)x(d+1) for d={dim}, got {tuple(T.shape)}")
        return T

    def compute(self, reading: PointCloud, reference: PointCloud,
                T_init=None, seed: int = 0) -> torch.Tensor:
        """Register ``reading`` to ``reference`` → T [d+1, d+1] on the
        engine's device. ``seed`` seeds the filters' draws."""
        self._require_modules()
        if reading.dim != reference.dim:
            raise RuntimeError(
                f"reading is {reading.dim}D but reference is {reference.dim}D; "
                "clouds must share the same dimensionality")
        T_init = self._as_pose(T_init, reading.dim)
        reference = apply_filter_chain(self.reference_filters,
                                       reference.to(self.device), seed,
                                       REFERENCE_STREAM)
        reference, T_refIn_refMean = _center_cloud(reference)
        self.matcher.init(reference)
        self.prefiltered_reference_pts_count = reference.count_host()
        return self.compute_with_transformed_reference(
            reading, reference, T_refIn_refMean, T_init, seed)

    def compute_with_transformed_reference(self, reading_in, reference,
                                           T_refIn_refMean, T_init, seed=0):
        """Loop half of the pipeline (reference: ICP.cpp:316-452);
        ``reference`` is already filtered and centred."""
        self.inspector.init()
        t0 = time.perf_counter()
        T_refMean_dataIn = se3.inverse(T_refIn_refMean) @ T_init
        reading = apply_filter_chain(self.reading_filters,
                                     reading_in.to(self.device), seed,
                                     READING_STREAM)
        self.prefiltered_reading_pts_count = reading.count_host()
        reading = _apply_transform(self.transformations, reading, T_refMean_dataIn)

        T_iter, iters, code, stats = self._run_loop(reading, reference)

        self.max_num_iterations_reached = code == CODE_MAX_ITER
        self.last_iteration_count = iters
        self.last_code = code
        self.last_stats = stats
        if code == CODE_NAN_ERROR:
            raise ConvergenceError("abs rotation/translation norm not a number")
        if code == CODE_BOUND_ERROR:
            raise ConvergenceError(
                "transformation bound exceeded (BoundTransformationChecker)")
        if code == CODE_NO_INLIERS:
            raise ConvergenceError("ErrorMinimizer: no point to minimize")
        self.inspector.add_stat("IterationsCount", iters)
        self.inspector.add_stat("ConvergenceDuration", time.perf_counter() - t0)
        self.inspector.finish(iters)
        log_info(f"PointMatcher::icp - {iters} iterations took "
                 f"{time.perf_counter() - t0:.4f} s")
        # frame composition (reference: ICP.cpp:444-448)
        return T_refIn_refMean @ T_iter @ T_refMean_dataIn

    def _step(self, reading, reference, T_iter, checker_states, iteration):
        """One iteration (the JAX engine's ``_make_step``)."""
        stepped = _apply_transform(self.transformations, reading, T_iter)
        matches = self.matcher.find_closests_in(stepped, reference)
        weights = compute_outlier_weights(self.outlier_filters, stepped,
                                          reference, matches)
        no_inliers = ~(torch.isfinite(matches.dists) & (weights != 0.0)).any()
        T_delta, stats = self.error_minimizer.compute(stepped, reference,
                                                      weights, matches)
        T_new = T_delta @ T_iter
        iterate = torch.ones((), dtype=torch.bool, device=T_new.device)
        code = torch.zeros((), dtype=torch.int32, device=T_new.device)
        new_states = []
        for chk, st in zip(self.checkers, checker_states):
            st2, stop, c = chk.check(st, T_new, iteration)
            new_states.append(st2)
            iterate = iterate & ~stop
            code = torch.maximum(code, c)
        code = torch.where(no_inliers, CODE_NO_INLIERS, code).to(torch.int32)
        iterate = iterate & ~no_inliers
        return T_new, new_states, iterate, code, stats

    def _run_loop(self, reading, reference):
        """Host-driven fixed-point loop: one (flag, code) read per iteration."""
        T_iter = se3.identity(reading.dim, reading.device)
        states = [c.init_state(T_iter) for c in self.checkers]
        iteration = 0
        code = 0
        stats = None
        while True:
            T_iter, states, iterate, c, stats = self._step(
                reading, reference, T_iter, states, iteration)
            go, c = torch.stack([iterate.to(torch.int32), c]).tolist()
            iteration += 1
            code = max(code, c)
            if not go:
                return T_iter, iteration, code, stats


class ICPSequence(ICP):
    """Persistent-map engine: filter the map once, then register many
    readings against it (reference: ICP.cpp:455-612)."""

    def __init__(self, device=None):
        super().__init__(device)
        self._map: Optional[PointCloud] = None
        self._T_refIn_refMean: Optional[torch.Tensor] = None

    def set_map(self, cloud: PointCloud, seed: int = 0) -> bool:
        """Filter and centre the map, init the matcher
        (reference: ICP.cpp:463-508)."""
        self._require_modules()
        cloud = apply_filter_chain(self.reference_filters, cloud.to(self.device),
                                   seed, REFERENCE_STREAM)
        cloud, T = _center_cloud(cloud)
        self._install_map(cloud, T)
        return True

    def _install_map(self, cloud: PointCloud, T_refIn_refMean: torch.Tensor):
        self._map = cloud
        self._T_refIn_refMean = T_refIn_refMean
        self.matcher.init(cloud)
        self.prefiltered_reference_pts_count = cloud.count_host()

    def trm_host(self) -> np.ndarray:
        """Host float64 copy of T_refIn_refMean."""
        if self._T_refIn_refMean is None:
            raise RuntimeError("no map set")
        return self._T_refIn_refMean.cpu().numpy().astype(np.float64)

    def get_prefiltered_internal_map(self) -> PointCloud:
        """The filtered map, centred at its mean (the frame of the loop)."""
        if self._map is None:
            raise RuntimeError("no map set")
        return self._map

    def get_prefiltered_map(self) -> PointCloud:
        """The filtered map in its original frame (reference: ICP.cpp:541-552)."""
        m = self.get_prefiltered_internal_map()
        d = m.dim
        return m.replace(points=m.points + self._T_refIn_refMean[:d, d][None, :])

    def __call__(self, cloud, T_init=None, seed: int = 0):
        return self.compute(cloud, T_init=T_init, seed=seed)

    def compute(self, reading: PointCloud, reference=None, T_init=None,
                seed: int = 0) -> torch.Tensor:
        if reference is not None:
            raise RuntimeError(
                "ICPSequence registers against its persistent map: call "
                "set_map(cloud) instead of passing a reference; use ICP for "
                "one-shot pairs")
        self._require_modules()
        T_init = self._as_pose(T_init, reading.dim)
        if self._map is None:
            log_warning("ICPSequence: no map, returning identity")
            return T_init
        return self.compute_with_transformed_reference(
            reading, self._map, self._T_refIn_refMean, T_init, seed)
