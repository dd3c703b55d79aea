"""The ICP engines: one-shot ``ICP`` and persistent-map ``ICPSequence``
(counterpart of ``libpointmatcher_tpu.icp``; reference: ICP.cpp:265-612).

The call structure mirrors ICP::compute:

1. reference filters → centre the reference at its mean (conditioning,
   ICP.cpp:291-299) → matcher init;
2. reading filters → pre-transform by T_refMean_dataIn;
3. the fixed-point loop: step filters → transform → match → outlier
   weights → minimize → checkers;
4. frame composition T_refIn_refMean · T_iter · T_refMean_dataIn.

The loop is driven from the host, one iteration at a time, and runs a whole
batch of scans in lockstep: every tensor of its state carries the reading's
leading batch dimensions (none for one registration), each scan keeps its
own iteration count and stop code, and a scan that has stopped is frozen by
``torch.where`` on a per-scan ``active`` mask (the counterpart of the JAX
engine's ``while_loop`` under ``vmap``). The host reads the ``active``
flags once per iteration; everything else stays on the engine's device.
Iteration counts and stop codes are those of the JAX engine's fused loop.
Reading step filters with a schedule (``SCHEDULE_TRACEABLE``, as
FixStepSampling) run inside that loop, and so does Anderson acceleration
(``acceleration = "anderson"``).

A second driver, the stepped one (:meth:`ICP._run_stepped`), serves a step
chain with a filter that has no such schedule (it draws or keeps host
state), or an inspector that dumps iterations: each iteration applies the
step chain on its own key, without compaction, and hands the inspector
host copies. It runs the matcher without loop tables.
"""

from __future__ import annotations

import math
import time
from typing import List, Optional

import numpy as np
import torch

from .checkers import CODE_BOUND_ERROR, CODE_MAX_ITER, CODE_NAN_ERROR
from .cloud import PointCloud
from .device import resolve_device
from .errors import ConvergenceError
from .filters.base import apply_filter_chain, chain_is_traceable
from .inspectors import NullInspector
from .loggers import log_info, log_warning
from .matchers import Matcher, Matches, has_host_tables
from .minimizers import MinimizerStats, estimate_overlap
from .outlierfilters import compute_outlier_weights, init_outlier_states
from .transformations import RigidTransformation
from .utils import prng, se3

__all__ = ["ICP", "ICPSequence", "ICPChainBase", "CODE_NO_INLIERS"]

CODE_NO_INLIERS = 4

#: what the engine folds into ``PRNGKey(seed)`` for the reference chain's
#: key and the reading chain's, as the JAX engine does (its icp.py)
REFERENCE_STREAM = 1
READING_STREAM = 2
#: the stepped driver's step chain draws from ``fold_in(fold_in(PRNGKey(seed),
#: STEP_STREAM), iteration)``
STEP_STREAM = 3


def _has_sensor_noise(filters) -> bool:
    return any(type(f).__name__ == "SimpleSensorNoiseDataPointsFilter"
               for f in filters)


def chain_key(seed: int, stream: int) -> prng.Key:
    """The chain key ``fold_in(PRNGKey(seed), stream)``."""
    return prng.fold_in(prng.prng_key(seed), stream)


class ICPChainBase:
    """Owns the module slots (reference: PointMatcher.h:652-696) and the
    device the engine runs on: the card unless ``device="cpu"``."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.reading_filters: List = []
        self.reading_step_filters: List = []
        self.reference_filters: List = []
        self.matcher = None
        self.outlier_filters: List = []
        self.error_minimizer = None
        self.checkers: List = []
        self.inspector = NullInspector()
        self.transformations: List = [RigidTransformation()]
        #: the filtered clouds (or counts), counted on the host when read
        self._prefiltered_reading = 0
        self._prefiltered_reference = 0
        self.max_num_iterations_reached = False
        #: convergence acceleration: None or "anderson" (AA-ICP,
        #: \cite{Pavlov2017AAICP}: Anderson acceleration of the fixed point
        #: over the last ``acceleration_window`` poses, with a restart when
        #: the residual grows and a trust region around the plain step)
        self.acceleration: Optional[str] = None
        self.acceleration_window: int = 3
        #: the noise-aware overlap of the last registration (None without
        #: ``simpleSensorNoise`` descriptors on the reading)
        self.last_overlap: Optional[float] = None
        #: True when the last registration's displacement bound passed the
        #: matcher's motionBound (BlockGridMatcher): matches beyond the
        #: cells assigned at loop start may have been missed
        self.motion_bound_exceeded = False
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
        self.reading_step_filters = []
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
        if self.inspector is None:
            raise RuntimeError("You must setup an inspector before running ICP")

    def _step_chain_traced(self) -> bool:
        """True when every reading step filter has a schedule the loop can
        apply itself (``SCHEDULE_TRACEABLE``); else the stepped driver
        runs the chain."""
        return all(getattr(type(f), "SCHEDULE_TRACEABLE", False)
                   for f in self.reading_step_filters)

    @property
    def prefiltered_reading_pts_count(self) -> int:
        v = self._prefiltered_reading
        return v.count_host() if isinstance(v, PointCloud) else int(v)

    @prefiltered_reading_pts_count.setter
    def prefiltered_reading_pts_count(self, v):
        self._prefiltered_reading = v

    @property
    def prefiltered_reference_pts_count(self) -> int:
        v = self._prefiltered_reference
        return v.count_host() if isinstance(v, PointCloud) else int(v)

    @prefiltered_reference_pts_count.setter
    def prefiltered_reference_pts_count(self, v):
        self._prefiltered_reference = v

    def get_prefiltered_reading_pts_count(self) -> int:
        return self.prefiltered_reading_pts_count

    def get_prefiltered_reference_pts_count(self) -> int:
        return self.prefiltered_reference_pts_count

    def get_max_num_iterations_reached(self) -> bool:
        return self.max_num_iterations_reached

    def get_point_used_ratio(self) -> float:
        return float(self._stats().point_used_ratio)

    def get_weighted_point_used_ratio(self) -> float:
        return float(self._stats().weighted_point_used_ratio)

    def get_overlap(self) -> float:
        """The last registration's overlap estimate: noise-aware when the
        reading had ``simpleSensorNoise`` descriptors (reference:
        PointToPoint.cpp:119-152), else the weighted point-used ratio."""
        if self.last_overlap is not None:
            return float(self.last_overlap)
        return self.get_weighted_point_used_ratio()

    def get_residual_error(self) -> float:
        return float(self._stats().residual)

    def get_nb_rejected_matches(self) -> int:
        return int(self._stats().nb_rejected_matches)

    def get_nb_rejected_points(self) -> int:
        return int(self._stats().nb_rejected_points)

    def get_covariance(self) -> np.ndarray:
        """The transform's 6x6 covariance from a WithCov minimizer, one per
        scan after a serving call (reference: PointToPlaneWithCov.cpp:157-162)."""
        if self.last_stats is None or self.last_stats.covariance is None:
            raise RuntimeError(
                "no covariance available: run a *WithCov error minimizer first")
        return self.last_stats.covariance.cpu().numpy()

    def _stats(self) -> MinimizerStats:
        if self.last_stats is None:
            raise RuntimeError("error minimizer needs to run at least once")
        return self.last_stats


def _small_solve(A: torch.Tensor, b: torch.Tensor):
    """Solve the Anderson window's system ``A [..., m, m] x = b [..., m]``
    per scan → ``(x [..., m], ok [...])``, in closed form for m ≤ 3 (the
    JAX engine's ``_small_solve``: Cramer's rule by the adjugate) and by
    an LU solve above. ``ok`` is False where the cofactor
    determinant is within cancellation noise of the matrix's scale,
    |det| ≤ 1e-5·scale^m: the residual history is then close to collinear,
    the solution noise, and the caller takes the plain step."""
    m = A.shape[-1]
    true = torch.ones(A.shape[:-2], dtype=torch.bool, device=A.device)
    if m == 1:
        return b / A[..., 0, :1], true
    if m > 3:
        # a singular system gives inf or NaN (a rejected extrapolation), as
        # the JAX engine's LU does, instead of raising
        return torch.linalg.solve_ex(A, b)[0], true
    a = lambda i, j: A[..., i, j]
    scale = torch.clamp(torch.amax(torch.abs(A), dim=(-2, -1)), min=1e-30)
    if m == 2:
        det = a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)
        ok = torch.abs(det) > 1e-5 * scale * scale
        safe = torch.where(ok, det, 1.0)
        x0 = (a(1, 1) * b[..., 0] - a(0, 1) * b[..., 1]) / safe
        x1 = (a(0, 0) * b[..., 1] - a(1, 0) * b[..., 0]) / safe
        return torch.stack([x0, x1], dim=-1), ok
    c00 = a(1, 1) * a(2, 2) - a(1, 2) * a(2, 1)
    c01 = a(1, 2) * a(2, 0) - a(1, 0) * a(2, 2)
    c02 = a(1, 0) * a(2, 1) - a(1, 1) * a(2, 0)
    det = a(0, 0) * c00 + a(0, 1) * c01 + a(0, 2) * c02
    c10 = a(0, 2) * a(2, 1) - a(0, 1) * a(2, 2)
    c11 = a(0, 0) * a(2, 2) - a(0, 2) * a(2, 0)
    c12 = a(0, 1) * a(2, 0) - a(0, 0) * a(2, 1)
    c20 = a(0, 1) * a(1, 2) - a(0, 2) * a(1, 1)
    c21 = a(0, 2) * a(1, 0) - a(0, 0) * a(1, 2)
    c22 = a(0, 0) * a(1, 1) - a(0, 1) * a(1, 0)
    ok = torch.abs(det) > 1e-5 * scale * scale * scale
    safe = torch.where(ok, det, 1.0)
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    x0 = (c00 * b0 + c10 * b1 + c20 * b2) / safe
    x1 = (c01 * b0 + c11 * b1 + c21 * b2) / safe
    x2 = (c02 * b0 + c12 * b1 + c22 * b2) / safe
    return torch.stack([x0, x1, x2], dim=-1), ok


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis (``vector_norm`` rounds as
    ``jnp.linalg.norm`` does on the CPU, where sqrt(Σ x²) does not)."""
    return torch.linalg.vector_norm(x, dim=-1)


def _anderson_init(bshape, d: int, m: int, device):
    """The Anderson window, empty: ``(G, F [..., m, d(d+1)], hist_len [...],
    prev_fnorm [...])``."""
    zeros = torch.zeros(*bshape, m, d * (d + 1), device=device)
    return (zeros, zeros.clone(),
            torch.zeros(bshape, dtype=torch.int32, device=device),
            torch.full(bshape, float("inf"), device=device))


def _anderson_step(T_iter: torch.Tensor, T_plain: torch.Tensor, window):
    """One Anderson step per scan (the JAX engine's
    ``_make_anderson_runner`` body) → ``(T_next, window)``.

    The fixed-point map g is one plain iteration; x = T[:d, :] flattened.
    The newest (g, f = g − x) enters the window of the last m; the window
    restarts when ‖f‖ grew. The weights α (Σα = 1) minimise ‖Σ α_j f_j‖
    through the m x m system of the valid slots (identity rows elsewhere);
    a noise-level determinant gives the plain step. The extrapolated
    rotation block is projected back towards SO(d) by three Newton–Schulz
    steps, and the extrapolation is kept only inside the trust region:
    ‖x_acc − g‖ ≤ 10‖f‖, ‖RᵀR − I‖ < 0.3 before the projection, det R > 0.5
    after it, and at least two slots in the window. The checkers have seen
    only the plain step, as in the JAX engine."""
    G, F, hist_len, prev_fnorm = window
    m = G.shape[-2]
    d = T_plain.shape[-1] - 1
    lead = T_plain.shape[:-2]
    dev = T_plain.device
    g = T_plain[..., :d, :].reshape(*lead, -1)
    f = g - T_iter[..., :d, :].reshape(*lead, -1)
    fnorm = _norm(f)
    hist_len = torch.where((hist_len > 0) & (fnorm > prev_fnorm), 0, hist_len)
    G = torch.cat([G[..., 1:, :], g[..., None, :]], dim=-2)
    F = torch.cat([F[..., 1:, :], f[..., None, :]], dim=-2)
    hist_len = torch.clamp(hist_len + 1, max=m).to(torch.int32)
    slot = torch.arange(m, device=dev)
    valid = (slot >= (m - hist_len)[..., None]).to(F.dtype)
    Fv = F * valid[..., None]
    eye_m = torch.eye(m, device=dev)
    A = Fv @ Fv.mT + 1e-10 * eye_m
    both = (valid[..., :, None] > 0) & (valid[..., None, :] > 0)
    A = torch.where(both, A, eye_m)
    alpha, ok = _small_solve(A, valid)
    alpha = torch.where(ok[..., None], alpha, (slot == m - 1).to(F.dtype))
    alpha = alpha * valid / torch.clamp(torch.sum(alpha * valid, dim=-1,
                                                  keepdim=True), min=1e-20)
    x_acc = (alpha[..., None, :] @ G)[..., 0, :]
    M = x_acc.reshape(*lead, d, d + 1)
    R = M[..., :d]
    eye_d = torch.eye(d, device=dev)
    drift = _norm((R.mT @ R - eye_d).reshape(*lead, -1))
    for _ in range(3):
        R = 0.5 * R @ (3.0 * eye_d - R.mT @ R)
    T_acc = se3.identity(d, dev).expand(*lead, d + 1, d + 1).clone()
    T_acc[..., :d, :d] = R
    T_acc[..., :d, d] = M[..., d]
    trust = ((_norm(x_acc - g) <= 10.0 * fnorm) & (drift < 0.3)
             & (torch.linalg.det(R) > 0.5))
    use = (hist_len > 1) & trust
    T_next = torch.where(use[..., None, None], T_acc, T_plain)
    return T_next, (G, F, hist_len, fnorm)


def _apply_transform(transformations, cloud, T):
    for t in transformations:
        cloud = t.compute(cloud, T)
    return cloud


def _keep_active(active: torch.Tensor, new, old):
    """``new`` where ``active`` (one flag per scan), else ``old``, over
    nested tuples and lists of tensors; other leaves take ``new``."""
    if isinstance(new, torch.Tensor):
        flag = active.reshape(active.shape + (1,) * (new.ndim - active.ndim))
        return torch.where(flag, new, old)
    if isinstance(new, (tuple, list)):
        out = [_keep_active(active, n, o) for n, o in zip(new, old)]
        return type(new)(*out) if hasattr(new, "_fields") else type(new)(out)
    return new


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
        self.inspector.init()
        t0 = time.perf_counter()
        if reading.dim != reference.dim:
            raise RuntimeError(
                f"reading is {reading.dim}D but reference is {reference.dim}D; "
                "clouds must share the same dimensionality")
        T_init = self._as_pose(T_init, reading.dim)
        wants_stats = self.inspector.wants_stats
        reference = reference.to(self.device)
        ref_in_count = reference.count_host() if wants_stats else 0
        reference = apply_filter_chain(self.reference_filters, reference,
                                       chain_key(seed, REFERENCE_STREAM),
                                       traced=self._reference_chain_traced(reading))
        reference, T_refIn_refMean = _center_cloud(reference)
        self.matcher.init(reference)
        if wants_stats:
            self.inspector.add_stat("ReferencePreprocessingDuration",
                                    time.perf_counter() - t0)
            self.inspector.add_stat("ReferenceInPointCount", ref_in_count)
            self.inspector.add_stat("ReferencePointCount", reference.count_host())
        self.prefiltered_reference_pts_count = reference     # counted lazily
        return self.compute_with_transformed_reference(
            reading, reference, T_refIn_refMean, T_init, seed)

    def _fused(self) -> bool:
        """True when the loop of :meth:`_run_loop` serves the chain: no
        step filter without a schedule and no inspector that dumps
        iterations (else :meth:`_run_stepped`)."""
        return (self._step_chain_traced()
                and not self.inspector.needs_iteration_data)

    def _reading_chain_traced(self, reading_in, wants_stats: bool) -> bool:
        """True where the JAX engine runs the reading chain inside its
        one-program one-shot (its ``icp.py:409-433``), with no compaction
        between filters: a fused loop, no statistics, a ``TRACEABLE``
        chain, a matcher without loop tables and no sensor-noise
        descriptors. Elsewhere it compacts after each filter."""
        return (self._fused() and not wants_stats
                and chain_is_traceable(self.reading_filters)
                and type(self.matcher).prepare_loop is Matcher.prepare_loop
                and not reading_in.has_descriptor("simpleSensorNoise")
                and not _has_sensor_noise(self.reading_filters))

    def _reference_chain_traced(self, reading) -> bool:
        """True where the JAX engine runs the whole one-shot in one program
        (its ``icp.py:882-907``), the reference chain with no compaction
        between filters: the reading chain so too, a matcher without init
        tables, ``TRACEABLE`` reference filters after a ``HOST_PREP`` or
        ``TRACEABLE`` head, none of them SimpleSensorNoise."""
        rf = self.reference_filters
        return (self._reading_chain_traced(reading, self.inspector.wants_stats)
                and type(self.matcher).init is Matcher.init
                and all(f.TRACEABLE or f.HOST_PREP for f in rf[:1])
                and chain_is_traceable(rf[1:]) and not _has_sensor_noise(rf))

    def compute_with_transformed_reference(self, reading_in, reference,
                                           T_refIn_refMean, T_init, seed=0):
        """Loop half of the pipeline (reference: ICP.cpp:316-452);
        ``reference`` is already filtered and centred. With an inspector
        that wants statistics, the reading's counts and durations, the
        iteration count, the touched pairs, the overlap and the loop's
        duration are recorded, at the JAX engine's points and in its
        order."""
        t0 = time.perf_counter()
        wants_stats = self.inspector.wants_stats
        T_refMean_dataIn = se3.inverse(T_refIn_refMean) @ T_init
        reading_in = reading_in.to(self.device)
        read_in_count = reading_in.count_host() if wants_stats else 0
        reading = apply_filter_chain(self.reading_filters, reading_in,
                                     chain_key(seed, READING_STREAM),
                                     traced=self._reading_chain_traced(
                                         reading_in, wants_stats))
        reading = _apply_transform(self.transformations, reading, T_refMean_dataIn)
        if wants_stats:
            self.inspector.add_stat("ReadingPreprocessingDuration",
                                    time.perf_counter() - t0)
            self.inspector.add_stat("ReadingInPointCount", read_in_count)
            self.inspector.add_stat("ReadingPointCount", reading.count_host())
        self.prefiltered_reading_pts_count = reading         # counted lazily
        t_loop = time.perf_counter()

        fused = self._fused()
        if fused:
            # per-registration matcher tables (BlockGridMatcher's tiling)
            aux = self.matcher.prepare_loop(reading)
            T_iter, iters, code, stats = self._run_loop(reading, reference, aux)
        else:
            self.matcher.invalidate_loop_state()
            T_iter, iters, code, stats = self._run_stepped(
                reading, reference, chain_key(seed, STEP_STREAM))
        iters, code = int(iters), int(code)

        self.max_num_iterations_reached = code == CODE_MAX_ITER
        self.last_iteration_count = iters
        self.last_code = code
        self.last_stats = stats
        self.motion_bound_exceeded = False
        if stats.motion_max is not None:
            motion = float(stats.motion_max)
            bound = float(self.matcher.motionBound)
            if motion > bound:
                self.motion_bound_exceeded = True
                log_warning(
                    f"{type(self.matcher).__name__}: max reading-point "
                    f"displacement bound {motion:.3f} exceeded motionBound "
                    f"{bound:.3f} during the loop: matches beyond the cells "
                    f"assigned at loop start may have been missed; raise "
                    f"motionBound (cell edge = maxDist + motionBound) or "
                    f"tighten the prior")
        if fused and wants_stats:
            # the stepped driver adds each iteration's pairs itself
            self.matcher.visit_count += iters * self.matcher.touched_per_iteration(
                reading, reference)
        if code == CODE_NAN_ERROR:
            raise ConvergenceError("abs rotation/translation norm not a number")
        if code == CODE_BOUND_ERROR:
            raise ConvergenceError(
                "transformation bound exceeded (BoundTransformationChecker)")
        if code == CODE_NO_INLIERS:
            raise ConvergenceError("ErrorMinimizer: no point to minimize")
        self.inspector.add_stat("IterationsCount", iters)
        self.inspector.add_stat("PointCountTouched", self.matcher.get_visit_count())
        self.matcher.reset_visit_count()
        self.last_overlap = None
        if reading.has_descriptor("simpleSensorNoise"):
            # one more match at the final pose (reference: PointToPoint.cpp:119-152)
            stepped = _apply_transform(self.transformations, reading, T_iter)
            matches = self.matcher.find_closests_in(stepped, reference)
            weights, _ = compute_outlier_weights(
                self.outlier_filters, stepped, reference, matches,
                init_outlier_states(self.outlier_filters, (), stepped.device))
            self.last_overlap = float(estimate_overlap(
                stepped, reference, weights, matches,
                stats.weighted_point_used_ratio))
        self.inspector.add_stat("OverlapRatio", self.get_overlap())
        self.inspector.add_stat("ConvergenceDuration", time.perf_counter() - t_loop)
        self.inspector.finish(iters)
        log_info(f"PointMatcher::icp - {iters} iterations took "
                 f"{time.perf_counter() - t_loop:.4f} s")
        # frame composition (reference: ICP.cpp:444-448)
        return T_refIn_refMean @ T_iter @ T_refMean_dataIn

    def _step(self, reading, reference, T_iter, checker_states, outlier_states,
              iteration, matcher_aux=None, matcher_state=None, checkers=None,
              step_filters=True):
        """One iteration (the JAX engine's ``_make_step``), for one scan or
        a batch, with the checkers' and the outlier filters' loop states →
        ``(T_new, checker states, outlier states, iterate, code, stats,
        matches, weights, matcher state)``.
        The reading step filters with a schedule apply first, at
        ``iteration`` (an int, or one per scan or lane), when every step
        filter has one; ``step_filters=False`` (the stepped driver, which
        applies the chain itself) leaves them out.
        With ``matcher_aux`` the matcher serves through its
        stateful route, returning its new loop state, if it has one, or
        takes the tables as ``aux``. ``checkers`` replaces the chain's own
        (the coarse pass of the queue)."""
        checkers = self.checkers if checkers is None else checkers
        if step_filters and self._step_chain_traced():
            for f in self.reading_step_filters:
                reading = f.mask_at_iteration(reading, iteration)
        stepped = _apply_transform(self.transformations, reading, T_iter)
        if matcher_aux is not None and self._stateful_matcher():
            matches, matcher_state = self.matcher.find_closests_in_stateful(
                stepped, reference, matcher_aux, matcher_state)
        elif matcher_aux is not None:
            matches = self.matcher.find_closests_in(stepped, reference,
                                                    aux=matcher_aux)
        else:
            matches = self.matcher.find_closests_in(stepped, reference)
        weights, outlier_states = compute_outlier_weights(
            self.outlier_filters, stepped, reference, matches, outlier_states)
        usable = torch.isfinite(matches.dists) & (weights != 0.0)
        no_inliers = ~usable.flatten(-2).any(dim=-1)
        T_delta, stats = self.error_minimizer.compute(stepped, reference,
                                                      weights, matches)
        T_new = T_delta @ T_iter
        iterate = torch.ones(T_new.shape[:-2], dtype=torch.bool,
                             device=T_new.device)
        code = torch.zeros(T_new.shape[:-2], dtype=torch.int32,
                           device=T_new.device)
        new_states = []
        for chk, st in zip(checkers, checker_states):
            st2, stop, c = chk.check(st, T_new, iteration)
            new_states.append(st2)
            iterate = iterate & ~stop
            code = torch.maximum(code, c)
        code = torch.where(no_inliers, CODE_NO_INLIERS, code).to(torch.int32)
        iterate = iterate & ~no_inliers
        return (T_new, new_states, outlier_states, iterate, code, stats,
                matches, weights, matcher_state)

    def _stateful_matcher(self) -> bool:
        """True when the matcher carries loop state (the survivor route)."""
        return hasattr(self.matcher, "find_closests_in_stateful")

    def _motion_tracker(self, reading, matcher_aux):
        """For a bounded-search matcher (one with ``motionBound``) served
        with loop tables → ``track(T) → bound [...]``, per scan, on the
        displacement of any reading point under the loop pose ``T`` from
        its loop-entry pose, where the tables were built; else None.
        Referenced to each scan's centroid c: for x within r of c,
        ‖Rx + t − x‖ ≤ sqrt(d − tr R)·r + ‖Rc + t − c‖ (the JAX engine's
        ``_motion_tracker``)."""
        if matcher_aux is None or getattr(self.matcher, "motionBound", None) is None:
            return None
        d = reading.dim
        cnt = torch.clamp(reading.count(), min=1)[..., None]
        c = torch.where(reading.mask[..., None], reading.points, 0.0
                        ).sum(dim=-2) / cnt
        r_local = torch.where(
            reading.mask, torch.linalg.norm(reading.points - c[..., None, :],
                                            dim=-1), 0.0).amax(dim=-1)

        def track(T):
            R, t = T[..., :d, :d], T[..., :d, d]
            sigma = torch.sqrt(torch.clamp(
                d - R.diagonal(dim1=-2, dim2=-1).sum(dim=-1), min=0.0))
            drift = torch.linalg.norm((R @ c[..., None])[..., 0] + t - c, dim=-1)
            return sigma * r_local + drift

        return track

    def _run_loop(self, reading, reference, matcher_aux=None):
        """Lockstep fixed-point loop over the reading's batch dimensions →
        ``(T_iter, iterations, codes, stats)``, one of each per scan (host
        ints for a single scan).

        Each iteration steps every scan, then keeps the new state only where
        the scan was still active; a stopped scan's rows are masked out of
        the next steps, so a sweep spends nothing on them. The loop ends
        when no scan is active, after one host read of the flags per
        iteration. A single scan (no batch dimension) is active for as long
        as the loop runs, so it skips the masking and the merges. For a
        bounded-search matcher ``stats.motion_max`` holds each scan's
        running displacement bound (:meth:`_motion_tracker`). With
        ``acceleration = "anderson"`` each step's pose goes through
        :func:`_anderson_step`, whose window a stopped scan keeps frozen."""
        bshape = reading.points.shape[:-2]
        dev = reading.device
        d = reading.dim
        T_iter = se3.identity(d, dev).expand(*bshape, d + 1, d + 1).clone()
        states = [c.init_state(T_iter) for c in self.checkers]
        ostates = init_outlier_states(self.outlier_filters, bshape, dev)
        mstate = (self.matcher.loop_state_init(reading, matcher_aux)
                  if matcher_aux is not None and self._stateful_matcher()
                  else None)
        window = (_anderson_init(bshape, d, int(self.acceleration_window), dev)
                  if self.acceleration == "anderson" else None)
        track = self._motion_tracker(reading, matcher_aux)
        motion = torch.zeros(bshape, device=dev)
        iteration = 0
        if not bshape:
            code = 0
            while True:
                T_new, states, ostates, iterate, c, stats, _, _, mstate = self._step(
                    reading, reference, T_iter, states, ostates, iteration,
                    matcher_aux, mstate)
                if window is not None:
                    T_new, window = _anderson_step(T_iter, T_new, window)
                T_iter = T_new
                if track is not None:
                    motion = torch.maximum(motion, track(T_iter))
                go, c = torch.stack([iterate.to(torch.int32), c]).tolist()
                iteration += 1
                code = max(code, c)
                if not go:
                    return (T_iter, iteration, code,
                            _with_motion(stats, motion, track))
        active = torch.ones(bshape, dtype=torch.bool, device=dev)
        iters = torch.zeros(bshape, dtype=torch.int32, device=dev)
        code = torch.zeros(bshape, dtype=torch.int32, device=dev)
        stats = None
        while True:
            live = reading.with_mask(active[..., None])
            (T_new, new_states, new_ostates, iterate, c, new_stats, _, _,
             new_mstate) = self._step(live, reference, T_iter, states, ostates,
                                      iteration, matcher_aux, mstate)
            if window is not None:
                T_new, new_window = _anderson_step(T_iter, T_new, window)
                window = _keep_active(active, new_window, window)
            if track is not None:
                motion = torch.where(active, torch.maximum(motion, track(T_new)),
                                     motion)
            T_iter = _keep_active(active, T_new, T_iter)
            states = _keep_active(active, new_states, states)
            ostates = _keep_active(active, new_ostates, ostates)
            mstate = _keep_active(active, new_mstate, mstate)
            stats = (new_stats if stats is None
                     else _keep_active(active, new_stats, stats))
            iters = iters + active.to(torch.int32)
            code = torch.where(active, torch.maximum(code, c), code)
            active = active & iterate
            iteration += 1
            if not bool(active.any()):
                return T_iter, iters, code, _with_motion(stats, motion, track)

    def _run_stepped(self, reading, reference, key):
        """The stepped driver (the JAX engine's ``_run_stepped``), one scan
        → ``(T_iter, iterations, code, stats)``.

        The step filters' ``init()`` runs once; each iteration then applies
        the step chain to the reading on the key ``fold_in(key,
        iteration)`` without compacting (a filter that empties the reading
        raises ``ConvergenceError``), runs one step without loop tables,
        adds the step's touched pairs to the matcher's ``visit_count`` and,
        for an inspector that dumps iterations, hands it host copies of the
        new pose, the reference, the moved reading, the matches and the
        weights. Two host reads an iteration, more with the dumps."""
        d = reading.dim
        dev = reading.device
        T_iter = se3.identity(d, dev)
        states = [c.init_state(T_iter) for c in self.checkers]
        ostates = init_outlier_states(self.outlier_filters, (), dev)
        for f in self.reading_step_filters:
            f.init()
        dumps = self.inspector.needs_iteration_data
        reference_host = reference.to("cpu") if dumps else None
        iteration = code = 0
        while True:
            step_reading = reading
            if self.reading_step_filters:
                step_reading = apply_filter_chain(
                    self.reading_step_filters, reading,
                    prng.fold_in(key, iteration), compact=False)
            T_new, states, ostates, iterate, c, stats, matches, weights, _ = \
                self._step(step_reading, reference, T_iter, states, ostates,
                           iteration, step_filters=False)
            self.matcher.visit_count += self.matcher.touched_per_iteration(
                step_reading, reference)
            if dumps:
                moved = _apply_transform(self.transformations, step_reading, T_iter)
                self.inspector.dump_iteration(
                    iteration, T_new.cpu(), reference_host, moved.to("cpu"),
                    Matches(matches.dists.cpu(), matches.ids.cpu()),
                    weights.cpu(), self.checkers)
            T_iter = T_new
            go, c = torch.stack([iterate.to(torch.int32), c]).tolist()
            code = max(code, c)
            iteration += 1
            if not go or code >= CODE_NAN_ERROR:
                return T_iter, iteration, code, stats


    def _run_queue(self, pool, reference, T0, lanes: int, checkers=None,
                   matcher_aux=None, pool_aux=None):
        """Continuous-batching loop over a pool of Q prepped scans
        (``[Q, rows, d]``, the counterpart of the JAX queue program,
        ``parallel/stream.py``) → ``(T_iter, iterations, codes, stats)``,
        one of each per scan, on the engine's device.

        ``lanes`` lanes step in lockstep through :meth:`_step`, lane l
        starting on scan l from ``T0[l]``; a step filter's schedule reads
        each lane's own iteration count. After each iteration the host
        reads the ``[L]`` flags once. A lane whose checkers stopped writes
        its scan's pose, iteration count, code and statistics to the scan's
        output slot and takes the next queued scan, simultaneous finishers
        in lane order: the lanes' rows, and their rows of the per-scan
        matcher tables ``pool_aux`` (``[Q, ...]`` each, beside the shared
        ``matcher_aux``), are gathered from the pools again, and that
        lane's pose is set to the scan's ``T0``, its checker and outlier
        filter states, iteration count, code, matcher loop state and
        displacement bound started afresh; each call, so each pass of the
        coarse-to-fine queue, starts every lane so. A lane left without a
        scan is masked out of the remaining steps."""
        checkers = list(self.checkers if checkers is None else checkers)
        q = pool.points.shape[0]
        dev = pool.device
        n_lanes = min(int(lanes), q)
        lane_scan = list(range(n_lanes))          # host: -1 = idle lane
        next_scan = n_lanes
        lane_now = torch.arange(n_lanes, device=dev)
        reading = _lanes(pool, lane_now)
        aux = _lane_aux(matcher_aux, pool_aux, lane_now)
        T_iter = T0[:n_lanes].clone()
        states = _lane_form([c.init_state(T_iter) for c in checkers], n_lanes, dev)
        ostates = init_outlier_states(self.outlier_filters, (n_lanes,), dev)
        stateful = aux is not None and self._stateful_matcher()
        mstate = self.matcher.loop_state_init(reading, aux) if stateful else None
        track = self._motion_tracker(reading, aux)
        motion = torch.zeros(n_lanes, device=dev)
        iters = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        code = torch.zeros(n_lanes, dtype=torch.int32, device=dev)
        out_T = T0.clone()
        out_iters = torch.zeros(q, dtype=torch.int32, device=dev)
        out_code = torch.zeros(q, dtype=torch.int32, device=dev)
        out_motion = torch.zeros(q, device=dev)
        out_stats = None
        while True:
            T_iter, states, ostates, iterate, c, stats, _, _, mstate = self._step(
                reading, reference, T_iter, states, ostates, iters, aux, mstate,
                checkers)
            if track is not None:
                motion = torch.maximum(motion, track(T_iter))
            iters = iters + 1
            code = torch.maximum(code, c)
            go = iterate.tolist()                 # the one host read
            done = [l for l, s in enumerate(lane_scan) if s >= 0 and not go[l]]
            if not done:
                continue
            scans = [lane_scan[l] for l in done]
            fresh = [False] * n_lanes
            for l in done:
                lane_scan[l] = next_scan if next_scan < q else -1
                fresh[l] = next_scan < q
                next_scan += fresh[l]
            # one copy to the card: finished lanes, their scans, the lanes'
            # new scans and which lanes took one
            idx = torch.as_tensor(done + scans + lane_scan + fresh, device=dev)
            k = len(done)
            lanes_d, scans_d = idx[:k], idx[k:2 * k]
            lane_now, fresh = idx[2 * k:2 * k + n_lanes], idx[2 * k + n_lanes:] > 0
            out_T[scans_d] = T_iter[lanes_d]
            out_iters[scans_d] = iters[lanes_d]
            out_code[scans_d] = code[lanes_d]
            out_motion[scans_d] = motion[lanes_d]
            if out_stats is None:
                out_stats = type(stats)(*(
                    None if s is None else
                    torch.zeros((q,) + s.shape[1:], dtype=s.dtype, device=dev)
                    for s in stats))
            for o, s in zip(out_stats, stats):
                if s is not None:
                    o[scans_d] = s[lanes_d]
            if all(s < 0 for s in lane_scan):
                return (out_T, out_iters, out_code,
                        _with_motion(out_stats, out_motion, track))
            reading = _lanes(pool, lane_now)
            if pool_aux is not None:
                aux = _lane_aux(matcher_aux, pool_aux, lane_now)
            T_iter = torch.where(fresh[:, None, None], T0[lane_now.clamp(min=0)],
                                 T_iter)
            states = _keep_active(fresh, _lane_form(
                [c.init_state(T_iter) for c in checkers], n_lanes, dev), states)
            ostates = _keep_active(fresh, init_outlier_states(
                self.outlier_filters, (n_lanes,), dev), ostates)
            iters = torch.where(fresh, 0, iters)
            code = torch.where(fresh, 0, code)
            if mstate is not None:
                mstate = _keep_active(fresh, self.matcher.loop_state_init(
                    reading, aux), mstate)
            if track is not None:
                track = self._motion_tracker(reading, aux)
                motion = torch.where(fresh, 0.0, motion)


def _lane_form(state, n_lanes: int, device):
    """Checker states with every host-int leaf made a ``[L]`` tensor, so
    that lanes at different iterations keep their own values."""
    if isinstance(state, bool) or not isinstance(state, (int, tuple, list)):
        return state
    if isinstance(state, int):
        return torch.full((n_lanes,), state, dtype=torch.int32, device=device)
    return type(state)(_lane_form(s, n_lanes, device) for s in state)


def _with_motion(stats, motion, track):
    """``stats`` with the displacement bound, when one was tracked."""
    return stats if track is None else stats._replace(motion_max=motion)


def _lane_aux(shared, per_scan, lane_scan: torch.Tensor):
    """The lanes' matcher tables: the ``shared`` ones and the lanes' rows
    of each ``[Q, ...]`` per-scan table (None when there are neither)."""
    if per_scan is None:
        return shared
    at = lane_scan.clamp(min=0)
    return {**(shared or {}), **{k: v[at] for k, v in per_scan.items()}}


def _lanes(pool: PointCloud, lane_scan: torch.Tensor) -> PointCloud:
    """The lanes' cloud: scan ``lane_scan[l]`` of a ``[Q, rows, d]`` pool
    in lane l, a lane without a scan (−1) masked."""
    at = lane_scan.clamp(min=0)
    return PointCloud(pool.points[at], pool.mask[at] & (lane_scan >= 0)[:, None],
                      {k: v[at] for k, v in pool.descriptors.items()})


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
                                   chain_key(seed, REFERENCE_STREAM))
        cloud, T = _center_cloud(cloud)
        self._install_map(cloud, T)
        return True

    def _install_map(self, cloud: PointCloud, T_refIn_refMean: torch.Tensor):
        self._map = cloud
        self._T_refIn_refMean = T_refIn_refMean
        # the JAX engine holds its map at the valid count rounded up to 512
        self.matcher.init(cloud, rows=512 * math.ceil(max(cloud.count_host(), 1) / 512))
        self.prefiltered_reference_pts_count = cloud.count_host()

    def has_map(self) -> bool:
        return self._map is not None

    def clear_map(self) -> None:
        self._map = None
        self._T_refIn_refMean = None

    def warmup(self, num_points: int, batch: int = 8, lanes=None,
               queue_len=None, coarse=None, seed: int = 0,
               example: Optional[PointCloud] = None) -> float:
        """Run one serving batch of ``batch`` scans of ``num_points`` rows
        and, with ``queue_len``, one queue of that many scans over
        ``lanes`` lanes (default ``batch``), with its coarse pass when
        ``coarse`` is given, so that the first real request finds the
        kernels built and the map's sweep tables made. The scan is
        ``example`` if given, else points drawn uniformly in the map's
        bounding box. A ``BlockGridMatcher`` has its map's sub-blocks from
        ``set_map``; on the card its kernels (``csrc/tile.cu``) are built
        here first. Returns the wall seconds spent."""
        from .ops import tile_cuda
        from .parallel.batch import register_batch_to_map
        from .parallel.stream import register_queue_to_map

        if not self.has_map():
            raise RuntimeError("set_map first")
        t0 = time.perf_counter()
        if self.device.type == "cuda" and has_host_tables(self.matcher):
            tile_cuda.build()
        scan = example
        if scan is None:
            pts, _ = self.get_prefiltered_internal_map().to_numpy()
            rng = np.random.default_rng(seed)
            fake = rng.uniform(pts.min(axis=0), pts.max(axis=0),
                               size=(int(num_points), pts.shape[1]))
            scan = PointCloud.from_numpy(fake.astype(np.float32),
                                         device=self.device)
        register_batch_to_map(self, [scan] * int(batch), seed=seed)
        if queue_len:
            register_queue_to_map(self, [scan] * int(queue_len), seed=seed,
                                  lanes=int(lanes or batch), coarse=coarse)
        return time.perf_counter() - t0

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
        self.inspector.init()
        T_init = self._as_pose(T_init, reading.dim)
        if self._map is None:
            log_warning("ICPSequence: no map, returning identity")
            return T_init
        return self.compute_with_transformed_reference(
            reading, self._map, self._T_refIn_refMean, T_init, seed)
