"""Error minimizers: weighted matched pairs → incremental transformation
(counterpart of ``libpointmatcher_tpu.minimizers``; reference:
PointMatcher.h:527-577, ErrorMinimizers/).

Every pair stays in place with an effective weight that is zero for
rejected or invalid pairs, so all reductions are weighted sums over fixed
shapes (the reference gathers the kept pairs first, ErrorMinimizer.cpp:59-193).
A batch of scans (reading ``[B, N, d]``, matches ``[B, N, knn]``) against
one shared reference, or against one reference each (``[B, M, d]``, the
pair-parallel registration), gives one transform and one set of statistics per
scan.

On the card, ``PointToPlaneErrorMinimizer`` for 3-D input at six degrees of
freedom runs as one hand-written kernel pair (``ops/plane_cuda.py``,
``csrc/plane.cu``): the normal equations, the JAX package's Jacobi solve and
the statistics, with no host read. Every other case keeps the torch body
below, whose ``torch.linalg.eigh`` reads its error flags on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import telemetry
from .errors import InvalidParameter
from .ops import plane_cuda
from .registry import Param, Parametrizable, Registrar
from .utils import se3

__all__ = ["ErrorMinimizer", "ErrorMinimizerRegistrar", "MinimizerStats",
           "Pairs", "gather_rows", "make_pairs", "gather_pair_descriptor",
           "build_stats", "rejection_counts", "solve_possibly_underdetermined",
           "estimate_overlap",
           "IdentityErrorMinimizer", "PointToPointErrorMinimizer",
           "PointToPointSimilarityErrorMinimizer", "PointToPlaneErrorMinimizer",
           "PointToPointWithCovErrorMinimizer",
           "PointToPlaneWithCovErrorMinimizer"]

ErrorMinimizerRegistrar = Registrar("ErrorMinimizer")


class MinimizerStats(NamedTuple):
    """The JAX package's fields, in its order."""

    point_used_ratio: torch.Tensor
    weighted_point_used_ratio: torch.Tensor
    residual: torch.Tensor
    #: [..., 6, 6] for the WithCov minimizers, else None
    covariance: Optional[torch.Tensor] = None
    nb_rejected_matches: object = 0
    nb_rejected_points: object = 0
    #: the engine's running bound on reading-point displacement, for a
    #: bounded-search matcher served with loop tables (else None)
    motion_max: Optional[torch.Tensor] = None


class Pairs(NamedTuple):
    """Flat matched-pair view, one row per (reading point, match) pair."""

    w: torch.Tensor       # [..., P] effective weight (0 = rejected/invalid)
    read: torch.Tensor    # [..., P, d]
    ref: torch.Tensor     # [..., P, d]
    ids: torch.Tensor     # [..., P] reference row ids (0 where invalid)
    valid: torch.Tensor   # [..., P] bool


def _valid_pairs(weights, matches):
    return torch.isfinite(matches.dists) & (weights != 0.0)


def gather_rows(table: torch.Tensor, ids: torch.Tensor,
                cloud=None) -> torch.Tensor:
    """Rows ``ids [..., P]`` of ``table``: a shared ``[M, s]`` one, or
    ``[B, M, s]`` with one table per scan (a pair axis) → ``[..., P, s]``.
    ``cloud`` is the cloud whose rows ``table`` holds: one laid out over a
    mesh (``parallel.sharding.ShardedCloud``) holds only its rank's rows,
    and completes the gather of global ids over the mesh."""
    if getattr(cloud, "mesh", None) is not None:
        return cloud.gather(table, ids)
    if table.ndim == 2:
        return table[ids]
    return torch.gather(table, -2,
                        ids[..., None].expand(*ids.shape, table.shape[-1]))


def make_pairs(reading, reference, weights, matches) -> Pairs:
    """Masked equivalent of the ErrorElements gather
    (reference: ErrorMinimizer.cpp:59-193); each scan of a batch indexes
    the shared reference, or its own under a pair axis."""
    *b, n, k = matches.dists.shape
    d = reading.dim
    valid = _valid_pairs(weights, matches)
    ids = torch.clamp(matches.ids, min=0).to(torch.int64).reshape(*b, n * k)
    return Pairs(
        w=torch.where(valid, weights, torch.zeros_like(weights)).reshape(*b, -1),
        read=reading.points[..., None, :].expand(*b, n, k, d).reshape(*b, -1, d),
        ref=gather_rows(reference.points, ids, reference),
        ids=ids,
        valid=valid.reshape(*b, -1))


def gather_pair_descriptor(cloud_desc: torch.Tensor, pairs: Pairs, side: str,
                           knn: int, cloud=None) -> torch.Tensor:
    """Descriptor values per pair: the reading's repeat over its ``knn``
    matches, the reference's are gathered at the matched rows (of
    ``cloud``, as :func:`gather_rows` takes it)."""
    if side == "reading":
        *b, n, sp = cloud_desc.shape
        return cloud_desc[..., None, :].expand(*b, n, knn, sp).reshape(*b, -1, sp)
    return gather_rows(cloud_desc, pairs.ids, cloud)


def _used_ratios(reading, weights, matches):
    """pointUsedRatio / weightedPointUsedRatio over knn·(reading count)
    (reference: ErrorMinimizer.cpp:139-140)."""
    k = matches.dists.shape[-1]
    valid = _valid_pairs(weights, matches)
    denom = torch.clamp(k * reading.count(), min=1).to(torch.float32)
    return (valid.sum(dim=(-2, -1)) / denom,
            torch.where(valid, weights, torch.zeros_like(weights)
                        ).sum(dim=(-2, -1)) / denom)


def rejection_counts(reading, weights, matches):
    """(nbRejectedMatches, nbRejectedPoints) (reference:
    ErrorMinimizer.cpp:101-135)."""
    finite = torch.isfinite(matches.dists)
    kept = finite & (weights != 0.0)
    rejected_matches = (finite & (weights == 0.0)).sum(dim=(-2, -1)).to(torch.int32)
    rejected_points = (reading.mask & ~kept.any(dim=-1)).sum(dim=-1).to(torch.int32)
    return rejected_matches, rejected_points


def build_stats(reading, weights, matches, residual,
                covariance=None) -> MinimizerStats:
    pr, wr = _used_ratios(reading, weights, matches)
    rm, rp = rejection_counts(reading, weights, matches)
    return MinimizerStats(pr, wr, residual, covariance, rm, rp)


def estimate_overlap(reading, reference, weights, matches, weighted_ratio):
    """The overlap estimate of PointToPoint::getOverlap (reference:
    PointToPoint.cpp:119-152), per scan: the share of valid pairs whose
    distance is under the mean pair distance plus the reading point's
    ``simpleSensorNoise``; ``weighted_ratio`` when the reading has no such
    descriptor."""
    if not reading.has_descriptor("simpleSensorNoise"):
        return weighted_ratio
    pairs = make_pairs(reading, reference, weights, matches)
    knn = matches.dists.shape[-1]
    noises = gather_pair_descriptor(reading.get_descriptor("simpleSensorNoise"),
                                    pairs, "reading", knn)[..., 0]
    dists = torch.linalg.vector_norm(pairs.read - pairs.ref, dim=-1)
    nvalid = torch.clamp(pairs.valid.sum(dim=-1), min=1)
    mean = torch.where(pairs.valid, dists, 0.0).sum(dim=-1) / nvalid
    hit = pairs.valid & (dists < mean[..., None] + noises)
    return hit.sum(dim=-1) / nvalid


def solve_possibly_underdetermined(A: torch.Tensor, b: torch.Tensor):
    """Minimal-norm solve of the symmetric PSD normal equations by an
    eigendecomposition pseudo-inverse with the JAX package's relative rank
    cutoff ``max|w|·p·1e-7``: the Cholesky solution at full rank, the
    minimal-norm one when singular (reference: PointToPlane.cpp:108-161).
    A ridge is not a substitute: f32 rounding leaves right-hand components
    along exactly singular directions, which a ridge amplifies and the
    cutoff zeroes."""
    p = A.shape[-1]
    # eigh reads its error flags on the host: one wait on the device
    telemetry.sync(A.device)
    w, V = torch.linalg.eigh(0.5 * (A + A.mT))
    tol = torch.amax(torch.abs(w), dim=-1, keepdim=True) * p * 1e-7
    keep = w > tol
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    return (V @ (winv * (V.mT @ b[..., None])[..., 0])[..., None])[..., 0]


class ErrorMinimizer(Parametrizable):
    """Interface (reference: PointMatcher.h:527-577)."""

    #: whether compute() fills MinimizerStats.covariance (the WithCov ones)
    PRODUCES_COVARIANCE = False

    def compute(self, reading, reference, weights, matches):
        raise NotImplementedError

    def residual_error(self, reading, reference, weights, matches):
        pairs = make_pairs(reading, reference, weights, matches)
        return self._residual(pairs, reading, reference)

    def _residual(self, pairs: Pairs, reading, reference):
        """Point-to-point residual Σ‖Δ‖ over the kept pairs, unweighted
        (reference: PointToPoint.cpp:155-164)."""
        norms = torch.linalg.norm(pairs.read - pairs.ref, dim=-1)
        return torch.sum(torch.where(pairs.valid, norms, torch.zeros_like(norms)),
                         dim=-1)


@ErrorMinimizerRegistrar.register
class IdentityErrorMinimizer(ErrorMinimizer):
    """Returns the identity transform (reference: ErrorMinimizers/Identity.cpp)."""

    def compute(self, reading, reference, weights, matches):
        bshape = matches.dists.shape[:-2]
        d = reading.dim
        T = se3.identity(d, reading.device).expand(*bshape, d + 1, d + 1).clone()
        residual = torch.zeros(bshape, dtype=torch.float32, device=reading.device)
        return T, build_stats(reading, weights, matches, residual)


def _kabsch(pairs: Pairs, d: int, with_scale: bool = False) -> torch.Tensor:
    """Weighted Kabsch/Umeyama solve of the point-to-point family, one per
    scan (reference: PointToPoint.cpp:62-101,
    PointToPointSimilarity.cpp:60-97)."""
    w = pairs.w
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-20)[..., None]
    mean_read = torch.sum(w[..., None] * pairs.read, dim=-2) / wsum
    mean_ref = torch.sum(w[..., None] * pairs.ref, dim=-2) / wsum
    rc = pairs.read - mean_read[..., None, :]
    fc = pairs.ref - mean_ref[..., None, :]
    # cross-covariance m = referenceᵀ·diag(w)·reading → [..., d, d], summed
    # by a reduction over the pairs (a GEMM with tens of thousands of terms
    # in its inner dimension adds them in long runs: its rounding on the
    # card and on the CPU drifts apart by ~1e-5 relative)
    m = torch.sum((fc * w[..., None])[..., :, None] * rc[..., None, :], dim=-3)
    U, S, Vh = torch.linalg.svd(m)
    det = torch.linalg.det(U @ Vh)
    # Sorkine's reflection fix: flip the last singular vector when a
    # proper rotation needs it (reference: PointToPoint.cpp:86-94)
    flip = torch.where(det < 0.0, -1.0, 1.0)
    D = torch.ones_like(S)
    D[..., -1] = flip
    R = (U * D[..., None, :]) @ Vh
    if with_scale:
        sigma = torch.sum(w * torch.sum(rc * rc, dim=-1), dim=-1)
        s_signed = S.clone()
        s_signed[..., -1] = S[..., -1] * flip
        scale = torch.sum(s_signed, dim=-1) / torch.clamp(sigma, min=1e-20)
        scale = torch.where(sigma < 1e-4, torch.ones_like(scale), scale)
        t = mean_ref - scale[..., None] * (R @ mean_read[..., None])[..., 0]
        return se3.from_rt(scale[..., None, None] * R, t)
    t = mean_ref - (R @ mean_read[..., None])[..., 0]
    return se3.from_rt(R, t)


@ErrorMinimizerRegistrar.register
class PointToPointErrorMinimizer(ErrorMinimizer):
    """Weighted Kabsch rigid solve (reference: ErrorMinimizers/PointToPoint.cpp,
    \\cite{Besl1992Point2Point})."""

    def compute(self, reading, reference, weights, matches):
        pairs = make_pairs(reading, reference, weights, matches)
        T = _kabsch(pairs, reading.dim)
        return T, build_stats(reading, weights, matches,
                              self._residual(pairs, reading, reference))


@ErrorMinimizerRegistrar.register
class PointToPointSimilarityErrorMinimizer(ErrorMinimizer):
    """Umeyama similarity solve — rotation, translation and uniform scale
    (reference: ErrorMinimizers/PointToPointSimilarity.cpp)."""

    def compute(self, reading, reference, weights, matches):
        pairs = make_pairs(reading, reference, weights, matches)
        T = _kabsch(pairs, reading.dim, with_scale=True)
        return T, build_stats(reading, weights, matches,
                              self._residual(pairs, reading, reference))


@ErrorMinimizerRegistrar.register
class PointToPlaneErrorMinimizer(ErrorMinimizer):
    r"""Linearized point-to-plane least squares
    (reference: ErrorMinimizers/PointToPlane.cpp, \cite{Chen1991Point2Plane})."""

    PARAMS = (
        Param("force2D", "force minimization in the XY plane for 3D input",
              bool, False),
        Param("force4DOF", "yaw-only rotation (z axis) + 3D translation "
              "(reference: PointToPlane.cpp:197-210)", bool, False),
    )

    def __init__(self, params=None):
        super().__init__(params)
        if self.force2D and self.force4DOF:
            raise InvalidParameter("force2D and force4DOF are mutually exclusive")

    def _solve(self, reading, reference, weights, matches,
               solve=solve_possibly_underdetermined):
        """→ ``(T, pairs, normals [..., P, d], dot [..., P])``; ``solve``
        takes the normal equations ``(A, b)`` to ``x``."""
        d = reading.dim
        pairs = make_pairs(reading, reference, weights, matches)
        normals = gather_rows(reference.get_descriptor("normals"),
                              pairs.ids, reference)       # [..., P, d]
        w = pairs.w
        delta = pairs.read - pairs.ref
        if d == 2 or self.force2D:
            read2, nrm, delta2 = pairs.read[..., :2], normals[..., :2], delta[..., :2]
            # 2D pseudo-cross x·ny − y·nx (reference: ErrorMinimizer.cpp:305-311)
            cross = read2[..., 0] * nrm[..., 1] - read2[..., 1] * nrm[..., 0]
            F = torch.cat([cross[..., None], nrm], dim=-1)
            dot = torch.sum(delta2 * nrm, dim=-1)
        elif self.force4DOF:
            # d(R_z p)/dγ · n = (Γp)·n, Γ = [[0,-1,0],[1,0,0],[0,0,0]]
            gp = torch.stack([-pairs.read[..., 1], pairs.read[..., 0],
                              torch.zeros_like(pairs.read[..., 0])], dim=-1)
            F = torch.cat([torch.sum(gp * normals, dim=-1)[..., None], normals],
                          dim=-1)
            dot = torch.sum(delta * normals, dim=-1)
        else:
            F = torch.cat([torch.linalg.cross(pairs.read, normals, dim=-1),
                           normals], dim=-1)
            dot = torch.sum(delta * normals, dim=-1)
        wF = w[..., None] * F
        A = wF.mT @ F          # (reference: PointToPlane.cpp:213-230)
        b = -(wF.mT @ dot[..., None])[..., 0]
        x = solve(A, b)

        if d == 2:
            T = se3.from_rt(se3.rot2d(x[..., 0]), x[..., 1:3])
        elif self.force2D:
            R = se3.from_rt(se3.rot2d(x[..., 0]), torch.zeros_like(x[..., :2]))
            T = se3.from_rt(R, torch.cat([x[..., 1:3], torch.zeros_like(x[..., :1])],
                                         dim=-1))
        elif self.force4DOF:
            axis = torch.tensor([0.0, 0.0, 1.0], device=x.device)
            T = se3.from_rt(se3.rodrigues(axis * x[..., :1]), x[..., 1:4])
        else:
            T = se3.from_rt(se3.rodrigues(x[..., :3]), x[..., 3:6])
        return T, pairs, normals, dot

    def _kernel_path(self, reading) -> bool:
        """Whether :meth:`compute` runs on the kernel pair of
        ``ops/plane_cuda.py``: on the card, for 3-D input at six degrees of
        freedom, and not for the WithCov minimizer, which needs the
        per-pair arrays. Every other case keeps :meth:`_solve`."""
        return (not self.PRODUCES_COVARIANCE and reading.device.type == "cuda"
                and reading.dim == 3 and not self.force2D and not self.force4DOF)

    def _kernel(self, reading, reference, weights, matches):
        """:meth:`compute` on the kernel pair. A reference laid out over a
        mesh gives each scan a table of its pairs' map rows and normals,
        gathered over the mesh, read at slot ids ``0..n·k−1``: every slot
        reads the values the single-device tables hold, in the same order,
        so the result is the single-device one bit for bit."""
        points = reference.points
        normals = reference.get_descriptor("normals")
        ids = matches.ids
        if getattr(reference, "mesh", None) is not None:
            *b, n, k = ids.shape
            rows = torch.clamp(ids, min=0).to(torch.int64).reshape(*b, n * k)
            points = gather_rows(points, rows, reference)
            normals = gather_rows(normals, rows, reference)
            ids = torch.arange(n * k, dtype=torch.int32, device=ids.device
                               ).reshape(n, k).expand(ids.shape)
        out = plane_cuda.point_to_plane(reading.points, reading.mask, points,
                                        normals, matches.dists, ids, weights)
        return out.T, MinimizerStats(
            out.point_used_ratio, out.weighted_point_used_ratio,
            out.residual, None, out.rejected_matches, out.rejected_points)

    def compute(self, reading, reference, weights, matches):
        on_kernel = self._kernel_path(reading)
        telemetry.sample("minimize_kernel_share", float(on_kernel))
        if on_kernel:
            return self._kernel(reading, reference, weights, matches)
        T, pairs, _, dot = self._solve(reading, reference, weights, matches)
        residual = torch.sum(pairs.w * dot * dot, dim=-1)
        return T, build_stats(reading, weights, matches, residual)

    def residual_error(self, reading, reference, weights, matches):
        pairs = make_pairs(reading, reference, weights, matches)
        normals = gather_pair_descriptor(reference.get_descriptor("normals"),
                                         pairs, "reference",
                                         matches.dists.shape[-1], reference)
        dot = torch.sum((pairs.read - pairs.ref) * normals, dim=-1)
        return torch.sum(pairs.w * dot * dot, dim=-1)


#: the JAX package's pinv cutoff for a 6x6 matrix, 10·6·eps(float32),
#: relative to the largest singular value (``jnp.linalg.pinv``'s default)
_PINV_RTOL = 10.0 * 6 * 2.0 ** -23


def _pinv(A: torch.Tensor) -> torch.Tensor:
    """Pseudo-inverse as ``jnp.linalg.pinv`` forms it: singular values at
    or below ``_PINV_RTOL`` times the largest are dropped."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    S = torch.where(S > _PINV_RTOL * S[..., :1], S, torch.full_like(S, float("inf")))
    return Vh.mT @ (U.mT / S[..., None])


def _censi_covariance(pairs: Pairs, normals, T, sensor_std_dev: float):
    """Censi's 6x6 covariance of the estimated transform, one per scan
    (reference: PointToPlaneWithCov.cpp:73-162 and PointToPointWithCov.cpp:
    62-150, \\cite{Censi2007ICPCovariance})."""
    # Euler angles of each scan's transform (the reference's convention)
    beta = -torch.asin(torch.clamp(T[..., 2, 0], -1.0, 1.0))
    cosb = torch.cos(beta)
    alpha = torch.atan2(T[..., 2, 1], T[..., 2, 2])
    gamma = torch.atan2(T[..., 1, 0] / cosb, T[..., 0, 0] / cosb)
    a, b, g = alpha[..., None], beta[..., None], gamma[..., None]
    t = T[..., :3, 3, None]                     # [..., 3, 1]: over the pairs

    p, q, n = pairs.read, pairs.ref, normals    # [..., P, 3]
    m = pairs.valid.to(p.dtype)[..., None]

    rr = torch.clamp(torch.linalg.norm(p, dim=-1), min=1e-20)
    rd = p / rr[..., None]
    fr = torch.clamp(torch.linalg.norm(q, dim=-1), min=1e-20)
    fd = q / fr[..., None]
    n0, n1, n2 = n[..., 0], n[..., 1], n[..., 2]
    n_abg = torch.stack([n2 * rd[..., 1] - n1 * rd[..., 2],
                         n0 * rd[..., 2] - n2 * rd[..., 0],
                         n1 * rd[..., 0] - n0 * rd[..., 1]], dim=-1)
    E = (n0 * (p[..., 0] - g * p[..., 1] + b * p[..., 2] + t[..., 0, :] - q[..., 0])
         + n1 * (g * p[..., 0] + p[..., 1] - a * p[..., 2] + t[..., 1, :] - q[..., 1])
         + n2 * (-b * p[..., 0] + a * p[..., 1] + p[..., 2] + t[..., 2, :] - q[..., 2]))
    N_read = (n0 * (rd[..., 0] - g * rd[..., 1] + b * rd[..., 2])
              + n1 * (g * rd[..., 0] + rd[..., 1] - a * rd[..., 2])
              + n2 * (-b * rd[..., 0] + a * rd[..., 1] + rd[..., 2]))
    N_ref = -torch.sum(n * fd, dim=-1)

    v_h = torch.cat([n, rr[..., None] * n_abg], dim=-1)            # [..., P, 6]
    J_hessian = (v_h * m).mT @ v_h
    coef_read = E + rr * N_read
    v_read = torch.cat([n * N_read[..., None], n_abg * coef_read[..., None]], dim=-1)
    v_ref = torch.cat([n * N_ref[..., None], (fr * N_ref)[..., None] * n_abg], dim=-1)
    d2 = (v_read * m).mT @ v_read + (v_ref * m).mT @ v_ref
    inv_h = _pinv(J_hessian)
    return (sensor_std_dev * sensor_std_dev) * (inv_h @ d2 @ inv_h)


@ErrorMinimizerRegistrar.register
class PointToPointWithCovErrorMinimizer(PointToPointErrorMinimizer):
    """PointToPoint + Censi covariance of the estimated transform
    (reference: ErrorMinimizers/PointToPointWithCov.cpp)."""

    PRODUCES_COVARIANCE = True
    PARAMS = (
        Param("sensorStdDev", "sensor noise standard deviation", float, 0.01,
              min=0.0),
    )

    def compute(self, reading, reference, weights, matches):
        T, stats = super().compute(reading, reference, weights, matches)
        pairs = make_pairs(reading, reference, weights, matches)
        cov = _censi_covariance(pairs, torch.ones_like(pairs.read), T,
                                self.sensorStdDev)
        return T, stats._replace(covariance=cov)


@ErrorMinimizerRegistrar.register
class PointToPlaneWithCovErrorMinimizer(PointToPlaneErrorMinimizer):
    """PointToPlane + Censi covariance of the estimated transform
    (reference: ErrorMinimizers/PointToPlaneWithCov.cpp)."""

    PRODUCES_COVARIANCE = True
    PARAMS = PointToPlaneErrorMinimizer.PARAMS + (
        Param("sensorStdDev", "sensor noise standard deviation", float, 0.01,
              min=0.0),
    )

    def compute(self, reading, reference, weights, matches):
        telemetry.sample("minimize_kernel_share", 0.0)
        T, pairs, normals, dot = self._solve(reading, reference, weights, matches)
        residual = torch.sum(pairs.w * dot * dot, dim=-1)
        cov = _censi_covariance(pairs, normals, T, self.sensorStdDev)
        return T, build_stats(reading, weights, matches, residual, cov)
