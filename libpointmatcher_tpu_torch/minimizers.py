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
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .errors import InvalidParameter
from .registry import Param, Parametrizable, Registrar
from .utils import se3

__all__ = ["ErrorMinimizer", "ErrorMinimizerRegistrar", "MinimizerStats",
           "Pairs", "gather_rows", "make_pairs", "build_stats", "rejection_counts",
           "solve_possibly_underdetermined", "PointToPlaneErrorMinimizer"]

ErrorMinimizerRegistrar = Registrar("ErrorMinimizer")


class MinimizerStats(NamedTuple):
    point_used_ratio: torch.Tensor
    weighted_point_used_ratio: torch.Tensor
    residual: torch.Tensor
    nb_rejected_matches: torch.Tensor
    nb_rejected_points: torch.Tensor
    #: the engine's running bound on reading-point displacement, for a
    #: bounded-search matcher served with loop tables (else None)
    motion_max: Optional[torch.Tensor] = None


class Pairs(NamedTuple):
    """Flat matched-pair view, one row per (reading point, match) pair."""

    w: torch.Tensor       # [..., P] effective weight (0 = rejected/invalid)
    read: torch.Tensor    # [..., P, d]
    ref: torch.Tensor     # [..., P, d]
    ids: torch.Tensor     # [..., P] reference row ids (0 where invalid)


def _valid_pairs(weights, matches):
    return torch.isfinite(matches.dists) & (weights != 0.0)


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows ``ids [..., P]`` of ``table``: a shared ``[M, s]`` one, or
    ``[B, M, s]`` with one table per scan (a pair axis) → ``[..., P, s]``."""
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
        ref=gather_rows(reference.points, ids),
        ids=ids)


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


def build_stats(reading, weights, matches, residual) -> MinimizerStats:
    pr, wr = _used_ratios(reading, weights, matches)
    rm, rp = rejection_counts(reading, weights, matches)
    return MinimizerStats(pr, wr, residual, rm, rp)


def solve_possibly_underdetermined(A: torch.Tensor, b: torch.Tensor):
    """Minimal-norm solve of the symmetric PSD normal equations by an
    eigendecomposition pseudo-inverse with the JAX package's relative rank
    cutoff ``max|w|·p·1e-7``: the Cholesky solution at full rank, the
    minimal-norm one when singular (reference: PointToPlane.cpp:108-161).
    A ridge is not a substitute: f32 rounding leaves right-hand components
    along exactly singular directions, which a ridge amplifies and the
    cutoff zeroes."""
    p = A.shape[-1]
    w, V = torch.linalg.eigh(0.5 * (A + A.mT))
    tol = torch.amax(torch.abs(w), dim=-1, keepdim=True) * p * 1e-7
    keep = w > tol
    winv = torch.where(keep, 1.0 / torch.where(keep, w, torch.ones_like(w)),
                       torch.zeros_like(w))
    return (V @ (winv * (V.mT @ b[..., None])[..., 0])[..., None])[..., 0]


class ErrorMinimizer(Parametrizable):
    """Interface (reference: PointMatcher.h:527-577)."""

    def compute(self, reading, reference, weights, matches):
        raise NotImplementedError


@ErrorMinimizerRegistrar.register
class PointToPlaneErrorMinimizer(ErrorMinimizer):
    """Linearized point-to-plane least squares, 3-D and 2-D
    (reference: ErrorMinimizers/PointToPlane.cpp, \\cite{Chen1991Point2Plane})."""

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

    def compute(self, reading, reference, weights, matches):
        d = reading.dim
        pairs = make_pairs(reading, reference, weights, matches)
        normals = gather_rows(reference.get_descriptor("normals"),
                              pairs.ids)                  # [..., P, d]
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
        x = solve_possibly_underdetermined(A, b)

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
        residual = torch.sum(w * dot * dot, dim=-1)
        return T, build_stats(reading, weights, matches, residual)
