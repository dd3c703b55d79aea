"""Descriptor filters (counterpart of
``libpointmatcher_tpu.filters.descriptor``): Gestalt keypoint descriptors
and the physical sensor-bias correction."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cloud import PointCloud
from ..errors import InvalidField
from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar, key_word
from .sampling import _rows, _valid

__all__ = ["GestaltDataPointsFilter", "RemoveSensorBiasDataPointsFilter",
           "GESTALT_CHUNK"]

#: keypoints per device chunk: [64, N, 3] float32 is ~77 MB at N = 10^5
GESTALT_CHUNK = 64


def _voxel_firsts(pts: np.ndarray, vsize: np.ndarray) -> np.ndarray:
    """The first row of each occupied voxel, in voxel order."""
    idx3 = np.floor(pts / vsize).astype(np.int64)
    idx3 -= idx3.min(axis=0)
    dims = idx3.max(axis=0) + 1
    lin = idx3[:, 0] + idx3[:, 1] * dims[0] + idx3[:, 2] * dims[0] * dims[1]
    return np.unique(lin, return_index=True)[1]


def _scalar(x: float, device) -> torch.Tensor:
    """A float32 scalar on ``device``: dividing by it is a true division on
    the card too (a Python number there becomes a reciprocal product)."""
    return torch.tensor(x, dtype=torch.float32, device=device)


@DataPointsFilterRegistrar.register
class GestaltDataPointsFilter(DataPointsFilter):
    """Gestalt keypoint descriptors (reference:
    DataPointsFilters/Gestalt.cpp, \\cite{Bosse2013Gestalt}): one keypoint
    per occupied voxel, kept at random with ``ratio``, each described by 4
    radial x 8 angular bins of its neighbours' height means and variances
    in a frame set by its neighbourhood's normal.

    As in the JAX package: the keypoints are host numpy (voxel firsts, a
    ``np.random.default_rng`` draw seeded by the key's second word); each
    chunk of :data:`GESTALT_CHUNK` keypoints runs on the cloud's device over
    all rows (box masks, covariance and ``eigh``, the 32 bins' sums);
    ``warpedXYZ`` is zeros (the JAX package's reasoning: the reference
    leaves it undefined); the first time channel becomes [min, max, mean]
    over the box's neighbours, 0 for an empty box.

    The frame follows the sign of the normal, which ``eigh`` does not fix:
    with the normal negated, the warped x and y negate and angular bin a
    becomes bin (a + 4) mod 8."""
    DESCRIPTION = r"""Gestalt keypoint descriptors (reference:
    DataPointsFilters/Gestalt.cpp, \cite{Bosse2013Gestalt}): voxel-binned
    keypoints, each described by 4 radial x 8 angular bins of neighbor-height
    means/variances in a normal-oriented frame.

    TPU design: keypoint selection is host-side (data-dependent voxel
    firsts); everything per-keypoint — box masks, covariance/eigen, the
    32-bin statistics — runs on device in fixed-size keypoint chunks
    (``lax.map`` over [Kc, N] tiles with segment-sum bin reductions), so
    device memory is O(Kc·N) and there is no per-point host iteration.

    ``warpedXYZ`` parity note: the reference emits a 3-row descriptor of
    this name but never defines its content — Gestalt.cpp:467 writes each
    box's warped neighbor coordinates into the *global* descriptor columns
    ``0..colCount-1`` (scratch reuse, not the box's own columns), so after
    the final compaction (Gestalt.cpp:205) a surviving keypoint's column
    holds a leftover warp of whichever box was processed last over that
    column index — a function of box traversal order, not of the keypoint.
    The only well-defined per-keypoint value of the same quantity (the
    keypoint's own coordinates warped into its new basis, (p−kp)ᵀ·basis at
    p = kp) is identically zero, which is what this implementation emits;
    the descriptor exists so reference-schema consumers find the channel.
    Everything observable about the descriptor output — bin means/variances
    (including the reference's count normalization and empty-outer-bin
    propagation), shapes, discards — is pinned by tests/test_filters.py."""

    PARAMS = (
        Param("ratio", "ratio of keypoints to keep with random subsampling",
              float, 0.1, min=0.0000001, max=0.9999999),
        Param("radius", "radius of the gestalt descriptor; divided into 4 "
              "circular and 8 radial bins = 32 bins", float, 5.0, min=0.1),
        Param("knn", "box-split threshold (accepted for parity with the "
              "reference's normal estimation path)", int, 7, min=3),
        Param("vSizeX", "keypoint voxel size in x", float, 1.0),
        Param("vSizeY", "keypoint voxel size in y", float, 1.0),
        Param("vSizeZ", "keypoint voxel size in z", float, 1.0),
        Param("keepMeans", "add neighborhood means", bool, False),
        Param("maxBoxDim", "maximum box length above which it is discarded",
              float, "inf"),
        Param("averageExistingDescriptors", "average existing descriptors",
              bool, True),
        Param("maxTimeWindow", "maximum time spread of a surfel", float, "inf"),
        Param("keepNormals", "add normals", bool, True),
        Param("keepEigenValues", "add eigen values", bool, False),
        Param("keepEigenVectors", "add eigen vectors", bool, False),
        Param("keepCovariances", "add covariances", bool, False),
        Param("keepGestaltFeatures", "add the Gestalt features", bool, True),
    )

    def _chunk(self, pts: torch.Tensor, kp: torch.Tensor):
        """Statistics of keypoints ``kp [kc, 3]`` over the rows ``pts``."""
        dev = pts.device
        radius = float(self.radius)
        kc = kp.shape[0]
        diff = pts[None, :, :] - kp[:, None, :]                # [kc, N, 3]
        nb = (diff.abs() <= radius).all(dim=-1) & (diff != 0.0).any(dim=-1)
        nbf = nb.to(torch.float32)
        n_nb = nb.sum(dim=1)
        w = nbf[:, :, None]
        mean = (pts[None] * w).sum(dim=1) / torch.clamp(n_nb, min=1)[:, None]
        centered = (pts[None] - mean[:, None, :]) * w
        C = torch.einsum("knd,kne->kde", centered, centered)
        eigva, eigve = torch.linalg.eigh(C)
        normal = eigve[:, :, 0]
        s = torch.clamp(eigva.sum(dim=1), min=1e-30)
        # ascending eigenvalues: planarity 2(λ1-λ0)/Σ, cylindricality (λ2-λ1)/Σ
        planarity = 2.0 * (eigva[:, 1] - eigva[:, 0]) / s
        cylindricality = (eigva[:, 2] - eigva[:, 1]) / s

        up = torch.tensor([0.0, 0.0, 1.0], device=dev).expand(kc, 3)
        nx = normal * torch.tensor([1.0, 1.0, 0.0], device=dev)
        nx = nx / torch.clamp(torch.linalg.vector_norm(nx, dim=1, keepdim=True),
                              min=1e-12)
        ny = torch.linalg.cross(up, nx)
        ny = ny / torch.clamp(torch.linalg.vector_norm(ny, dim=1, keepdim=True),
                              min=1e-12)
        basis = torch.stack([nx, ny, up], dim=2)               # [kc, 3, 3]
        warped = torch.einsum("knd,kde->kne", diff, basis)
        heights = warped[:, :, 2]
        radii = torch.linalg.vector_norm(warped[:, :, :2], dim=-1)
        two_pi = _scalar(2 * math.pi, dev)
        # atan2 + 2π lies in [π, 3π]: fmod is the JAX package's jnp.mod
        angles = torch.fmod(torch.atan2(warped[:, :, 1], warped[:, :, 0]) + two_pi,
                            two_pi)
        rbin = torch.clamp((radii / _scalar(radius / 4, dev)).to(torch.int64), 0, 3)
        abin = torch.clamp((angles / _scalar(math.pi / 4, dev)).to(torch.int64), 0, 7)
        # slot 32 takes the rows that are not neighbours
        slot = torch.where(nb, rbin * 8 + abin, 32)

        def binsum(x):
            out = torch.zeros((kc, 33), dtype=torch.float32, device=dev)
            return out.scatter_add_(1, slot, x)[:, :32]

        nvals = torch.clamp(binsum(nbf), min=1.0)
        gmeans = binsum(heights * nbf) / nvals
        padded = torch.nn.functional.pad(gmeans, (0, 1))
        dev2 = (heights - torch.gather(padded, 1, slot)) ** 2
        # the variance divides by numOfValues (Gestalt.cpp:532-535)
        gvars = binsum(dev2 * nbf) / nvals
        gm, gv = gmeans.reshape(kc, 4, 8), gvars.reshape(kc, 4, 8)
        # an empty outer bin (mean == 0) takes the inner one's values
        # (Gestalt.cpp:525-530)
        for radial in range(1, 4):
            empty = gm[:, radial, :] == 0
            gm[:, radial, :] = torch.where(empty, gm[:, radial - 1, :], gm[:, radial, :])
            gv[:, radial, :] = torch.where(empty, gv[:, radial - 1, :], gv[:, radial, :])
        vert_angle = torch.arccos(torch.clamp(normal[:, 2].abs(), -1.0, 1.0))
        ok = (planarity <= 0.9) & (vert_angle >= 10 * math.pi / 180) & (n_nb > 0)
        return (normal, mean, eigva, eigve, C, gm.reshape(kc, 32),
                gv.reshape(kc, 32), torch.stack([planarity, cylindricality], dim=1),
                ok)

    def filter(self, cloud, key=None, scan=None):
        if cloud.dim != 3:
            raise InvalidField("GestaltDataPointsFilter: 3D only")
        c = _valid(cloud)
        if c.num_points == 0:
            return cloud
        host_pts = c.points.cpu().numpy()
        first = _voxel_firsts(host_pts, np.array([self.vSizeX, self.vSizeY,
                                                  self.vSizeZ]))
        rng = np.random.default_rng(key_word(key, scan))
        kp_idx = first[rng.random(len(first)) < self.ratio]
        if len(kp_idx) == 0:
            kp_idx = first[:1]
        K = len(kp_idx)
        rows = torch.as_tensor(kp_idx, device=c.device)
        kp = c.points[rows]
        parts = [self._chunk(c.points, kp[i:i + GESTALT_CHUNK])
                 for i in range(0, K, GESTALT_CHUNK)]
        (normal, mean, eigva, eigve, C, gmeans, gvars, shapes, ok) = (
            torch.cat(x) for x in zip(*parts))

        descs = {k: v[rows] for k, v in c.descriptors.items()}
        if self.keepNormals:
            descs["normals"] = normal
        if self.keepMeans:
            descs["means"] = mean
        if self.keepEigenValues:
            descs["eigValues"] = eigva
        if self.keepEigenVectors:
            descs["eigVectors"] = eigve.reshape(K, 9)
        if self.keepCovariances:
            descs["covariance"] = C.reshape(K, 9)
        if self.keepGestaltFeatures:
            descs["gestaltMeans"] = gmeans
            descs["gestaltVariances"] = gvars
            descs["warpedXYZ"] = torch.zeros((K, 3), device=c.device)
            descs["gestaltShapes"] = shapes
        times = {}
        if c.times:
            tname = next(iter(c.times))
            times[tname] = torch.as_tensor(self._neighbour_times(
                host_pts, host_pts[kp_idx], c.times[tname][:, 0].cpu().numpy()),
                device=c.device)
        return PointCloud(kp, ok, descs, times)

    def _neighbour_times(self, pts, kp, tv) -> np.ndarray:
        """[min, max, mean] of ``tv`` over each keypoint's box neighbours,
        0 for an empty box → int64 [K, 3] (the JAX package's host pass)."""
        K = len(kp)
        out = np.zeros((K, 3), np.int64)
        big = np.iinfo(np.int64).max
        for c0 in range(0, K, GESTALT_CHUNK):
            d = np.abs(pts[None, :, :] - kp[c0:c0 + GESTALT_CHUNK, None, :])
            nbh = np.all(d <= self.radius, axis=-1) & np.any(d != 0.0, axis=-1)
            cnt = nbh.sum(axis=1)
            blk = out[c0:c0 + GESTALT_CHUNK]
            blk[:, 0] = np.where(nbh, tv[None, :], big).min(axis=1)
            blk[:, 1] = np.where(nbh, tv[None, :], -big - 1).max(axis=1)
            blk[:, 2] = (np.where(nbh, tv[None, :].astype(np.float64), 0.0)
                         .sum(axis=1) / np.maximum(cnt, 1)).astype(np.int64)
            blk[cnt == 0, :2] = 0
        return out


@DataPointsFilterRegistrar.register
class RemoveSensorBiasDataPointsFilter(DataPointsFilter):
    r"""Correct the range bias induced by the laser incidence angle
    (reference: DataPointsFilters/RemoveSensorBias.{h,cpp},
    \cite{Laconte2019SensorBias}). Requires 'incidenceAngles' and
    'observationDirections'; points whose incidence exceeds angleThreshold
    (or is NaN) are removed, the rest shifted along the view ray by the
    physical correction k1·ΔT + k2·curvature-ratio."""
    # a point at the sensor is removed too; the arithmetic is the JAX
    # package's, float64 on the host

    PARAMS = (
        Param("sensorType", "0=Sick LMS-1xx, 1=Velodyne HDL-32E", int, 0,
              min=0, max=1),
        Param("angleThreshold", "max incidence angle at which the correction "
              "is applied [deg]", float, 88.0, min=0.0, max=90.0),
    )

    # (aperture, k1, k2) per sensor (reference: RemoveSensorBias.h:108-114)
    _SENSORS = {
        0: (0.0075049, 6.08040951e0, 3.17921789e-3),
        1: (0.0014835, 1.03211569e1, 7.07893371e-3),
    }
    _TAU = 50e-9
    _PULSE_INTENSITY = 0.39
    _LAMBDA = 905e-9
    _C = 299792458.0

    def _coefficients(self, depth, theta, aperture):
        from scipy.special import erf

        sigma = self._TAU / math.sqrt(2.0 * math.pi)
        w0 = self._LAMBDA / (math.pi * aperture)
        c = self._C
        tan_t = np.tan(theta)
        cos_t = np.cos(theta)
        sin_t = np.sin(theta)
        A = 2.0 * (depth * tan_t) ** 2 / (sigma * c) ** 2 + 2.0 / aperture**2
        K1 = cos_t**3
        K2 = 3.0 * cos_t**2 * sin_t
        L1 = (self._PULSE_INTENSITY * (w0 / (aperture * depth * cos_t)) ** 2
              * math.sqrt(math.pi) * erf(aperture * np.sqrt(A)) / (2.0 * A ** 1.5))
        L2 = (self._PULSE_INTENSITY * (w0 / (aperture * depth * cos_t)) ** 2 * K2
              / (2.0 * A))
        a0 = 2.0 * A * K1 * L1
        a1 = -(2.0 * tan_t * depth
               * (L1 * K2 - 2.0 * L2 * aperture * np.exp(-A * aperture**2))) \
            / (sigma**2 * c)
        a2 = -L1 * 2.0 * A * K1 * (
            (sigma * c * cos_t) ** 2 * A + 2.0 * (cos_t * depth) ** 2
            - 2.0 * depth**2
        ) / (2.0 * (c * cos_t) ** 2 * sigma**4 * A)
        a3 = L1 * K2 * depth * tan_t * (
            (sigma * c) ** 2 * A - 2.0 * (depth * tan_t) ** 2
        ) / (sigma**6 * c**3 * A)
        return a0, a1, a2, a3

    def filter(self, cloud, key=None, scan=None):
        for name, what in (("incidenceAngles", "incidence angles"),
                           ("observationDirections", "observationDirections")):
            if not cloud.has_descriptor(name):
                raise InvalidField(
                    f"RemoveSensorBiasDataPointsFilter: cannot find {what} in "
                    "descriptors")
        aperture, k1, k2 = self._SENSORS[self.sensorType]
        thr = self.angleThreshold / 180.0 * math.pi
        c = _valid(cloud)
        inc = c.get_descriptor("incidenceAngles")[:, 0].cpu().numpy().astype(np.float64)
        obs = c.get_descriptor("observationDirections").cpu().numpy().astype(np.float64)
        depth = np.linalg.norm(obs, axis=1)
        keep = np.isfinite(inc) & (inc >= 0.0) & (inc < thr) & (depth > 1e-9)

        theta = np.clip(inc[keep], 1e-6, None)
        dep = depth[keep]
        a0, a1, a2, a3 = self._coefficients(dep, theta, aperture)
        with np.errstate(invalid="ignore"):
            disc = np.sqrt(np.maximum(4.0 * a2**2 - 12.0 * a1 * a3, 0.0))
            tmax = (-2.0 * a2 - disc) / (6.0 * a3)
        small = inc[keep] < 1e-5
        tmax = np.where(small, 0.0, tmax)
        diff_dist = tmax * self._C / 2.0
        b0, b1, b2, b3 = self._coefficients(dep, np.zeros_like(theta), aperture)
        ratio_curv = np.where(small, 0.0,
                              1.0 - 2.0 * b2 / (2.0 * a2 + 6.0 * tmax * a3))
        correction = k1 * diff_dist + k2 * ratio_curv

        rows = np.flatnonzero(keep)
        pts = c.points[torch.as_tensor(rows, device=c.device)].cpu().numpy()
        pts += (correction[:, None] * (obs[keep] / dep[:, None])).astype(np.float32)
        return _rows(c, rows).replace(points=torch.as_tensor(pts, device=c.device))
