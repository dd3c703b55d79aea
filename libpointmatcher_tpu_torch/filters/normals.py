"""Normal-estimation filters (counterpart of
``libpointmatcher_tpu.filters.normals``).

``SurfaceNormal`` (reference: DataPointsFilters/SurfaceNormal.cpp): one
batched k-NN search of the cloud against itself, the dense K5 search below
``ops.knn_self.CULL_MIN_POINTS`` valid points and the tile sweep K8 with
its dense fallback from there on, then the covariances of all
neighbourhoods and batched ``torch.linalg.eigh`` calls.

``SamplingSurfaceNormal``, the default reference filter (reference:
DataPointsFilters/SamplingSurfaceNormal.cpp, ICP.cpp:106): the median-split
box decomposition runs on the host in numpy; the per-box statistics
(counts, means, 3x3 covariances and their eigens, extents), the fitness
tests and the subsampling draw run on the cloud's device as segment sums
(``index_add_``), segment extrema (``scatter_reduce``) and one batched
``torch.linalg.eigh``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cloud import PointCloud
from ..errors import InvalidField
from ..ops import knn_self
from ..ops.dispatch import apply_max_dist, knn_search
from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar

__all__ = ["SurfaceNormalDataPointsFilter",
           "SamplingSurfaceNormalDataPointsFilter",
           "SphericalityDataPointsFilter", "median_split_boxes",
           "neighborhood_eigens", "density_from_neighborhood", "batched_eigh"]

#: most 3x3 matrices per batched eigh call
EIGH_SLICE = 16384


def batched_eigh(C: torch.Tensor):
    """``torch.linalg.eigh`` of ``C [n, d, d]`` in slices of
    :data:`EIGH_SLICE` matrices: cuSOLVER's batched eigh refuses batches of
    10^5 matrices (CUSOLVER_STATUS_INVALID_VALUE on an H100)."""
    eigva, eigve = (torch.cat(x) for x in zip(*(
        torch.linalg.eigh(c) for c in torch.split(C, EIGH_SLICE))))
    return eigva, eigve


def neighborhood_eigens(points, mask, ids, dists):
    """Statistics of each point's neighbour set from a k-NN result (``ids``,
    ``dists`` [N, k], +inf = missing) → (mean [N, d], eigenvalues [N, d]
    ascending, eigenvectors [N, d, d] as columns, counts [N], largest
    centred norm [N])."""
    valid = torch.isfinite(dists)
    nb = points[torch.clamp(ids, min=0).long()]             # [N, k, d]
    w = valid.to(points.dtype)[..., None]
    count = torch.clamp(valid.sum(dim=1), min=1)
    mean = (nb * w).sum(dim=1) / count[:, None]
    centered = (nb - mean[:, None, :]) * w
    C = torch.einsum("nkd,nke->nde", centered, centered)
    eigva, eigve = batched_eigh(C)
    max_norm = torch.where(valid, torch.linalg.norm(centered, dim=-1),
                           torch.zeros_like(dists)).amax(dim=1)
    return mean, eigva, eigve, count, max_norm


def density_from_neighborhood(count, max_norm):
    """Points over the sphere volume of the neighbourhood (reference:
    DataPointsFilters/utils/utils.h computeDensity)."""
    volume = (4.0 / 3.0) * math.pi * torch.clamp(max_norm, min=1e-12) ** 3
    return count / volume


@DataPointsFilterRegistrar.register
class SurfaceNormalDataPointsFilter(DataPointsFilter):
    r"""Per-point surface normals from kNN covariance eigendecomposition
    (reference: DataPointsFilters/SurfaceNormal.cpp, \cite{Rusinkiewicz2001}).

    Adds (per flags): 'normals' [d], 'densities' [1], 'eigValues' [d]
    (ascending), 'eigVectors' [d·d] (row-major rows = eigenvectors),
    'matchedIds' [knn], 'meanDists' [1]."""
    # 'eigVectors' is row-major: segment k holds component k of every
    # eigenvector; normals are defined up to their sign, which
    # point-to-plane does not see

    PARAMS = (
        Param("knn", "number of nearest neighbors to consider, including the "
              "point itself", int, 5, min=3),
        Param("maxDist", "maximum distance to consider for neighbors", float,
              "inf", min=0.0),
        Param("epsilon", "approximation for the nearest-neighbor search "
              "(parity parameter; search is exact)", float, 0.0, min=0.0),
        Param("keepNormals", "add normals to the output", bool, True),
        Param("keepDensities", "add densities to the output", bool, False),
        Param("keepEigenValues", "add eigen values to the output", bool, False),
        Param("keepEigenVectors", "add eigen vectors to the output", bool, False),
        Param("keepMatchedIds", "add matched point ids to the output", bool, False),
        Param("keepMeanDist", "add distance to the neighborhood mean", bool, False),
        Param("sortEigen", "sort eigenvalues ascending (always true here: "
              "batched eigh returns ascending order)", bool, False),
        Param("smoothNormals", "average the normal with the nearest neighbors",
              bool, False),
    )

    def filter(self, cloud, key=None, scan=None):
        d = cloud.dim
        pts, mask = cloud.points, cloud.mask
        if cloud.count_host() >= knn_self.CULL_MIN_POINTS:
            dists, ids = knn_self.knn_self_culled(pts, mask, k=int(self.knn),
                                                  max_dist=float(self.maxDist))
        else:
            dists, ids = knn_search(pts, mask, pts, mask, k=int(self.knn))
            dists, ids = apply_max_dist(dists, ids, float(self.maxDist))
        mean, eigva, eigve, count, max_norm = neighborhood_eigens(
            pts, mask, ids, dists)
        # rank(C) < d-1 zeroes the outputs (SurfaceNormal.cpp:193-217)
        lam_max = torch.clamp(eigva[:, -1], min=1e-30)
        degenerate = eigva[:, 1] <= lam_max * 1e-9
        zero = torch.zeros((), device=pts.device)
        out = dict(cloud.descriptors)
        if self.keepNormals:
            normal = torch.clamp(eigve[:, :, 0], -1.0, 1.0)
            normal = torch.where(degenerate[:, None], zero, normal)
            if self.smoothNormals:
                valid = torch.isfinite(dists)
                nb_n = normal[torch.clamp(ids, min=0).long()]          # [N, k, d]
                sign = torch.where((nb_n * normal[:, None, :]).sum(dim=-1) > 0.0,
                                   1.0, -1.0)
                acc = (nb_n * sign[..., None] * valid[..., None]).sum(dim=1)
                normal = acc / count[:, None]
            out["normals"] = normal
        if self.keepDensities:
            dens = density_from_neighborhood(count, max_norm)
            out["densities"] = torch.where(degenerate, zero, dens)[:, None]
        if self.keepEigenValues:
            out["eigValues"] = torch.where(degenerate[:, None], zero, eigva)
        if self.keepEigenVectors:
            out["eigVectors"] = torch.where(degenerate[:, None], zero,
                                            eigve.reshape(-1, d * d))
        if self.keepMatchedIds:
            out["matchedIds"] = ids.to(torch.float32)
        if self.keepMeanDist:
            md = torch.linalg.norm(pts - mean, dim=1)
            out["meanDists"] = torch.where(degenerate, float(2**31), md)[:, None]
        return cloud.replace(descriptors=out)


def median_split_boxes(points: np.ndarray, knn: int) -> np.ndarray:
    """Largest-extent median split until at most ``knn`` points per box
    (reference: SamplingSurfaceNormal.cpp buildNew); a box id per point.

    The port's own copy of ``filters/normals.py::_median_split_boxes``:
    all boxes of a level split together, with one lexsort by (box, cut
    coordinate) per level; box ids come out in sorted order."""
    n = points.shape[0]
    if n == 0:
        return np.zeros(0, np.int64)
    order = np.arange(n)
    box_of = np.zeros(n, dtype=np.int64)
    arange_n = np.arange(n)
    while True:
        change = np.empty(n, bool)
        change[0] = True
        np.not_equal(box_of[1:], box_of[:-1], out=change[1:])
        starts = np.flatnonzero(change)
        sizes = np.diff(np.append(starts, n))
        if sizes.max() <= knn:
            break
        coords = points[order]
        mins = np.minimum.reduceat(coords, starts, axis=0)
        maxs = np.maximum.reduceat(coords, starts, axis=0)
        cut_dim = np.argmax(maxs - mins, axis=1)
        start_of = np.repeat(starts, sizes)
        size_of = np.repeat(sizes, sizes)
        key = coords[arange_n, np.repeat(cut_dim, sizes)]
        frozen = size_of <= knn          # small boxes keep a constant key
        key = np.where(frozen, 0.0, key)
        order = order[np.lexsort((key, box_of))]
        rank = arange_n - start_of
        left_count = size_of - size_of // 2
        child = np.where(frozen, 0, (rank >= left_count).astype(np.int64))
        new_box = 2 * box_of + child
        box_of = np.cumsum(np.concatenate(
            ([0], (np.diff(new_box) != 0).astype(np.int64))))
    out = np.empty(n, np.int64)
    out[order] = box_of
    return out


def _segment_extreme(values, seg, num, reduce):
    out = torch.zeros((num,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    idx = seg.view(-1, *([1] * (values.ndim - 1))).expand_as(values)
    return out.scatter_reduce(0, idx, values, reduce=reduce, include_self=False)


@DataPointsFilterRegistrar.register
class SamplingSurfaceNormalDataPointsFilter(DataPointsFilter):
    """Subsample and estimate normals per box of a median-split
    decomposition (see module docstring)."""
    DESCRIPTION = """Subsample + estimate normals per kd-box decomposition
    (reference: DataPointsFilters/SamplingSurfaceNormal.cpp; the default
    reference-cloud filter, ICP.cpp:106).

    TPU design: the median-split decomposition runs on host (numpy,
    O(N log N)); the per-box covariance/eigen statistics, the fitness
    tests and the subsampling draw are one fused device program
    (``_ssn_device``)."""

    HOST_PREP = True

    PARAMS = (
        Param("ratio", "ratio of points to keep with random subsampling",
              float, 0.5, min=0.0000001, max=1.0),
        Param("knn", "number of points per box used to compute the normals "
              "(box split threshold)", int, 7, min=3),
        Param("samplingMethod", "0: random subsampling with ratio; 1: bin "
              "subsampling, one point (the box centroid) per box", int, 0,
              min=0, max=1),
        Param("maxBoxDim", "maximum length of a box above which it is "
              "discarded", float, "inf"),
        Param("averageExistingDescriptors", "average existing descriptors "
              "over the box (1) or keep the first point's (0)", bool, True),
        Param("keepNormals", "add normals to the output", bool, True),
        Param("keepDensities", "add densities to the output", bool, False),
        Param("keepEigenValues", "add eigen values to the output", bool, False),
        Param("keepEigenVectors", "add eigen vectors to the output", bool, False),
    )

    def filter(self, cloud, key=None, scan=None):
        pts_h, mask_h = cloud.host_rows()
        valid = np.flatnonzero(mask_h)
        box_ids = median_split_boxes(np.asarray(pts_h, np.float64)[valid],
                                     int(self.knn))
        num_real = int(box_ids.max()) + 1 if len(valid) else 0
        nb = num_real + 1                     # last segment: masked rows
        n, d = cloud.num_points, cloud.dim
        seg_h = np.full(n, nb - 1, np.int64)
        seg_h[valid] = box_ids
        dev = cloud.device
        seg = torch.as_tensor(seg_h, device=dev)
        pts = cloud.points

        counts = torch.zeros(nb, device=dev).index_add_(
            0, seg, cloud.mask.to(torch.float32))
        sums = torch.zeros((nb, d), device=dev).index_add_(0, seg, pts)
        means = sums / torch.clamp(counts, min=1.0)[:, None]
        centered = pts - means[seg]
        outer = (centered[:, :, None] * centered[:, None, :]).reshape(n, d * d)
        C = torch.zeros((nb, d * d), device=dev).index_add_(0, seg, outer)
        eigva, eigve = torch.linalg.eigh(C.reshape(nb, d, d))   # ascending

        box_dim = (_segment_extreme(pts, seg, nb, "amax")
                   - _segment_extreme(pts, seg, nb, "amin")).amax(dim=1)
        max_cnorm = _segment_extreme(torch.linalg.norm(centered, dim=1), seg,
                                     nb, "amax")
        lam_max = torch.clamp(eigva[:, -1], min=1e-30)
        degenerate = eigva[:, 1] <= lam_max * 1e-9
        unfit = degenerate | (box_dim > self.maxBoxDim)

        if self.samplingMethod == 0:
            keep = self.draw_uniform(cloud, key, scan) < self.ratio
            new_pts = pts
            desc_src = dict(cloud.descriptors)
        else:
            # one representative per box, at the box mean
            _, first = np.unique(box_ids, return_index=True)
            keep = torch.zeros(n, dtype=torch.bool, device=dev)
            keep[torch.as_tensor(valid[first], device=dev)] = True
            new_pts = torch.where(cloud.mask[:, None], means[seg], pts)
            desc_src = {}
            for k, v in cloud.descriptors.items():
                if self.averageExistingDescriptors:
                    dsum = torch.zeros((nb, v.shape[1]), device=dev
                                       ).index_add_(0, seg, v)
                    desc_src[k] = (dsum / torch.clamp(counts, min=1.0)[:, None])[seg]
                else:
                    desc_src[k] = v
        keep = keep & ~unfit[seg] & cloud.mask

        out = desc_src
        if self.keepNormals:
            out["normals"] = torch.clamp(eigve[:, :, 0], -1.0, 1.0)[seg]
        if self.keepDensities:
            volume = (4.0 / 3.0) * math.pi * torch.clamp(max_cnorm, min=1e-12) ** 3
            out["densities"] = (counts / volume)[seg][:, None]
        if self.keepEigenValues:
            out["eigValues"] = eigva[seg]
        if self.keepEigenVectors:
            out["eigVectors"] = eigve.reshape(nb, d * d)[seg]
        return PointCloud(new_pts, keep, out, cloud.times)


@DataPointsFilterRegistrar.register
class SphericalityDataPointsFilter(DataPointsFilter):
    """Local shape descriptor from eigenvalues: −1 = plane … +1 = uniform
    (reference: DataPointsFilters/Sphericality.cpp; 3D only, needs
    'eigValues' from a prior SurfaceNormal pass)."""
    # where the largest eigenvalue is not positive, or the value is NaN,
    # it is NaN

    PARAMS = (
        Param("keepUnstructureness", "keep the unstructureness value", bool,
              False),
        Param("keepStructureness", "keep the structureness value", bool, False),
    )

    def filter(self, cloud, key=None, scan=None):
        if cloud.dim != 3:
            raise InvalidField("SphericalityDataPointsFilter: works only in 3D")
        if not cloud.has_descriptor("eigValues"):
            raise InvalidField(
                "SphericalityDataPointsFilter: no eigValues found; run "
                "SurfaceNormalDataPointsFilter with keepEigenValues first")
        eig = cloud.get_descriptor("eigValues")               # ascending
        lam1, lam2, lam3 = eig[..., 2], eig[..., 1], eig[..., 0]
        denom1 = torch.clamp(lam1, min=1e-20)
        unstructureness = lam3 / denom1
        denom2 = torch.clamp(lam1 * lam2, min=1e-20)
        structureness = (lam2 / denom1) * ((lam2 - lam3) / torch.sqrt(denom2))
        sph = unstructureness - structureness
        sph = torch.where((lam1 <= 0) | torch.isnan(sph), float("nan"), sph)
        out = cloud.with_descriptor("sphericality", sph)
        if self.keepUnstructureness:
            out = out.with_descriptor("unstructureness", unstructureness)
        if self.keepStructureness:
            out = out.with_descriptor("structureness", structureness)
        return out
