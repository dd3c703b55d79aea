"""SamplingSurfaceNormal, the default reference filter (counterpart of
``libpointmatcher_tpu.filters.normals.SamplingSurfaceNormalDataPointsFilter``;
reference: DataPointsFilters/SamplingSurfaceNormal.cpp, ICP.cpp:106).

The median-split box decomposition runs on the host in numpy; the per-box
statistics (counts, means, 3x3 covariances and their eigens, extents), the
fitness tests and the subsampling draw run on the cloud's device as segment
sums (``index_add_``), segment extrema (``scatter_reduce``) and one batched
``torch.linalg.eigh``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cloud import PointCloud
from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar

__all__ = ["SamplingSurfaceNormalDataPointsFilter", "median_split_boxes"]


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

    def filter(self, cloud, generator=None, scan=None):
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
            keep = self.draw_uniform(cloud, generator, scan) < self.ratio
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
        return PointCloud(new_pts, keep, out)
