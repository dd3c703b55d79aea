"""Structured subsampling filters (counterpart of
``libpointmatcher_tpu.filters.sampling``): VoxelGrid, OctreeGrid,
NormalSpace, CovarianceSampling and Elipsoids.

As in the JAX package, the cell and box assignments are host numpy (voxel
indices, the octree's and the median split's leaves), and so are the
draws that JAX makes with numpy (OctreeGrid's permutation, NormalSpace's
bucket draw) and CovarianceSampling's greedy pick. The per-cell statistics
(counts, means, covariances, their eigens, extents) run on the cloud's
device as segment sums (``index_add_``), segment extrema and batched
``eigh``. Time channels follow the JAX rules (the minimum per voxel or
leaf, the kept rows', Elipsoids' [min, max, mean] per box) on the host.

On the CPU ``index_add_`` adds each segment's rows in row order, as JAX's
``segment_sum`` does. On the card it adds in atomic order, whose rounding
differs from run to run; :func:`segment_sum` therefore adds in row order
there too where no segment is longer than ``ORDERED_MAX_ROWS`` (Elipsoids'
boxes, OctreeGrid's leaves; one :func:`segment_plan` a filter call, shared
by its sums), so both devices round alike: a box's density
divides by the cube of its radius about its mean and magnifies a mean's
last bits past 1e-4 of itself. Longer segments (a coarse VoxelGrid's
voxels) keep the atomic order: within 1e-6 of their magnitude on the test
clouds.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..cloud import PointCloud
from ..errors import InvalidField, InvalidParameter
from ..registry import Param
from .base import DataPointsFilter, DataPointsFilterRegistrar, key_word
from .normals import _segment_extreme, batched_eigh, median_split_boxes

__all__ = ["VoxelGridDataPointsFilter", "OctreeGridDataPointsFilter",
           "NormalSpaceDataPointsFilter", "CovarianceSamplingDataPointsFilter",
           "ElipsoidsDataPointsFilter", "segment_plan", "segment_sum",
           "ordered_segment_sum", "segment_stats",
           "octree_split", "covariance_greedy"]

_I64_MAX = np.iinfo(np.int64).max

#: the longest segment that :func:`segment_sum` adds in row order on the
#: card, one launch a row of it
ORDERED_MAX_ROWS = 64


def segment_plan(seg: torch.Tensor, num: int):
    """How :func:`segment_sum` adds over the segment ids ``seg`` [n] →
    (counts [num] int64, layout). ``layout`` is the row-order sum's
    (order, rows, pos, width) on the card where no segment has more than
    ``ORDERED_MAX_ROWS`` rows (one host read of the longest), else None:
    ``index_add_``, whose order on the CPU is the rows'. A caller that sums
    several fields over one ``seg`` makes one plan and hands it to each."""
    counts = torch.bincount(seg, minlength=num)
    if seg.device.type == "cpu" or not len(seg):
        return counts, None
    width = int(counts.max())
    return counts, (_layout(seg, counts, width) if width <= ORDERED_MAX_ROWS
                    else None)


def _layout(seg, counts, width):
    order = torch.argsort(seg, stable=True)
    rows = seg[order]
    pos = torch.arange(len(seg), device=seg.device) - (torch.cumsum(counts, 0)
                                                       - counts)[rows]
    return order, rows, pos, width


def _row_order_sum(values, layout, num):
    order, rows, pos, width = layout
    table = values.new_zeros((num, width) + values.shape[1:])
    table[rows, pos] = values[order]
    out = values.new_zeros((num,) + values.shape[1:])
    for j in range(width):
        out = out + table[:, j]
    return out


def segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int,
                plan=None) -> torch.Tensor:
    """Sum of ``values`` [n, ...] per segment id ``seg`` [n] → [num, ...],
    each segment's rows added from 0 in row order, as ``index_add_`` adds
    them on the CPU. On the card, where ``index_add_`` adds in atomic order,
    the row-order sum runs where :func:`segment_plan` (``plan``, made here
    when not given) lays one out."""
    if plan is None and values.device.type != "cpu":
        plan = segment_plan(seg, num)
    if plan is not None and plan[1] is not None:
        return _row_order_sum(values, plan[1], num)
    out = torch.zeros((num,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values)


def ordered_segment_sum(values: torch.Tensor, seg: torch.Tensor, num: int,
                        counts: torch.Tensor) -> torch.Tensor:
    """:func:`segment_sum` in row order on any device: the rows laid out
    per segment (``counts`` [num] rows each, in row order) and added a
    column at a time, one launch a row of the longest segment."""
    width = int(counts.max()) if len(seg) else 0
    return _row_order_sum(values, _layout(seg, counts, width), num)


def segment_stats(pts: torch.Tensor, seg: torch.Tensor, num: int,
                  covariance: bool = True, plan=None):
    """Counts [num], means [num, d] and, with ``covariance``, the
    covariances [num, d, d] (sums of the centred outer products) per
    segment; otherwise None in their place. ``plan``: :func:`segment_plan`
    of ``seg``, made here when not given."""
    n, d = pts.shape
    if plan is None:
        plan = segment_plan(seg, num)
    counts = plan[0].to(pts.dtype)
    means = segment_sum(pts, seg, num, plan) / torch.clamp(counts, min=1.0)[:, None]
    if not covariance:
        return counts, means, None
    centered = pts - means[seg]
    outer = (centered[:, :, None] * centered[:, None, :]).reshape(n, d * d)
    return counts, means, segment_sum(outer, seg, num, plan).reshape(num, d, d)


def _valid(cloud: PointCloud) -> PointCloud:
    """The cloud's valid rows, packed (the cloud itself when all are)."""
    return cloud if cloud.count_host() == cloud.num_points else cloud.compact()


def _rows(c: PointCloud, rows: np.ndarray) -> PointCloud:
    return c.take_rows(torch.as_tensor(np.asarray(rows, np.int64), device=c.device))


def _new_cloud(points: torch.Tensor, descriptors, times) -> PointCloud:
    """All-valid cloud on ``points``' device; host time channels move
    there."""
    out = PointCloud(points, None, descriptors,
                     {k: torch.as_tensor(v, device=points.device)
                      for k, v in times.items()})
    out._count_cache = points.shape[0]
    return out


def _min_times(c: PointCloud, seg: np.ndarray, num: int):
    """Each time channel's minimum per segment (host int64)."""
    out = {}
    for k, v in c.times.items():
        tmin = np.full((num, v.shape[1]), _I64_MAX)
        np.minimum.at(tmin, seg, v.cpu().numpy())
        out[k] = tmin
    return out


def _average_descriptors(c: PointCloud, seg: torch.Tensor, num: int,
                         counts: torch.Tensor, plan):
    return {k: segment_sum(v, seg, num, plan) / torch.clamp(counts, min=1.0)[:, None]
            for k, v in c.descriptors.items()}


@DataPointsFilterRegistrar.register
class VoxelGridDataPointsFilter(DataPointsFilter):
    """Voxel-grid down-sampling to cell centroids or centers
    (reference: DataPointsFilters/VoxelGrid.cpp)."""

    PARAMS = (
        Param("vSizeX", "Dimension of each voxel cell in x direction", float,
              1.0, min=0.001),
        Param("vSizeY", "Dimension of each voxel cell in y direction", float,
              1.0, min=0.001),
        Param("vSizeZ", "Dimension of each voxel cell in z direction", float,
              1.0, min=0.001),
        Param("useCentroid", "1: down-sample to the centroid of each cell; "
              "0: to the cell center", bool, True),
        Param("averageExistingDescriptors", "1: average existing descriptors "
              "over the cell; 0: drop them", bool, True),
    )

    def filter(self, cloud, key=None, scan=None):
        c = _valid(cloud)
        n, d = c.num_points, c.dim
        if n == 0:
            return cloud
        host_pts = c.points.cpu().numpy()
        if not np.all(np.isfinite(host_pts)):
            raise InvalidParameter(
                "VoxelGridDataPointsFilter: NaNs in features; use "
                "RemoveNaNDataPointsFilter first")
        vsize = np.array([self.vSizeX, self.vSizeY, self.vSizeZ][:d])
        idx3 = np.floor(host_pts / vsize).astype(np.int64)
        idx3 -= idx3.min(axis=0)
        dims = idx3.max(axis=0) + 1
        lin = idx3[:, 0]
        stride = dims[0]
        for a in range(1, d):
            lin = lin + idx3[:, a] * stride
            stride *= dims[a]
        uniq, first, seg_h = np.unique(lin, return_index=True,
                                       return_inverse=True)
        num = len(uniq)
        seg = torch.as_tensor(seg_h, device=c.device)
        plan = segment_plan(seg, num)
        counts, means, _ = segment_stats(c.points, seg, num, covariance=False,
                                         plan=plan)
        if self.useCentroid:
            out_pts = means
        else:
            centers = (np.floor(host_pts[first] / vsize) + 0.5) * vsize
            out_pts = torch.as_tensor(centers.astype(np.float32), device=c.device)
        descs = (_average_descriptors(c, seg, num, counts, plan)
                 if self.averageExistingDescriptors else {})
        return _new_cloud(out_pts, descs, _min_times(c, seg_h, num))


def octree_split(points: np.ndarray, max_points: int, max_size: float) -> np.ndarray:
    """Octree (quadtree in 2D) leaf of each point: boxes split at their
    centre into 2^d children until a box holds at most ``max_points``
    points or its side is at most ``max_size`` (reference:
    DataPointsFilters/utils/octree.hpp build). The port's copy of the JAX
    package's ``filters/sampling.py::_octree_split``, with its leaf
    numbering."""
    n, d = points.shape
    leaf = np.zeros(n, np.int64)
    next_leaf = 0
    order = np.arange(n)
    lo = points.min(axis=0)
    hi = points.max(axis=0)
    stack = [(0, n, (lo + hi) / 2, float((hi - lo).max() / 2))]
    while stack:
        first, last, center, radius = stack.pop()
        count = last - first
        if (count <= max_points or (max_size > 0 and 2 * radius <= max_size)
                or radius <= 0):
            leaf[order[first:last]] = next_leaf
            next_leaf += 1
            continue
        seg = order[first:last]
        coords = points[seg]
        child = np.zeros(count, np.int64)
        for a in range(d):
            child |= (coords[:, a] > center[a]).astype(np.int64) << a
        sort_idx = np.argsort(child, kind="stable")
        order[first:last] = seg[sort_idx]
        bounds = np.searchsorted(child[sort_idx], np.arange(2**d + 1))
        half = radius / 2
        for ch in range(2**d):
            b0, b1 = bounds[ch], bounds[ch + 1]
            if b1 > b0:
                offs = np.array([half if (ch >> a) & 1 else -half for a in range(d)])
                stack.append((first + b0, first + b1, center + offs, half))
    return leaf


def _segment_firsts(leaf: np.ndarray, order: np.ndarray, num: int) -> np.ndarray:
    """The first row of each segment along ``order`` (grouped by leaf)."""
    return order[np.searchsorted(leaf[order], np.arange(num))]


@DataPointsFilterRegistrar.register
class OctreeGridDataPointsFilter(DataPointsFilter):
    """Octree/quadtree decomposition down-sampling with FIRST / RANDOM /
    CENTROID / MEDOID per-cell sampling (reference:
    DataPointsFilters/OctreeGrid.cpp + utils/octree.hpp; the reference's
    optional std::async parallel build becomes vectorized host assignment +
    batched device statistics)."""
    # the random method permutes the rows with ``np.random.default_rng``
    # seeded by the key's second word, as the JAX package does

    PARAMS = (
        Param("buildParallel", "use threads to build the octree (accepted "
              "for parity; the build here is vectorized)", bool, True),
        Param("maxPointByNode", "Number of points under which the octree "
              "stops dividing", int, 1, min=1),
        Param("maxSizeByNode", "Size of the bounding box under which the "
              "octree stops dividing", float, 0.0, min=0.0),
        Param("samplingMethod", "0: first point, 1: random, 2: centroid "
              "(more accurate but costly), 3: medoid (more accurate but "
              "costly)", int, 0, min=0, max=3),
    )

    def filter(self, cloud, key=None, scan=None):
        c = _valid(cloud)
        n = c.num_points
        if n == 0:
            return cloud
        leaf = octree_split(c.points.cpu().numpy(), int(self.maxPointByNode),
                            float(self.maxSizeByNode))
        num = int(leaf.max()) + 1
        if self.samplingMethod in (0, 1):
            if self.samplingMethod == 0:
                perm = np.arange(n)
            else:
                perm = np.random.default_rng(key_word(key, scan)).permutation(n)
            order = perm[np.argsort(leaf[perm], kind="stable")]
            return _rows(c, _segment_firsts(leaf, order, num))
        seg = torch.as_tensor(leaf, device=c.device)
        plan = segment_plan(seg, num)
        counts, means, _ = segment_stats(c.points, seg, num, covariance=False,
                                         plan=plan)
        if self.samplingMethod == 2:                       # centroid
            return _new_cloud(means, _average_descriptors(c, seg, num, counts, plan),
                              _min_times(c, leaf, num))
        # medoid: the leaf's point nearest its centroid, d² on the device
        d2 = ((c.points - means[seg]) ** 2).sum(dim=1).cpu().numpy()
        return _rows(c, _segment_firsts(leaf, np.lexsort((d2, leaf)), num))


@DataPointsFilterRegistrar.register
class NormalSpaceDataPointsFilter(DataPointsFilter):
    r"""Normal-space sampling [\cite{Rusinkiewicz2001}]: bucket unit normals
    by (θ, φ), then uniformly draw from non-empty buckets until nbSample
    points are kept (reference: DataPointsFilters/NormalSpace.cpp; 3D only).
    The draw itself is inherently sequential and tiny → host-side with a
    seeded generator."""
    # a 2D cloud passes unchanged; the draw is the JAX package's host draw
    # (``np.random.default_rng(seed)``), so the kept rows are its rows

    PARAMS = (
        Param("nbSample", "Number of points to select.", int, 5000, min=1),
        Param("seed", "Seed for the random generator.", int, 1, min=0),
        Param("epsilon", "Step of discretization for the angle spaces", float,
              0.09817477042, min=0.04908738521, max=3.14159265359),
    )

    def filter(self, cloud, key=None, scan=None):
        if cloud.dim != 3:
            return cloud
        n = cloud.count_host()
        if self.nbSample >= n:
            return cloud
        if not cloud.has_descriptor("normals"):
            raise InvalidField(
                "NormalSpaceDataPointsFilter: cannot find normals in descriptors")
        c = _valid(cloud)
        normals = c.get_descriptor("normals").cpu().numpy()
        eps = self.epsilon
        n_theta = int(math.ceil(math.pi / eps))
        n_phi = int(math.ceil(2 * math.pi / eps))
        theta = np.arccos(np.clip(normals[:, 2], -1.0, 1.0))
        phi = np.mod(np.arctan2(normals[:, 1], normals[:, 0]) + 2 * math.pi,
                     2 * math.pi)
        bucket = (np.floor(theta / eps).astype(np.int64) * n_phi
                  + np.floor(phi / eps).astype(np.int64))
        bucket = np.clip(bucket, 0, n_theta * n_phi - 1)

        rng = np.random.default_rng(self.seed)
        # each bucket's members contiguous, in the permutation's order;
        # drawing from a run's end is the reference's per-bucket stack
        order = rng.permutation(n)
        grouped = order[np.argsort(bucket[order], kind="stable")]
        _, counts = np.unique(bucket, return_counts=True)
        ends = np.cumsum(counts)
        remaining = counts.copy()
        alive = np.arange(len(counts))            # the non-empty buckets
        n_alive = len(alive)
        keep = np.empty(self.nbSample, np.int64)
        # uniform draw over the non-empty buckets (NormalSpace.cpp:66-150)
        for j in range(self.nbSample):
            ai = int(rng.integers(n_alive))
            b = alive[ai]
            remaining[b] -= 1
            keep[j] = grouped[ends[b] - 1 - (counts[b] - 1 - remaining[b])]
            if remaining[b] == 0:
                n_alive -= 1
                alive[ai] = alive[n_alive]
        return _rows(c, keep)


def covariance_greedy(mag: np.ndarray, nb: int) -> np.ndarray:
    """CovarianceSampling's greedy pick (reference:
    CovarianceSampling.cpp:112-180), the arithmetic of the JAX package's
    compiled ``native/pm_native.cpp::pm_covariance_greedy`` in float64:
    each direction's rows ordered by descending |mag| (the lower index
    first on ties); each pick takes the direction with the least
    accumulated constraint (the first on ties) and its next row not yet
    taken, then adds that row's mag² to the constraints. ``mag`` is
    [n, 6]; returns the ``min(nb, n)`` picked rows in pick order."""
    mag = np.asarray(mag, np.float64)
    n = mag.shape[0]
    nb = min(nb, n)
    m = min(2 * nb, n)    # a direction's pointer passes at most 2·nb rows
    order = np.argsort(-np.abs(mag), axis=0, kind="stable")[:m].T.tolist()
    mag2 = mag * mag
    taken = bytearray(n)
    ptr = [0] * 6
    t = [0.0] * 6
    keep = []
    for _ in range(nb):
        k = min(range(6), key=t.__getitem__)
        ordk = order[k]
        p = ptr[k]
        while p < m and taken[ordk[p]]:
            p += 1
        if p >= m:
            break
        idx = ordk[p]
        ptr[k] = p + 1
        taken[idx] = 1
        row = mag2[idx].tolist()
        for j in range(6):
            t[j] += row[j]
        keep.append(idx)
    return np.asarray(keep, np.int64)


@DataPointsFilterRegistrar.register
class CovarianceSamplingDataPointsFilter(DataPointsFilter):
    """Covariance (stability) sampling [\\cite{Gelfand2003}]: greedily
    keeps points that constrain the six eigen-directions of the
    torque-normalised 6x6 covariance equally (reference:
    DataPointsFilters/CovarianceSampling.cpp; 3D only, needs normals). The
    constraint vectors, the covariance and its ``eigh`` run on the device
    in float32; the sequential pick on the host (:func:`covariance_greedy`)."""
    DESCRIPTION = r"""Covariance (stability) sampling [\cite{Gelfand2003}]: greedily select
    points that constrain the 6 eigen-directions of the torque-normalized
    6x6 covariance equally (reference:
    DataPointsFilters/CovarianceSampling.cpp; 3D only, needs normals).
    The 6-D constraint vectors and covariance are computed on device; the
    greedy selection — sequential by construction (every pick updates the
    constraint totals that choose the next direction) — runs compiled in
    C++ (native/pm_native.cpp::pm_covariance_greedy, mirroring the
    reference's compiled loop, CovarianceSampling.cpp:112-180), with a
    single-program device ``fori_loop`` fallback when no toolchain is
    available. No per-sample Python loop on any path (a host loop cost
    ~1 s at the default nbSample=5000 on 10^5 points; the compiled pick
    is ~50 ms)."""

    PARAMS = (
        Param("nbSample", "Number of points to select.", int, 5000, min=1),
        Param("torqueNorm", "Torque normalization: 0 = L1 (none), 1 = Lavg "
              "(average distance), 2 = Lmax (scale in unit ball)", int, 1,
              min=0, max=2),
    )

    def constraint_magnitudes(self, c: PointCloud) -> torch.Tensor:
        """Each point's magnitude on each eigen-direction → [n, 6]."""
        pts = c.points
        nrm = c.get_descriptor("normals")
        p = pts - pts.mean(dim=0)
        if self.torqueNorm == 0:
            lnorm = 1.0
        elif self.torqueNorm == 1:
            lnorm = torch.linalg.vector_norm(p, dim=1).mean()
        else:
            lnorm = (pts.amax(dim=0) - pts.amin(dim=0)).amax() / 2.0
        v = torch.cat([torch.linalg.cross(p, nrm) / lnorm, nrm], dim=1)
        _, eigve = torch.linalg.eigh(v.T @ v)
        return v @ eigve

    def filter(self, cloud, key=None, scan=None):
        if cloud.dim != 3:
            raise InvalidField("CovarianceSamplingDataPointsFilter: 3D only")
        if self.nbSample >= cloud.count_host():
            return cloud
        if not cloud.has_descriptor("normals"):
            raise InvalidField(
                "CovarianceSamplingDataPointsFilter: cannot find normals in "
                "descriptors")
        c = _valid(cloud)
        mag = self.constraint_magnitudes(c).cpu().numpy()
        return _rows(c, covariance_greedy(mag, int(self.nbSample)))


@DataPointsFilterRegistrar.register
class ElipsoidsDataPointsFilter(DataPointsFilter):
    """Surfel (ellipsoid) decomposition: the SamplingSurfaceNormal box split
    with richer per-surfel outputs — means, covariances, weights (point
    counts), shape parameters (planarity/cylindricality/sphericality)
    (reference: DataPointsFilters/Elipsoids.cpp)."""
    # the output has the input's valid rows: samplingMethod 0 keeps each at
    # random (JAX's draw over those rows), 1 keeps each box's first row at
    # the box mean; unfit boxes (degenerate, longer than ``maxBoxDim``, less
    # planar than ``minPlanarity``, spread over more than ``maxTimeWindow``)
    # keep none. The first time channel becomes [min, max, mean] of the
    # row's box.

    PARAMS = (
        Param("ratio", "ratio of points to keep with random subsampling",
              float, 0.5, min=0.0000001, max=0.9999999),
        Param("knn", "number of points per box (box split threshold)", int,
              7, min=3),
        Param("samplingMethod", "0: random subsampling with ratio; 1: one "
              "point per box", int, 0, min=0, max=1),
        Param("maxBoxDim", "maximum box length above which it is discarded",
              float, "inf"),
        Param("maxTimeWindow", "maximum time spread of a surfel", float, "inf"),
        Param("minPlanarity", "minimum planarity to keep a surfel", float, 0.0),
        Param("averageExistingDescriptors", "average existing descriptors "
              "over the box", bool, True),
        Param("keepNormals", "add normals", bool, True),
        Param("keepDensities", "add densities", bool, False),
        Param("keepEigenValues", "add eigen values", bool, False),
        Param("keepEigenVectors", "add eigen vectors", bool, False),
        Param("keepCovariances", "add covariances", bool, False),
        Param("keepWeights", "add per-surfel point counts", bool, False),
        Param("keepMeans", "add box means", bool, False),
        Param("keepShapes", "add planarity/cylindricality/sphericality", bool,
              False),
        Param("keepIndices", "accepted for parity; per-surfel member indices "
              "are not materialized in the fixed-shape design", bool, False),
    )

    def filter(self, cloud, key=None, scan=None):
        c = _valid(cloud)
        n, d = c.num_points, c.dim
        if n == 0:
            return cloud
        dev = c.device
        box = median_split_boxes(c.points.cpu().numpy(), int(self.knn))
        num = int(box.max()) + 1
        seg = torch.as_tensor(box, device=dev)
        pts = c.points
        plan = segment_plan(seg, num)
        counts, means, C = segment_stats(pts, seg, num, plan=plan)
        eigva, eigve = batched_eigh(C)

        box_dim = (_segment_extreme(pts, seg, num, "amax")
                   - _segment_extreme(pts, seg, num, "amin")).amax(dim=1)
        max_cnorm = _segment_extreme(torch.linalg.vector_norm(pts - means[seg], dim=1),
                                     seg, num, "amax")
        lam_max = torch.clamp(eigva[:, -1], min=1e-30)
        unfit = (eigva[:, 1] <= lam_max * 1e-9) | (box_dim > self.maxBoxDim)
        # shapes from the eigenvalues in descending order; in 2D the third
        # is the second, as the JAX package's clamped index reads it
        va_desc = eigva.flip(1)
        vals = va_desc / torch.clamp(va_desc.sum(dim=1, keepdim=True), min=1e-30)
        third = vals[:, min(2, d - 1)]
        planarity = 2.0 * (vals[:, 1] - third)
        cylindricality = vals[:, 0] - vals[:, 1]
        sphericality = 3.0 * third
        if self.minPlanarity > 0:
            unfit = unfit | (planarity < self.minPlanarity)

        new_times = {}
        if c.times:
            tname = next(iter(c.times))
            tvals = c.times[tname][:, 0].cpu().numpy()
            tmin = np.full(num, _I64_MAX)
            tmax = np.full(num, np.iinfo(np.int64).min)
            tsum = np.zeros(num, np.float64)
            np.minimum.at(tmin, box, tvals)
            np.maximum.at(tmax, box, tvals)
            np.add.at(tsum, box, tvals.astype(np.float64))
            tmean = (tsum / np.maximum(counts.cpu().numpy(), 1)).astype(np.int64)
            if self.maxTimeWindow != float("inf"):
                unfit = unfit | torch.as_tensor((tmax - tmin) > self.maxTimeWindow,
                                                device=dev)
            new_times[tname] = np.stack([tmin, tmax, tmean], axis=1)[box]

        if self.samplingMethod == 0:
            keep = self.draw_uniform(c, key, scan) < self.ratio
            out_pts = pts
        else:
            first = np.full(num, n, np.int64)
            np.minimum.at(first, box, np.arange(n))
            keep = torch.zeros(n, dtype=torch.bool, device=dev)
            keep[torch.as_tensor(first, device=dev)] = True
            out_pts = means[seg]
        keep = keep & ~unfit[seg]

        descs = dict(c.descriptors)
        if self.samplingMethod == 1 and self.averageExistingDescriptors:
            descs = {k: v[seg] for k, v in
                     _average_descriptors(c, seg, num, counts, plan).items()}
        if self.keepNormals:
            descs["normals"] = torch.clamp(eigve[:, :, 0], -1.0, 1.0)[seg]
        if self.keepDensities:
            volume = (4.0 / 3.0) * math.pi * torch.clamp(max_cnorm, min=1e-12) ** 3
            descs["densities"] = (counts / volume)[seg][:, None]
        if self.keepEigenValues:
            descs["eigValues"] = eigva[seg]
        if self.keepEigenVectors:
            descs["eigVectors"] = eigve.reshape(num, d * d)[seg]
        if self.keepCovariances:
            descs["covariance"] = C.reshape(num, d * d)[seg]
        if self.keepWeights:
            descs["weights"] = counts[seg][:, None]
        if self.keepMeans:
            descs["means"] = means[seg]
        if self.keepShapes:
            descs["shapes"] = torch.stack(
                [planarity, cylindricality, sphericality], dim=1)[seg]
        out = _new_cloud(out_pts, descs, new_times)
        return out.with_mask(keep)
