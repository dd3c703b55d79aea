"""The port's data filters against the JAX package's, on the CPU.

Each of the 22 filters the port added to the five it had is held to its
JAX counterpart on the same seeded clouds (2D and 3D where the filter
takes both), with the same keys: masks and kept rows equal, time channels
equal, descriptors equal or within the tolerance stated where a sum,
``eigh`` or ``acos`` is formed in another order (rtol 1e-5 / atol 1e-6;
eigenvectors up to their sign), and the same error type on the same bad
input. Also: the registry's names, parameters and ``TRACEABLE`` set equal
JAX's; MaxPointCount keeps JAX's rows where draws collide (a stable sort);
MaxQuantileOnAxis forms its index as a float32 product; OctreeGrid and
Gestalt seed numpy with the key's second word; CovarianceSampling's pick
equals the JAX package's compiled pick bit for bit.
"""

import math

import jax
import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.errors import InvalidField as JInvalidField
from libpointmatcher_tpu.errors import InvalidParameter as JInvalidParameter
from libpointmatcher_tpu.filters.base import DataPointsFilterRegistrar as JReg
from libpointmatcher_tpu.io import native

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.errors import InvalidField, InvalidParameter
from libpointmatcher_tpu_torch.filters import sampling
from libpointmatcher_tpu_torch.filters.base import DataPointsFilterRegistrar as TReg
from libpointmatcher_tpu_torch.filters.base import ScanKeys, key_word
from libpointmatcher_tpu_torch.utils import prng

CPU = "cpu"
RTOL, ATOL = 1e-5, 1e-6
#: descriptors whose columns are eigenvectors, compared up to sign
EIGVEC = {"eigVectors"}
#: descriptors that are a normal, compared up to sign
NORMAL = {"normals"}


def _scene(n, seed, dim=3):
    """Points on three axis planes and a tilted one, 2 mm of noise; in 2D
    the x-y trace of the same."""
    rng = np.random.default_rng(seed)
    k = n // 4
    parts = [np.c_[rng.uniform(0, 5, k), rng.uniform(0, 4, k), np.zeros(k)],
             np.c_[rng.uniform(0, 5, k), np.zeros(k), rng.uniform(0, 3, k)],
             np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 3, k)]]
    a, b = rng.uniform(0, 2, n - 3 * k), rng.uniform(0, 2, n - 3 * k)
    parts.append(np.c_[2 + a, 1 + b, 0.5 + 0.3 * a + 0.2 * b])
    pts = np.concatenate(parts) + 0.002 * rng.standard_normal((n, 3))
    return pts[:, :dim].astype(np.float32)


def _unit(rng, n, dim=3):
    v = rng.standard_normal((n, dim)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _times(n, seed):
    rng = np.random.default_rng(seed)
    return {"stamps": (1_700_000_000_000_000_000
                       + rng.integers(0, 10**9, (n, 1))).astype(np.int64)}


def _keys(seed):
    """The same key in both packages: fold_in(PRNGKey(seed), 2)."""
    return (jax.random.fold_in(jax.random.PRNGKey(seed), 2),
            prng.fold_in(prng.prng_key(seed), 2))


def _run(name, params, pts, descs=None, times=None, seed=None):
    """Filter ``name`` in both packages on the same rows → (jax cloud,
    port cloud)."""
    kj, kt = _keys(seed) if seed is not None else (None, None)
    cj = JReg.create(name, params).filter(
        pm.PointCloud.from_numpy(pts, descs, times), key=kj)
    ct = TReg.create(name, params).filter(
        pt.PointCloud.from_numpy(pts, descs, device=CPU, times=times), key=kt)
    return cj, ct


def _errors(name, params, pts, descs=None):
    """The same error type in both packages."""
    with pytest.raises((JInvalidField, JInvalidParameter)) as ej:
        JReg.create(name, params).filter(pm.PointCloud.from_numpy(pts, descs))
    with pytest.raises((InvalidField, InvalidParameter)) as et:
        TReg.create(name, params).filter(
            pt.PointCloud.from_numpy(pts, descs, device=CPU))
    assert type(ej.value).__name__ == type(et.value).__name__
    assert str(ej.value) == str(et.value)


def _signed(vt, vj):
    """``vt``'s rows with the sign of ``vj``'s."""
    s = np.where(np.sum(vt * vj, axis=1) < 0, -1.0, 1.0)
    return vt * s[:, None]


def _same(cj, ct, exact=(), tol=(RTOL, ATOL)):
    """Valid rows, descriptors (in order) and times equal; points and
    descriptors within ``tol`` except those named in ``exact``."""
    pj, dj, tj = cj.to_numpy()
    pt_, dt, tt = ct.to_numpy(with_times=True)
    assert pt_.shape == pj.shape
    if "points" in exact:
        np.testing.assert_array_equal(pt_, pj)
    else:
        np.testing.assert_allclose(pt_, pj, rtol=tol[0], atol=tol[1])
    assert list(dt) == list(dj)
    for k in dj:
        vt, vj = dt[k], dj[k]
        if k in NORMAL:
            vt = _signed(vt, vj)
        if k in EIGVEC:
            d = int(round(math.sqrt(vj.shape[1])))
            vt = vt.reshape(-1, d, d)
            vj = vj.reshape(-1, d, d)
            s = np.where(np.sum(vt * vj, axis=1, keepdims=True) < 0, -1.0, 1.0)
            vt, vj = (vt * s).reshape(len(vt), -1), vj.reshape(len(vj), -1)
        if k in exact:
            np.testing.assert_array_equal(vt, vj, err_msg=k)
        else:
            np.testing.assert_allclose(vt, vj, rtol=tol[0], atol=tol[1], err_msg=k)
    assert list(tt) == list(tj)
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k], err_msg=k)


def _mask(cj, ct, n):
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask)[:n])


# ------------------------------------------------------------------ registry
def test_registry_equals_jax():
    assert sorted(TReg._classes) == sorted(JReg._classes)
    assert len(TReg._classes) == 27
    for name, jcls in JReg._classes.items():
        tcls = TReg._classes[name]
        jp = [(p.name, p.type, p.default, p.min, p.max) for p in jcls.PARAMS]
        tp = [(p.name, p.type, p.default, p.min, p.max) for p in tcls.PARAMS]
        assert tp == jp, name
        assert [p.doc for p in tcls.PARAMS] == [p.doc for p in jcls.PARAMS], name
    traced = {n for n, c in JReg._classes.items() if getattr(c, "TRACEABLE", False)}
    assert {n for n, c in TReg._classes.items() if c.TRACEABLE} == traced


# ------------------------------------------------------------ per-row rules
ROW_CASES = [
    ("IdentityDataPointsFilter", {}),
    ("MaxDistDataPointsFilter", {"dim": "-1", "maxDist": "4.2"}),
    ("MaxDistDataPointsFilter", {"dim": "-1", "maxDist": "-4.2"}),
    ("MaxDistDataPointsFilter", {"dim": "0", "maxDist": "2.5"}),
    ("MaxDistDataPointsFilter", {"dim": "1", "maxDist": "1.5"}),
    ("MinDistDataPointsFilter", {"dim": "-1", "minDist": "2.0"}),
    ("MinDistDataPointsFilter", {"dim": "1", "minDist": "1.0"}),
    ("MinDistDataPointsFilter", {"dim": "-1", "minDist": "-3.0"}),
    ("DistanceLimitDataPointsFilter", {"dim": "-1", "dist": "3.0"}),
    ("DistanceLimitDataPointsFilter", {"dim": "0", "dist": "2.0",
                                       "removeInside": "0"}),
    ("BoundingBoxDataPointsFilter", {"xMin": "1", "xMax": "3", "yMin": "0.5",
                                     "yMax": "2.5", "zMin": "-1", "zMax": "1"}),
    ("BoundingBoxDataPointsFilter", {"xMin": "1", "xMax": "3", "yMin": "0.5",
                                     "yMax": "2.5", "zMin": "-1", "zMax": "1",
                                     "removeInside": "0"}),
    ("MaxQuantileOnAxisDataPointsFilter", {"dim": "0", "ratio": "0.5"}),
    ("MaxQuantileOnAxisDataPointsFilter", {"dim": "1", "ratio": "0.9"}),
    ("ObservationDirectionDataPointsFilter", {"x": "1.5", "y": "-2", "z": "0.5"}),
]


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name,params", ROW_CASES)
def test_row_rules(name, params, dim):
    pts = _scene(2000, 1, dim)
    cj, ct = _run(name, params, pts, times=_times(2000, 1))
    _mask(cj, ct, 2000)
    _same(cj, ct, exact=("points", "observationDirections"))
    assert 0 < ct.count_host() <= 2000


def test_remove_nan():
    pts = _scene(1500, 2)
    pts[::7, 1] = np.nan
    pts[::11, 2] = np.inf
    cj, ct = _run("RemoveNaNDataPointsFilter", {}, pts)
    _mask(cj, ct, 1500)
    assert ct.count_host() < 1500


def test_max_quantile_at_a_float32_edge():
    # 1300 · 0.7 is 909.999… in float64 and 910 as a float32 product: the
    # JAX package (and the port) take index 910
    n, ratio = 1300, 0.7
    assert int(n * ratio) == 909 and int(np.float32(n) * np.float32(ratio)) == 910
    pts = np.random.default_rng(3).permutation(n).astype(np.float32)[:, None]
    pts = np.c_[pts, np.zeros((n, 2), np.float32)]
    cj, ct = _run("MaxQuantileOnAxisDataPointsFilter",
                  {"dim": "0", "ratio": str(ratio)}, pts)
    _mask(cj, ct, n)
    assert ct.count_host() == 910


@pytest.mark.parametrize("name,params", [
    ("MaxDistDataPointsFilter", {"dim": "2"}),
    ("MinDistDataPointsFilter", {"dim": "2"}),
    ("DistanceLimitDataPointsFilter", {"dim": "2"}),
    ("MaxQuantileOnAxisDataPointsFilter", {"dim": "2"}),
])
def test_bad_dim_in_2d(name, params):
    _errors(name, params, _scene(300, 4, 2))


@pytest.mark.parametrize("max_density", ["50", "400", "5000"])
def test_max_density(max_density):
    rng = np.random.default_rng(5)
    pts = _scene(2500, 5)
    dens = rng.uniform(10, 1000, 2500).astype(np.float32)
    dens[rng.choice(2500, 40, replace=False)] = dens.max()     # saturated
    cj, ct = _run("MaxDensityDataPointsFilter", {"maxDensity": max_density},
                  pts, {"densities": dens}, seed=6)
    _mask(cj, ct, 2500)
    _same(cj, ct, exact=("points", "densities"))


@pytest.mark.parametrize("seed,max_count", [(1, 700), (0, 1999), (4, 5000)])
def test_max_point_count(seed, max_count):
    pts = _scene(2000, 7)
    cj, ct = _run("MaxPointCountDataPointsFilter",
                  {"seed": str(seed), "maxCount": str(max_count)}, pts,
                  times=_times(2000, 7))
    _mask(cj, ct, 2000)
    assert ct.count_host() == min(max_count, 2000)


def test_max_point_count_colliding_draws():
    # at 10^5 rows float32 draws collide; maxCount at a tie that straddles
    # the cut, so which of the tied rows stays is the sort's tie order
    n, seed = 100_000, 3
    r = prng.uniform(prng.prng_key(seed), n).numpy()
    s = np.sort(r, kind="stable")
    ties = np.flatnonzero(s[1:] == s[:-1]) + 1
    assert len(ties) > 50
    max_count = int(ties[len(ties) // 2])
    pts = np.random.default_rng(8).uniform(-5, 5, (n, 3)).astype(np.float32)
    cj, ct = _run("MaxPointCountDataPointsFilter",
                  {"seed": str(seed), "maxCount": str(max_count)}, pts)
    _mask(cj, ct, n)
    keep = ct.mask.numpy()
    tied = np.flatnonzero(r == s[max_count])
    assert keep[tied].any() and not keep[tied].all()


def _normals_cloud(n, seed, dim=3):
    rng = np.random.default_rng(seed)
    pts = _scene(n, seed, dim) + np.float32(0.5)
    normals = _unit(rng, n, dim)
    normals[::13] = 0.0
    return pts, normals


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name,params", [
    ("ShadowDataPointsFilter", {"eps": "0.1"}),
    ("ShadowDataPointsFilter", {"eps": "0.7"}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": "1"}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": "0"}),
    ("IncidenceAngleDataPointsFilter", {}),
])
def test_normal_rules(name, params, dim):
    pts, normals = _normals_cloud(2000, 9, dim)
    od = np.float32(1.0) - pts
    od[5] = 0.0                                # scalar 0: the normal is kept
    cj, ct = _run(name, params, pts,
                  {"normals": normals, "observationDirections": od})
    _mask(cj, ct, 2000)
    # acos within a few ulp of its value
    _same(cj, ct, exact=("points", "normals", "observationDirections"))


@pytest.mark.parametrize("name,missing", [
    ("ShadowDataPointsFilter", "normals"),
    ("OrientNormalsDataPointsFilter", "normals"),
    ("OrientNormalsDataPointsFilter", "observationDirections"),
    ("IncidenceAngleDataPointsFilter", "observationDirections"),
    ("MaxDensityDataPointsFilter", "densities"),
    ("SphericalityDataPointsFilter", "eigValues"),
    ("RemoveSensorBiasDataPointsFilter", "incidenceAngles"),
    ("RemoveSensorBiasDataPointsFilter", "observationDirections"),
    ("NormalSpaceDataPointsFilter", "normals"),
    ("CovarianceSamplingDataPointsFilter", "normals"),
])
def test_missing_descriptor(name, missing):
    pts = _scene(300, 10)
    descs = {"normals": _unit(np.random.default_rng(0), 300),
             "observationDirections": -pts, "densities": np.ones(300),
             "eigValues": np.ones((300, 3)), "incidenceAngles": np.zeros(300)}
    del descs[missing]
    params = {"nbSample": "100"} if "Sampl" in name or "Space" in name else {}
    _errors(name, params, pts, descs)


@pytest.mark.parametrize("params", [
    {"descName": "intensity", "useLargerThan": "1", "threshold": "0.4"},
    {"descName": "intensity", "useLargerThan": "0", "threshold": "0.4"},
])
def test_cut_at_descriptor_threshold(params):
    pts = _scene(1000, 11)
    inten = np.random.default_rng(11).uniform(0, 1, 1000).astype(np.float32)
    inten[::17] = np.nan
    cj, ct = _run("CutAtDescriptorThresholdDataPointsFilter", params, pts,
                  {"intensity": inten})
    _mask(cj, ct, 1000)
    _errors("CutAtDescriptorThresholdDataPointsFilter", {"descName": "other"},
            pts, {"intensity": inten})


@pytest.mark.parametrize("params", [
    {}, {"keepUnstructureness": "1", "keepStructureness": "1"}])
def test_sphericality(params):
    rng = np.random.default_rng(12)
    pts = _scene(1000, 12)
    eig = np.sort(rng.exponential(1.0, (1000, 3)), axis=1).astype(np.float32)
    eig[::9] = 0.0                              # λ1 ≤ 0: NaN
    eig[5] = [0.0, 0.0, 1.0]
    cj, ct = _run("SphericalityDataPointsFilter", params, pts, {"eigValues": eig})
    _same(cj, ct, exact=("points", "eigValues"))
    assert np.isnan(ct.get_descriptor("sphericality").numpy()[::9]).all()
    _errors("SphericalityDataPointsFilter", params, _scene(300, 12, 2),
            {"eigValues": eig[:300, :2]})


# ---------------------------------------------------------------- sampling
def test_segment_sums_equal_jax():
    rng = np.random.default_rng(13)
    pts = rng.standard_normal((3000, 3)).astype(np.float32)
    seg = rng.integers(0, 400, 3000)
    from libpointmatcher_tpu.filters.sampling import _segment_stats

    cj, mj, Cj = (np.asarray(x) for x in _segment_stats(
        jax.numpy.asarray(pts), jax.numpy.asarray(seg), 400))
    ct, mt, Ct = (x.numpy() for x in sampling.segment_stats(
        torch.from_numpy(pts), torch.from_numpy(seg), 400))
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_allclose(mt, mj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(Ct, Cj, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("params", [
    {"vSizeX": "0.3", "vSizeY": "0.3", "vSizeZ": "0.3"},
    {"vSizeX": "0.5", "vSizeY": "0.2", "vSizeZ": "0.7", "useCentroid": "0"},
    {"vSizeX": "0.4", "vSizeY": "0.4", "vSizeZ": "0.4",
     "averageExistingDescriptors": "0"},
])
def test_voxel_grid(params, dim):
    pts = _scene(3000, 14, dim)
    inten = np.linspace(0, 1, 3000, dtype=np.float32)
    cj, ct = _run("VoxelGridDataPointsFilter", params, pts, {"intensity": inten},
                  _times(3000, 14))
    _same(cj, ct)
    assert ct.count_host() < 3000


def test_voxel_grid_nan_raises():
    pts = _scene(300, 15)
    pts[3, 0] = np.nan
    _errors("VoxelGridDataPointsFilter", {}, pts)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("method", [0, 1, 2, 3])
@pytest.mark.parametrize("node", [{"maxPointByNode": "1"},
                                  {"maxPointByNode": "12"},
                                  {"maxPointByNode": "40", "maxSizeByNode": "0.5"}])
def test_octree_grid(method, node, dim):
    pts = _scene(2000, 16, dim)
    inten = np.linspace(0, 1, 2000, dtype=np.float32)
    params = dict(node, samplingMethod=str(method))
    cj, ct = _run("OctreeGridDataPointsFilter", params, pts, {"intensity": inten},
                  _times(2000, 16), seed=17)
    _same(cj, ct, exact=() if method == 2 else ("points", "intensity"))


@pytest.mark.parametrize("name,params", [
    ("OctreeGridDataPointsFilter", {"maxPointByNode": "10", "samplingMethod": "1"}),
    ("GestaltDataPointsFilter", {"ratio": "0.5", "radius": "0.8"}),
])
def test_key_word_seeding(name, params):
    pts = _scene(1500, 18)
    same = _same_gestalt if name.startswith("Gestalt") else (
        lambda cj, ct: _same(cj, ct, exact=("points",)))
    outs = [_run(name, params, pts)] + [_run(name, params, pts, seed=seed)
                                        for seed in (1, 9)]  # no key: seed 0
    for cj, ct in outs:
        same(cj, ct)
    first = outs[0][1].points.numpy()
    assert any(ct.num_points != len(first) or not np.array_equal(
        ct.points.numpy(), first) for _, ct in outs[1:])
    # a batch's scan takes its own key's word
    keys = ScanKeys([prng.fold_in(prng.prng_key(4), i) for i in range(3)], 10, CPU)
    for i in range(3):
        assert key_word(keys, i) == int(keys.keys[i][1])
    assert key_word(None) == int(np.asarray(jax.random.key_data(
        jax.random.PRNGKey(0)))[-1]) == 0
    kj, kt = _keys(5)
    assert key_word(kt) == int(np.asarray(jax.random.key_data(kj))[-1])


def test_octree_split_equals_jax():
    from libpointmatcher_tpu.filters.sampling import _octree_split

    for dim in (2, 3):
        pts = _scene(2500, 19, dim)
        for mp, ms in ((1, 0.0), (7, 0.0), (20, 0.3)):
            np.testing.assert_array_equal(sampling.octree_split(pts, mp, ms),
                                          _octree_split(pts, mp, ms))


@pytest.mark.parametrize("params", [
    {"nbSample": "400"}, {"nbSample": "900", "seed": "7", "epsilon": "0.3"}])
def test_normal_space(params):
    pts, normals = _normals_cloud(2000, 20)
    cj, ct = _run("NormalSpaceDataPointsFilter", params, pts,
                  {"normals": normals}, _times(2000, 20))
    _same(cj, ct, exact=("points", "normals"))
    assert ct.count_host() == int(params["nbSample"])


def test_normal_space_passes_2d_and_small():
    pts, normals = _normals_cloud(500, 21, 2)
    cj, ct = _run("NormalSpaceDataPointsFilter", {"nbSample": "100"}, pts,
                  {"normals": normals})
    _same(cj, ct, exact=("points", "normals"))
    assert ct.count_host() == 500
    pts, normals = _normals_cloud(500, 21)
    cj, ct = _run("NormalSpaceDataPointsFilter", {"nbSample": "600"}, pts,
                  {"normals": normals})
    assert ct.count_host() == 500


@pytest.mark.parametrize("nb", [1, 50, 700, 2500])
def test_covariance_greedy_bit_equal_to_native(nb):
    rng = np.random.default_rng(nb)
    mag = rng.standard_normal((2000, 6)) * rng.uniform(0.1, 3.0, 6)
    mag[::5, 2] = mag[1::5, 2][:len(mag[::5, 2])]               # ties in |mag|
    mag[7::11, 4] = -mag[7::11, 4]
    want = native.covariance_greedy(mag, nb)
    assert want is not None, "the JAX package's compiled pick did not load"
    np.testing.assert_array_equal(sampling.covariance_greedy(mag, nb), want)


@pytest.mark.parametrize("params", [
    {"nbSample": "300"}, {"nbSample": "800", "torqueNorm": "0"},
    {"nbSample": "500", "torqueNorm": "2"}])
def test_covariance_sampling(params):
    # a cloud over planes of several orientations with random normals: the
    # 6x6 covariance's eigenvalues stand apart (314-649, gaps of 13 or
    # more), so its eigenbasis is the same in both packages up to sign and
    # rounding (mag within 1e-5). The kept rows are the same set; their
    # pick order may differ where two directions' constraint totals tie
    # within that rounding, so rows are compared by their index
    pts, normals = _normals_cloud(2000, 22)
    index = np.arange(2000, dtype=np.float32)
    cj, ct = _run("CovarianceSamplingDataPointsFilter", params, pts,
                  {"normals": normals, "index": index}, _times(2000, 22))
    (pj, dj, tj), (pt_, dt, tt) = cj.to_numpy(), ct.to_numpy(with_times=True)
    oj, ot = np.argsort(dj["index"][:, 0]), np.argsort(dt["index"][:, 0])
    np.testing.assert_array_equal(dt["index"][ot], dj["index"][oj])
    np.testing.assert_array_equal(pt_[ot], pj[oj])
    np.testing.assert_array_equal(dt["normals"][ot], dj["normals"][oj])
    np.testing.assert_array_equal(tt["stamps"][ot], tj["stamps"][oj])
    assert len(ot) == int(params["nbSample"])
    _errors("CovarianceSamplingDataPointsFilter", params, _scene(300, 22, 2),
            {"normals": np.ones((300, 2))})


ELIPSOID_KEEP = {k: "1" for k in (
    "keepNormals", "keepDensities", "keepEigenValues", "keepEigenVectors",
    "keepCovariances", "keepWeights", "keepMeans", "keepShapes")}


@pytest.mark.parametrize("params", [
    {},
    dict(ELIPSOID_KEEP, samplingMethod="0", ratio="0.4"),
    dict(ELIPSOID_KEEP, samplingMethod="1", knn="12"),
    {"samplingMethod": "1", "averageExistingDescriptors": "0", "maxBoxDim": "0.4"},
    {"samplingMethod": "1", "minPlanarity": "0.5", "maxTimeWindow": "4e8"},
])
def test_elipsoids(params):
    pts = _scene(2500, 23)
    inten = np.linspace(0, 1, 2500, dtype=np.float32)
    cj, ct = _run("ElipsoidsDataPointsFilter", params, pts, {"intensity": inten},
                  _times(2500, 23), seed=24)
    _mask(cj, ct, 2500)
    _same(cj, ct, tol=(1e-4, 1e-5))
    assert 0 < ct.count_host() < 2500


def test_elipsoids_2d():
    # the JAX package's shapes read a third eigenvalue that a 2D cloud does
    # not have, and its index clamps to the second; the port does the same
    params = dict(ELIPSOID_KEEP, samplingMethod="1", maxBoxDim="0.6")
    cj, ct = _run("ElipsoidsDataPointsFilter", params, _scene(1500, 23, 2))
    _mask(cj, ct, 1500)
    _same(cj, ct, tol=(1e-4, 1e-5))


# -------------------------------------------------------------- descriptors
def _gestalt_bins_flipped(gt, flip):
    """Gestalt features [K, 32] of normals negated where ``flip``: angular
    bin a ↔ (a + 4) mod 8."""
    g = gt.reshape(-1, 4, 8)
    return np.where(flip[:, None, None], np.roll(g, 4, axis=2), g).reshape(-1, 32)


def _same_gestalt(cj, ct):
    """Keypoints, mask and times equal; normals up to sign; eigenvalues
    and covariances within 1e-4 relative to the row's largest (a near-zero
    eigenvalue carries the absolute error of the largest); the features
    under the bin map of each normal the port negated, within 1e-4."""
    np.testing.assert_array_equal(ct.mask.numpy(), np.asarray(cj.mask))
    pj, dj, tj = cj.to_numpy()
    pt_, dt, tt = ct.to_numpy(with_times=True)
    np.testing.assert_array_equal(pt_, pj)
    assert list(dt) == list(dj) and list(tt) == list(tj)
    for k in tj:
        np.testing.assert_array_equal(tt[k], tj[k])
    flip = np.sum(dt["normals"] * dj["normals"], axis=1) < 0
    for k in dj:
        vt, vj = dt[k], dj[k]
        atol = 1e-6
        if k == "normals":
            vt = _signed(vt, vj)
        elif k == "eigVectors":
            vt, vj = np.abs(vt), np.abs(vj)
        elif k in ("gestaltMeans", "gestaltVariances"):
            vt = _gestalt_bins_flipped(vt, flip)
        elif k in ("eigValues", "covariance"):
            atol = 1e-4 * np.abs(vj).max(axis=1, keepdims=True)
        bad = np.abs(vt - vj) > atol + 1e-4 * np.abs(vj)
        assert not bad.any(), (k, np.argwhere(bad)[:5], vt[bad][:5], vj[bad][:5])
    np.testing.assert_array_equal(dt["warpedXYZ"], 0.0)
    return flip


@pytest.mark.parametrize("params", [
    {"ratio": "0.3", "radius": "0.8"},
    {"ratio": "0.6", "radius": "1.5", "vSizeX": "0.5", "vSizeY": "0.7",
     "keepMeans": "1", "keepEigenValues": "1", "keepEigenVectors": "1",
     "keepCovariances": "1"},
])
def test_gestalt(params):
    pts = _scene(2500, 25)
    inten = np.linspace(0, 1, 2500, dtype=np.float32)
    cj, ct = _run("GestaltDataPointsFilter", params, pts, {"intensity": inten},
                  _times(2500, 25), seed=26)
    _same_gestalt(cj, ct)
    _errors("GestaltDataPointsFilter", params, _scene(300, 25, 2))


def test_gestalt_bin_map(monkeypatch):
    # every eigenvector negated: the normals negate and angular bin a of
    # the features becomes bin (a + 4) mod 8
    pts = torch.from_numpy(_scene(1500, 27))
    f = TReg.create("GestaltDataPointsFilter", {"radius": "1.0"})
    kp = pts[::150]
    ref = f._chunk(pts, kp)
    eigh = torch.linalg.eigh

    def negated(C):
        w, v = eigh(C)
        return w, -v

    monkeypatch.setattr(torch.linalg, "eigh", negated)
    neg = f._chunk(pts, kp)
    np.testing.assert_array_equal(neg[0].numpy(), -ref[0].numpy())
    flip = np.ones(len(kp), bool)
    for i in (5, 6):                            # means, variances
        np.testing.assert_allclose(_gestalt_bins_flipped(neg[i].numpy(), flip),
                                   ref[i].numpy(), rtol=1e-5, atol=1e-6)
    assert not np.allclose(neg[5].numpy(), ref[5].numpy())


@pytest.mark.parametrize("params", [{}, {"sensorType": "1", "angleThreshold": "60"}])
def test_remove_sensor_bias(params):
    rng = np.random.default_rng(28)
    pts = _scene(2000, 28) + np.float32(1.0)
    inc = rng.uniform(0, math.pi / 2, 2000).astype(np.float32)
    inc[::23] = np.nan
    inc[5] = 0.0
    inc[6] = 1e-6
    od = -pts
    od[7] = 0.0
    cj, ct = _run("RemoveSensorBiasDataPointsFilter", params, pts,
                  {"incidenceAngles": inc, "observationDirections": od},
                  _times(2000, 28))
    # float64 on the host in both packages: equal
    _same(cj, ct, exact=("points", "incidenceAngles", "observationDirections"))
    assert 0 < ct.count_host() < 2000


# ---------------------------------------------------------------- the cloud
def test_time_channels_follow_rows():
    n = 500
    pts = _scene(n, 29)
    times = {"stamps": np.arange(n, dtype=np.int64) * 10**12 + 2**40,
             "pair": np.stack([np.arange(n), -np.arange(n)], 1).astype(np.int64)}
    c = pt.PointCloud.from_numpy(pts, {"v": np.arange(n)}, CPU, times=times)
    assert c.has_time("stamps") and c.get_time("stamps").dtype == torch.int64
    assert c.get_time("stamps").shape == (n, 1)
    c2 = c.with_mask(torch.arange(n) % 3 == 0).compact()
    np.testing.assert_array_equal(c2.get_time("stamps").numpy()[:, 0],
                                  times["stamps"][::3])
    perm = torch.randperm(c2.num_points, generator=torch.Generator().manual_seed(0))
    c3 = c2.permute_rows(perm).to(CPU).replace(points=c2.points[perm] + 1)
    np.testing.assert_array_equal(c3.get_time("pair").numpy(),
                                  times["pair"][::3][perm.numpy()])
    pts_h, descs_h, times_h = c3.to_numpy(with_times=True)
    np.testing.assert_array_equal(times_h["stamps"][:, 0],
                                  c3.get_time("stamps").numpy()[:, 0])
    assert len(c3.to_numpy()) == 2
    c4 = c3.with_time("extra", np.arange(c3.num_points))
    assert list(c4.times) == ["stamps", "pair", "extra"]
    with pytest.raises(InvalidField):
        c3.with_time("bad", np.arange(3))
    # a batch of two scans keeps [B, N, span]
    b = pt.PointCloud(torch.zeros(2, 4, 3), times={"t": torch.ones(2, 4, 1)})
    assert b.with_time("u", np.zeros((2, 4), np.int64)).times["u"].shape == (2, 4, 1)
    # the JAX package's stamps equal after its int32 split
    cj = pm.PointCloud.from_numpy(pts, None, times)
    np.testing.assert_array_equal(cj.get_time("stamps")[:n], times["stamps"][:, None])
