"""The cell-grid search and the two matchers built on it, the port against
the JAX package on the CPU: ``build_cell_grid`` and ``cell_knn``
(``ops/cellgrid.py``), ``CellGridMatcher`` and ``KDTreeVarDistMatcher``
(its dense route and, with ``CULL_MIN_MAP`` lowered in both packages, its
culled route), and both matchers through one-shot ``ICP``,
``ICPSequence``, ``register_batch_to_map`` and ``register_queue_to_map``.

Held exactly: the grid's origin, dims, mc and valid ``order`` /
``cell_start`` entries; ids; which matches are finite; iteration counts and
stop codes; the route each driver takes. Held within tolerance: d², 2 ulp
(XLA's CPU compiler contracts the sum of squares into fused multiply-adds;
ROADMAP "Not divergences"), and poses, 1e-4 on rotation entries and 1e-4 ×
the scene extent on translation (the module-parity rule).
"""

import numpy as np
import pytest
import torch
from test_torch_batch import _room, _yaw_pose

import jax.numpy as jnp
import libpointmatcher_tpu as pm
from libpointmatcher_tpu import matchers as jax_matchers
from libpointmatcher_tpu.ops import cellgrid as jax_cellgrid
from libpointmatcher_tpu.parallel import queue_eligible as jax_queue_eligible
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_batch
from libpointmatcher_tpu.parallel import register_queue_to_map as jax_queue

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import matchers
from libpointmatcher_tpu_torch.ops import cellgrid
from libpointmatcher_tpu_torch.parallel import (queue_eligible,
                                                register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.parallel.batch import _host_path

CPU = "cpu"
SEED = 3
MAP_SEED = 5
#: the map rows from which the culled VarDist route serves in these tests
CULL = 256


def _ulp(a, b) -> int:
    """Largest distance in float32 ulps between the finite entries."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    f = np.isfinite(a)
    if not f.any():
        return 0
    return int(np.abs(a[f].view(np.int32).astype(np.int64)
                      - b[f].view(np.int32).astype(np.int64)).max())


def _assert_matches(dt, it, dj, ij, ulps=2):
    dt, it, dj, ij = (np.asarray(x) for x in (dt, it, dj, ij))
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(np.isfinite(dt), np.isfinite(dj))
    assert _ulp(dt, dj) <= ulps


def _case(d, seed=1, m=900, n=700):
    """References in [-3, 3]^d with 50 duplicated rows and every 9th
    masked; queries near them (20 on reference points), every 7th masked."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(-3, 3, (m, d)).astype(np.float32)
    r[100:150] = r[:50]
    rm = np.ones(m, bool)
    rm[::9] = False
    q = (r[rng.integers(0, m, n)] + 0.05 * rng.standard_normal((n, d))
         ).astype(np.float32)
    q[:20] = r[:20]
    qm = np.ones(n, bool)
    qm[::7] = False
    return q, qm, r, rm


@pytest.mark.parametrize("d", [2, 3])
def test_build_cell_grid_equals_jax(d):
    _, _, r, rm = _case(d)
    gj = jax_cellgrid.build_cell_grid(r, rm, 0.4)
    gt = cellgrid.build_cell_grid(r, rm, 0.4)
    np.testing.assert_array_equal(gt.origin.numpy(), np.asarray(gj.origin))
    assert gt.inv_cell.item() == float(gj.inv_cell)
    assert (gt.dims, gt.max_per_cell) == (gj.dims, gj.max_per_cell)
    np.testing.assert_array_equal(gt.cell_start.numpy(),
                                  np.asarray(gj.cell_start)[:len(gt.cell_start)])
    np.testing.assert_array_equal(gt.order.numpy(),
                                  np.asarray(gj.order)[:len(gt.order)])


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_cell_knn_equals_jax(d, k):
    q, qm, r, rm = _case(d)
    gj = jax_cellgrid.build_cell_grid(r, rm, 0.4)
    dj, ij = jax_cellgrid.cell_knn(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(r),
                                   gj, 0.4, k=k)
    gt = cellgrid.build_cell_grid(r, rm, 0.4)
    dt, it = cellgrid.cell_knn(torch.as_tensor(q), torch.as_tensor(qm),
                               torch.as_tensor(r), gt, 0.4, k=k)
    assert dt.shape == (len(q), k) and it.dtype == torch.int32
    _assert_matches(dt, it, dj, ij)
    assert np.isfinite(np.asarray(dj)).mean() > 0.3


@pytest.mark.parametrize("k", [1, 3])
def test_cell_knn_tiles_and_batch_axis(monkeypatch, k):
    """A 64-query tile and a [2, N, d] batch of queries give the one-call
    result of each scan."""
    q, qm, r, rm = _case(3, seed=2)
    g = cellgrid.build_cell_grid(r, rm, 0.5)
    args = (torch.as_tensor(r), g, 0.5)
    d1, i1 = cellgrid.cell_knn(torch.as_tensor(q), torch.as_tensor(qm), *args, k=k)
    monkeypatch.setattr(cellgrid, "QUERY_TILE", 64)
    d2, i2 = cellgrid.cell_knn(torch.as_tensor(q), torch.as_tensor(qm), *args, k=k)
    qb = torch.as_tensor(np.stack([q, q[::-1].copy()]))
    mb = torch.as_tensor(np.stack([qm, qm[::-1].copy()]))
    db, ib = cellgrid.cell_knn(qb, mb, *args, k=k)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    assert torch.equal(db[0], d1) and torch.equal(ib[0], i1)
    assert torch.equal(db[1], d1.flip(0)) and torch.equal(ib[1], i1.flip(0))


# ------------------------------------------------------------------ matchers
def _clouds(n=500, m=800, seed=3):
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(n, 3)).astype(np.float32)
    b = rng.normal(size=(m, 3)).astype(np.float32)
    return a, b


def _pair(a, b, descs=None):
    return ((pm.PointCloud.from_numpy(a, descs), pm.PointCloud.from_numpy(b)),
            (pt.PointCloud.from_numpy(a, descs, device=CPU),
             pt.PointCloud.from_numpy(b, device=CPU)))


@pytest.mark.parametrize("knn", [1, 2])
def test_cell_grid_matcher_equals_jax_and_dense(knn):
    """CellGridMatcher equals JAX's and the port's KDTreeMatcher with
    maxDist (ids where the neighbour is unique), and its touched pairs equal
    JAX's."""
    a, b = _clouds()
    (aj, bj), (at, bt) = _pair(a, b)
    params = {"knn": str(knn), "maxDist": "0.4"}
    mj = pm.MatcherRegistrar.create("CellGridMatcher", params)
    mt = pt.MatcherRegistrar.create("CellGridMatcher", params)
    mj.init(bj)
    mt.init(bt)
    rj, rt = mj.find_closests(aj), mt.find_closests_in(at, bt)
    _assert_matches(rt.dists, rt.ids, np.asarray(rj.dists)[:len(a)],
                    np.asarray(rj.ids)[:len(a)])
    kd = pt.MatcherRegistrar.create("KDTreeMatcher", params)
    rd = kd.find_closests_in(at, bt)
    np.testing.assert_array_equal(rd.dists.numpy(), rt.dists.numpy())
    np.testing.assert_array_equal(rd.ids.numpy(), rt.ids.numpy())
    assert mt.touched_per_iteration(at, bt) == mj.touched_per_iteration(aj, bj) > 0


def test_cell_grid_matcher_other_reference_runs_dense():
    """Against a reference of another shape than the one of ``init`` the
    search is the dense one with maxDist (the JAX package's fallback)."""
    a, b = _clouds()
    (aj, bj), (at, bt) = _pair(a, b)
    other = _clouds(m=600, seed=9)[1]
    params = {"knn": "2", "maxDist": "0.5"}
    mj = pm.MatcherRegistrar.create("CellGridMatcher", params)
    mt = pt.MatcherRegistrar.create("CellGridMatcher", params)
    mj.init(bj)
    mt.init(bt)
    rj = mj.find_closests_in(aj, pm.PointCloud.from_numpy(other, granule=128))
    rt = mt.find_closests_in(at, pt.PointCloud.from_numpy(other, device=CPU))
    _assert_matches(rt.dists, rt.ids, np.asarray(rj.dists)[:len(a)],
                    np.asarray(rj.ids)[:len(a)])


@pytest.mark.parametrize("knn", [1, 2])
def test_var_dist_dense_equals_jax(knn):
    """The dense route (a small map): the per-point radius masks the
    dense search, as JAX's does (tests/test_matchers.py::test_var_dist_matcher)."""
    a, b = _clouds(n=200, m=300, seed=0)
    radius = np.full(len(a), 0.3, np.float32)
    radius[:50] = 1e-6
    (aj, bj), (at, bt) = _pair(a, b, {"myRadius": radius})
    params = {"knn": str(knn), "maxDistField": "myRadius"}
    mj = pm.MatcherRegistrar.create("KDTreeVarDistMatcher", params)
    mt = pt.MatcherRegistrar.create("KDTreeVarDistMatcher", params)
    mj.init(bj)
    mt.init(bt)
    assert mt.prepare_loop(at) is None and mt._vd_grid is None
    rj, rt = mj.find_closests(aj), mt.find_closests_in(at, bt)
    _assert_matches(rt.dists, rt.ids, np.asarray(rj.dists)[:len(a)],
                    np.asarray(rj.ids)[:len(a)])
    assert np.isinf(rt.dists.numpy()[:50]).all()


@pytest.mark.parametrize("knn", [1, 2, 3])
def test_var_dist_culled_equals_jax_and_dense(monkeypatch, knn):
    """The culled route (``CULL_MIN_MAP`` lowered in both packages): the
    grid at the 1.25-ladder radius equals JAX's, the matches equal JAX's
    and the port's dense route, and the same radii keep the cached grid
    (tests/test_matchers.py::test_var_dist_culled_path_exact)."""
    monkeypatch.setattr(jax_matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", 10)
    monkeypatch.setattr(matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", 10)
    a, b = _clouds(n=500, m=700, seed=21)
    radius = np.random.default_rng(3).uniform(0.05, 0.6, len(a)).astype(np.float32)
    (aj, bj), (at, bt) = _pair(a, b, {"myRadius": radius})
    params = {"knn": str(knn), "maxDistField": "myRadius"}
    mj = pm.MatcherRegistrar.create("KDTreeVarDistMatcher", params)
    mt = pt.MatcherRegistrar.create("KDTreeVarDistMatcher", params)
    mj.init(bj)
    mt.init(bt)
    mj.prepare_loop(aj)
    assert mt.prepare_loop(at) is None
    grid = mt._vd_grid
    assert grid is not None and mt._vd_rmax == mj._vd_rmax
    assert (grid.dims, grid.max_per_cell) == (mj._vd_grid.dims,
                                              mj._vd_grid.max_per_cell)
    rj = mj.find_closests_in(aj, bj)
    rt = mt.find_closests_in(at, bt)
    _assert_matches(rt.dists, rt.ids, np.asarray(rj.dists)[:len(a)],
                    np.asarray(rj.ids)[:len(a)])
    dense = pt.MatcherRegistrar.create("KDTreeVarDistMatcher", params)
    dense.init(bt)
    rd = dense.find_closests_in(at, bt)
    np.testing.assert_array_equal(rd.dists.numpy(), rt.dists.numpy())
    np.testing.assert_array_equal(rd.ids.numpy(), rt.ids.numpy())
    mt.prepare_loop(at)
    assert mt._vd_grid is grid
    mt.invalidate_loop_state()
    assert mt._vd_grid is None


def test_var_dist_threshold_counts_jax_rows(monkeypatch):
    """The culled route's threshold compares the rows the JAX engine holds:
    a one-shot reference's bucket (700 valid rows: 768), an ICPSequence
    map's 512-row granule (1024)."""
    monkeypatch.setattr(matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", 768)
    _, b = _clouds(m=700)
    bt = pt.PointCloud.from_numpy(b, device=CPU)
    m = pt.MatcherRegistrar.create("KDTreeVarDistMatcher")
    m.init(bt)
    assert m._ref_host is not None
    monkeypatch.setattr(matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", 769)
    m.init(bt)
    assert m._ref_host is None
    m.init(bt, rows=1024)
    assert m._ref_host is not None


# ------------------------------------------------------------------- engines
CHAIN = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.8
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher:
  {matcher}
outlierFilters:
  - TrimmedDistOutlierFilter:
      ratio: 0.85
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker:
      maxIterationCount: 30
  - DifferentialTransformationChecker
"""
MATCHERS = {
    "cellgrid": "CellGridMatcher:\n    knn: 1\n    maxDist: 0.5",
    "vardist": "KDTreeVarDistMatcher:\n    knn: 1",
}
SCAN_ROWS = (700, 600, 800, 650)


@pytest.fixture(scope="module")
def scene():
    """A 2000-point map of a room, four scans displaced from it by known
    poses (map ≈ T · scan), each with a ``maxSearchDist`` radius per point
    (0.3-0.6 m), and an initial pose per scan near its truth."""
    rng = np.random.default_rng(1)
    world = _room(rng, 6000)
    ref = world[rng.choice(len(world), 2000, replace=False)].astype(np.float32)
    scans, poses, inits = [], [], []
    for i, n in enumerate(SCAN_ROWS):
        rows = world[rng.choice(len(world), n, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = _yaw_pose(0.03 * (i - 1), [0.05, -0.03 + 0.02 * i, 0.02])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
        inits.append((_yaw_pose(0.02 * (i % 2), [0.02, 0.0, 0.0]) @ T)
                     .astype(np.float32))
    radii = [rng.uniform(0.3, 0.6, n).astype(np.float32) for n in SCAN_ROWS]
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return ref, scans, radii, poses, inits, extent


def _cull(monkeypatch):
    monkeypatch.setattr(jax_matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", CULL)
    monkeypatch.setattr(matchers.KDTreeVarDistMatcher, "CULL_MIN_MAP", CULL)


def _readings(scans, radii):
    d = [{"maxSearchDist": r} for r in radii]
    return ([pm.PointCloud.from_numpy(s, x) for s, x in zip(scans, d)],
            [pt.PointCloud.from_numpy(s, x, device=CPU) for s, x in zip(scans, d)])


def _assert_poses(Tt, Tj, extent, truth=None):
    Tt, Tj = np.asarray(Tt), np.asarray(Tj)
    np.testing.assert_allclose(Tt[..., :3, :3], Tj[..., :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[..., :3, 3], Tj[..., :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt.reshape(-1, 4, 4), truth or []):
        np.testing.assert_allclose(T, gT, atol=0.1)


def _assert_info(it, ij):
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)


@pytest.mark.parametrize("name", list(MATCHERS))
def test_one_shot_icp(scene, monkeypatch, name):
    """Two scans, one onto the other (VarDist's reference, ~350 rows after
    SamplingSurfaceNormal, is held at 384 rows, above ``CULL``: the culled
    route); then the same port ICP with a
    step filter that takes the stepped driver, as JAX's does, which drops
    VarDist's grid."""
    _cull(monkeypatch)
    ref, scans, radii, poses, inits, extent = scene
    text = CHAIN.format(matcher=MATCHERS[name])
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    ij.load_from_yaml(text)
    it.load_from_yaml(text)
    (fj, rj), (ft, rt) = _readings(scans[:2], radii[:2])
    T_init = np.linalg.inv(inits[0]) @ inits[1]
    gT = np.linalg.inv(poses[0]) @ poses[1]
    Tj = ij(rj, fj, T_init, seed=SEED)
    Tt = it(rt, ft, T_init, seed=SEED)
    assert (it.last_iteration_count, it.max_num_iterations_reached) == \
        (ij.last_iteration_count, ij.max_num_iterations_reached)
    _assert_poses(Tt.numpy(), Tj, extent, [gT])
    if name == "vardist":
        assert it.matcher._vd_grid is not None and ij.matcher._vd_grid is not None
    step = [("RandomSamplingDataPointsFilter", {"prob": "0.9"})]
    for eng, reg in ((ij, pm.DataPointsFilterRegistrar),
                     (it, pt.DataPointsFilterRegistrar)):
        eng.reading_step_filters = [reg.create(n, p) for n, p in step]
    Tj = ij(rj, fj, T_init, seed=SEED)
    Tt = it(rt, ft, T_init, seed=SEED)
    assert it.last_iteration_count == ij.last_iteration_count
    _assert_poses(Tt.numpy(), Tj, extent, [gT])
    if name == "vardist":
        assert it.matcher._vd_grid is None and ij.matcher._vd_grid is None


@pytest.mark.parametrize("name", list(MATCHERS))
def test_sequence_batch_and_queue(scene, monkeypatch, name):
    """On the map (~1000 rows after SamplingSurfaceNormal, 1024 JAX rows):
    ``compute`` of two scans, then a batch of four and a queue of four
    through two lanes, each against JAX's in the same order (VarDist's
    batch searches with the grid the sequence left, in both). CellGrid's
    queue serves in the queue's dense mode, VarDist's as a batch on the host
    path, in both packages."""
    _cull(monkeypatch)
    ref, scans, radii, poses, inits, extent = scene
    text = CHAIN.format(matcher=MATCHERS[name])
    js, ps = pm.ICPSequence(), pt.ICPSequence(device=CPU)
    js.load_from_yaml(text)
    ps.load_from_yaml(text)
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    rj, rt = _readings(scans, radii)
    for i in (1, 2):
        Tj = js.compute(rj[i], T_init=inits[i], seed=i)
        Tt = ps.compute(rt[i], T_init=inits[i], seed=i)
        assert ps.last_iteration_count == js.last_iteration_count
        _assert_poses(Tt.numpy(), Tj, extent, [poses[i]])
    if name == "vardist":
        assert ps.matcher._vd_grid is not None
        assert ps.matcher._vd_rmax == js.matcher._vd_rmax
    assert _host_path(ps) == (name == "vardist")
    assert queue_eligible(ps) == jax_queue_eligible(js) == (name == "cellgrid")
    Tj, ij_ = jax_batch(js, rj, T_inits=inits, seed=SEED)
    Tt, it_ = register_batch_to_map(ps, rt, T_inits=inits, seed=SEED)
    _assert_info(it_, ij_)
    _assert_poses(Tt, Tj, extent, poses)
    Tqj, iqj = jax_queue(js, rj, T_inits=inits, seed=SEED, lanes=2)
    Tqt, iqt = register_queue_to_map(ps, rt, T_inits=inits, seed=SEED, lanes=2)
    _assert_info(iqt, iqj)
    _assert_poses(Tqt, Tqj, extent, poses)
    _assert_info(iqt, it_)
    np.testing.assert_allclose(Tqt, Tt, atol=1e-5)
