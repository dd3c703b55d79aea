"""The large-map tile-sweep serving configuration of the port against the
JAX package's on the CPU: ``SurfaceNormal`` (dense K5 search and the culled
K8 path) and ``BlockGridMatcher`` through one-shot ``ICP``,
``register_batch_to_map`` and ``register_queue_to_map``.

The scene is ``tools/large_reg_bench.py``'s terrain (120 points/m², 0.02 m
of noise, priors up to 2° and 0.3 m off) cut to a 6 000-point map and six
scans in 2.5 m balls (~2 330 points each), with the bench's chain:
``RandomSampling(0.75)`` readings, ``SurfaceNormal(knn=10)`` map,
``BlockGridMatcher(maxDist=0.5, motionBound=1.0, tileQueries=64,
blockCap=1024)``, ``TrimmedDist(0.85)``, ``PointToPlane``, ``Counter(40)``
and ``Differential``. One scan's assignment has 48 virtual tiles of 16
gather units and a merge depth of 3, so the virtual-tile split and the merge
both run. The JAX draws are fed to the port's filters.

Held equal per scan: iteration count, stop code and the motion-bound flag.
Held within tolerance: the pose, 1e-4 on rotation entries and 1e-4 × the
scene extent on translation (the two frameworks sum the normal equations in
another order). Normals are held up to their sign, |n·n′| ≥ 1 − 1e-5
(``eigh`` of the two frameworks may flip an eigenvector).
"""

import importlib

import numpy as np
import pytest
from test_torch_batch import _scan_draws
from test_torch_icp import _draw

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_serve
from libpointmatcher_tpu.parallel import register_queue_to_map as jax_queue

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.config import configure_chain_from_yaml
from libpointmatcher_tpu_torch.ops import knn_self
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)

CPU = "cpu"
SEED = 3
LANES = 4
DENSITY = 120.0
RADIUS = 2.5
BENCH = {"maxDist": "0.5", "motionBound": "1.0", "tileQueries": "64",
         "blockCap": "1024"}


def _terrain(n, rng):
    side = float(np.sqrt(n / DENSITY))
    xy = rng.uniform(0, side, (n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(xy[:, 1] * 0.7) \
        + 0.05 * rng.standard_normal(n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32), side


def _prior_error(rng, center, max_deg=2.0, max_trans=0.3):
    ang = np.deg2rad(rng.uniform(-max_deg, max_deg, 3))
    ca, sa = np.cos(ang), np.sin(ang)
    Rx = np.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
    Ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
    Rz = np.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    c = np.array([center[0], center[1], 0.0])
    T[:3, 3] = c - T[:3, :3] @ c + rng.uniform(-max_trans, max_trans, 3)
    return T


@pytest.fixture(scope="module")
def scene():
    """(map, scans, ground-truth poses, extent): each scan a ball of the
    map plus noise, moved off the map frame by the inverse of its pose."""
    rng = np.random.default_rng(7)
    pts, side = _terrain(6000, rng)
    scans, gts = [], []
    for _ in range(6):
        c = rng.uniform(RADIUS, side - RADIUS, 2)
        sel = np.linalg.norm(pts[:, :2] - c[None, :], axis=1) < RADIUS
        ball = pts[sel] + 0.02 * rng.standard_normal((int(sel.sum()), 3)
                                                     ).astype(np.float32)
        T = _prior_error(rng, c)
        Ti = np.linalg.inv(T)
        scans.append(ball @ Ti[:3, :3].T.astype(np.float32)
                     + Ti[:3, 3].astype(np.float32))
        gts.append(T)
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    return pts, scans, gts, extent


def _chain(engine, pkg, matcher):
    """The bench's chain on an engine of package ``pkg``."""
    mod = lambda m: importlib.import_module(f"{pkg}.{m}")
    checkers = mod("checkers")
    engine.set_default()
    engine.reading_filters = [
        mod("filters.basic").RandomSamplingDataPointsFilter({"prob": "0.75"})]
    engine.reference_filters = [
        mod("filters.normals").SurfaceNormalDataPointsFilter({"knn": "10"})]
    engine.matcher = mod("matchers").MatcherRegistrar.create(
        "BlockGridMatcher", dict(matcher))
    engine.outlier_filters = [
        mod("outlierfilters").TrimmedDistOutlierFilter({"ratio": "0.85"})]
    engine.error_minimizer = mod("minimizers").PointToPlaneErrorMinimizer()
    engine.checkers = [
        checkers.CounterTransformationChecker({"maxIterationCount": "40"}),
        checkers.DifferentialTransformationChecker()]
    return engine


def _sequences(scene, matcher, n_scans):
    pts, scans, _, _ = scene
    js = _chain(pm.ICPSequence(), "libpointmatcher_tpu", matcher)
    js.set_map(pm.PointCloud.from_numpy(pts), seed=0)
    ps = _chain(pt.ICPSequence(device=CPU), "libpointmatcher_tpu_torch", matcher)
    ps.set_map(pt.PointCloud.from_numpy(pts, device=CPU), seed=0)
    ps.reading_filters[0].uniform = _scan_draws(
        SEED, [len(s) for s in scans[:n_scans]])
    return js, ps


def _clouds(scans, mod, **kw):
    return [mod.PointCloud.from_numpy(s, **kw) for s in scans]


@pytest.fixture(scope="module")
def served(scene):
    """Batch and queue of the six scans through both packages."""
    _, scans, _, _ = scene
    js, ps = _sequences(scene, BENCH, len(scans))
    jc, pc = _clouds(scans, pm), _clouds(scans, pt, device=CPU)
    return {"seq": ps,
            "batch": (jax_serve(js, jc, seed=SEED),
                      register_batch_to_map(ps, pc, seed=SEED)),
            "queue": (jax_queue(js, jc, seed=SEED, lanes=LANES),
                      register_queue_to_map(ps, pc, seed=SEED, lanes=LANES))}


def _assert_same(jax_out, port_out, scene, gate=0.05):
    (Tj, ij), (Tt, it) = jax_out, port_out
    _, _, gts, extent = scene
    for key in ("iterations", "codes", "motion_bound_exceeded"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)
    for T, G in zip(Tt, gts):
        assert np.linalg.norm(T[:3, 3] - G[:3, 3]) < gate


@pytest.mark.parametrize("driver", ["batch", "queue"])
def test_serving_matches_jax(scene, served, driver):
    jax_out, port_out = served[driver]
    _assert_same(jax_out, port_out, scene)
    assert not port_out[1]["motion_bound_exceeded"].any()
    assert not port_out[1]["compact_overflow"].any()


def test_queue_equals_batch(served):
    (Tb, ib), (Tq, iq) = served["batch"][1], served["queue"][1]
    for key in ("iterations", "codes", "motion_bound_exceeded"):
        np.testing.assert_array_equal(iq[key], ib[key])
    np.testing.assert_allclose(Tq, Tb, atol=1e-6)


def test_tile_route_is_taken(served):
    """The assignment splits tiles (merge depth > 1), and with a chain that
    compacts (not TRACEABLE) the route is refused."""
    from libpointmatcher_tpu_torch.parallel.batch import _tile_route
    from libpointmatcher_tpu_torch.parallel.stream import _queue_mode

    ps = served["seq"]
    assert _tile_route(ps) and _queue_mode(ps) == "tile"
    internal = ps.get_prefiltered_internal_map()
    pts, mask = internal.host_rows()
    per = ps.matcher.prepare_loop_host(pts[:2400], mask[:2400])
    assert per["vrows"].shape[0] > 1 and per["blocks"].shape[1] % 2 == 0
    from libpointmatcher_tpu_torch.filters.normals import (
        SamplingSurfaceNormalDataPointsFilter)
    saved = ps.reading_filters
    ps.reading_filters = [SamplingSurfaceNormalDataPointsFilter()]
    try:
        assert not _tile_route(ps) and _queue_mode(ps) == ""
    finally:
        ps.reading_filters = saved
    uniform, ps.reading_filters[0].uniform = ps.reading_filters[0].uniform, None
    try:
        assert ps.warmup(300, batch=2, lanes=2, queue_len=3) > 0
    finally:
        ps.reading_filters[0].uniform = uniform


@pytest.mark.parametrize("knn", [1, 3])
def test_one_shot_icp_matches_jax(scene, knn):
    """One-shot ``ICP``: the tiling is made from the filtered, pre-moved
    reading (``prepare_loop``), one K7 (knn = 1) or K8 (knn = 3) launch per
    iteration, the queries gathered and the results scattered by row."""
    pts, scans, gts, extent = scene
    matcher = dict(BENCH, knn=str(knn))
    icp_j = _chain(pm.ICP(), "libpointmatcher_tpu", matcher)
    icp_p = _chain(pt.ICP(device=CPU), "libpointmatcher_tpu_torch", matcher)
    icp_p.reading_filters[0].uniform = _draw(SEED, 2, len(scans[1]))
    Tj = np.asarray(icp_j(pm.PointCloud.from_numpy(scans[1]),
                          pm.PointCloud.from_numpy(pts), seed=SEED))
    Tt = icp_p(pt.PointCloud.from_numpy(scans[1], device=CPU),
               pt.PointCloud.from_numpy(pts, device=CPU), seed=SEED).numpy()
    assert icp_p.last_iteration_count == icp_j.last_iteration_count
    assert (icp_p.max_num_iterations_reached
            == icp_j.max_num_iterations_reached)
    assert icp_p.last_code in (0, 1)
    assert icp_p.motion_bound_exceeded is icp_j.motion_bound_exceeded is False
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-4 * extent)
    assert np.linalg.norm(Tt[:3, 3] - gts[1][:3, 3]) < 0.05


def test_motion_bound_flag_matches_jax(scene):
    """A motionBound far below the priors' error (0.05 m against up to
    0.3 m and 2°) raises the flag on the same scans in both packages."""
    _, scans, _, _ = scene
    js, ps = _sequences(scene, dict(BENCH, motionBound="0.05"), 3)
    Tj, ij = jax_serve(js, _clouds(scans[:3], pm), seed=SEED)
    Tt, it = register_batch_to_map(ps, _clouds(scans[:3], pt, device=CPU),
                                   seed=SEED)
    assert it["motion_bound_exceeded"].any()
    np.testing.assert_array_equal(it["motion_bound_exceeded"],
                                  ij["motion_bound_exceeded"])
    np.testing.assert_array_equal(it["iterations"], ij["iterations"])


@pytest.mark.parametrize("culled", [False, True])
def test_surface_normal_matches_jax(scene, monkeypatch, culled):
    """Both search paths: the dense one, and the culled one forced with
    ``CULL_MIN_POINTS`` = 0 (the tile sweep K8 and its dense fallback)."""
    from libpointmatcher_tpu.filters.base import DataPointsFilterRegistrar as JR
    from libpointmatcher_tpu_torch.filters.base import (
        DataPointsFilterRegistrar as PR)

    if culled:
        monkeypatch.setattr("libpointmatcher_tpu.ops.knn_self.CULL_MIN_POINTS", 0)
        monkeypatch.setattr(knn_self, "CULL_MIN_POINTS", 0)
    pts = scene[0][:3000]
    params = {"knn": "8", "keepDensities": "1", "keepEigenValues": "1",
              "keepMatchedIds": "1", "keepMeanDist": "1"}
    import jax.random as jr

    oj = JR.create("SurfaceNormalDataPointsFilter", params).filter(
        pm.PointCloud.from_numpy(pts), key=jr.PRNGKey(0))
    op = PR.create("SurfaceNormalDataPointsFilter", params).filter(
        pt.PointCloud.from_numpy(pts, device=CPU))
    n = len(pts)
    get_j = lambda k: np.asarray(oj.get_descriptor(k))[:n]
    get_p = lambda k: op.descriptors[k].numpy()
    a, b = get_j("normals"), get_p("normals")
    assert np.all(np.abs(np.sum(a * b, axis=1)) >= 1 - 1e-5)
    np.testing.assert_array_equal(get_p("matchedIds"), get_j("matchedIds"))
    np.testing.assert_allclose(get_p("densities"), get_j("densities"), rtol=1e-4)
    np.testing.assert_allclose(get_p("eigValues"), get_j("eigValues"),
                               rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(get_p("meanDists"), get_j("meanDists"),
                               rtol=1e-4, atol=1e-6)


def test_yaml_chain_loads_the_tile_modules():
    seq = pt.ICPSequence(device=CPU)
    configure_chain_from_yaml(seq, """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.75
referenceDataPointsFilters:
  - SurfaceNormalDataPointsFilter:
      knn: 10
matcher:
  BlockGridMatcher:
    maxDist: 0.5
    motionBound: 1.0
    tileQueries: 64
errorMinimizer: PointToPlaneErrorMinimizer
""")
    assert type(seq.reference_filters[0]).__name__ == "SurfaceNormalDataPointsFilter"
    assert seq.matcher.cell_size == 1.5 and seq.matcher.tileQueries == 64
