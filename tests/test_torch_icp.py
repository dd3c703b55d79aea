"""The slice end to end: one-shot ``ICP`` and ``ICPSequence`` of the port
against the JAX engines on the CPU, default chain, with the JAX draws fed to
the port's filters.

Held equal: iteration count and stop code. Held within tolerance: the final
transform, 1e-4 on rotation entries and 1e-4 × the scene extent on the
translation (the two frameworks sum the normal equations in another order).
"""

import jax
import numpy as np
import pytest

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.cloud import bucket_size

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.state import install_map

CPU = "cpu"


def _room(rng, n):
    """Floor, two walls, a table top and a block face: a planar scene."""
    k = n // 5
    parts = [np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
             np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
             np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
             np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
             np.c_[np.full(k, 4.5), rng.uniform(1, 3, k), rng.uniform(0, 1.5, k)]]
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def scene():
    """~3k-point reference, ~1.5k-point reading displaced by a known pose."""
    rng = np.random.default_rng(0)
    world = _room(rng, 6000)
    ref = world[rng.choice(len(world), 3000, replace=False)]
    rd = world[rng.choice(len(world), 1500, replace=False)]
    rd = rd + 0.003 * rng.standard_normal(rd.shape)
    ang = 0.05
    dT = np.eye(4)
    dT[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                  [0, 0, 1]]
    dT[:3, 3] = [0.1, -0.05, 0.03]
    read = (rd - dT[:3, 3]) @ dT[:3, :3]          # ref ≈ dT · read
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return read.astype(np.float32), ref.astype(np.float32), dT, extent


def _draw(seed, stream, n):
    """JAX's draw for the first filter of chain ``stream`` (icp.py folds 1
    for the reference chain, 2 for the reading chain; filters/base.py folds
    the filter's position) on a from_numpy cloud, cut to its rows."""
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), stream), 0)
    return np.asarray(jax.random.uniform(key, (bucket_size(n),)))[:n]


def _assert_pose(Tt, Tj, extent):
    Tt = np.asarray(Tt)
    Tj = np.asarray(Tj)
    np.testing.assert_allclose(Tt[:3, :3], Tj[:3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:3, 3], Tj[:3, 3], atol=1e-4 * extent)


# The default chain, and the K5 route (knn = 3) at a fixed budget of 8
# iterations: near convergence the Differential checker compares acos of a
# float32 trace, which moves in ~5e-4 rad steps, against 1e-3, so poses that
# differ in the last ulp (the engines sum the normal equations in another
# order) may stop one iteration apart on some inputs. The fixed budget holds
# the route's arithmetic to the JAX engine without that threshold.
@pytest.mark.parametrize("matcher,budget", [({}, None), ({"knn": "3"}, "8")])
def test_one_shot_icp_matches_jax(scene, matcher, budget):
    read, ref, dT, extent = scene
    seed = 3
    icp = pm.ICP()
    icp.set_default()
    icp.matcher = pm.matchers.KDTreeMatcher(matcher)
    ti = pt.ICP(device=CPU)
    ti.set_default()
    ti.matcher = KDTreeMatcher(matcher)
    if budget is not None:
        icp.checkers = [pm.checkers.CounterTransformationChecker(
            {"maxIterationCount": budget})]
        ti.checkers = [CounterTransformationChecker({"maxIterationCount": budget})]
    Tj = icp(pm.PointCloud.from_numpy(read), pm.PointCloud.from_numpy(ref), seed=seed)

    ti.reference_filters[0].uniform = _draw(seed, 1, len(ref))
    ti.reading_filters[0].uniform = _draw(seed, 2, len(read))
    Tt = ti(pt.PointCloud.from_numpy(read, device=CPU),
            pt.PointCloud.from_numpy(ref, device=CPU), seed=seed)

    assert ti.last_iteration_count == icp.last_iteration_count
    assert ti.max_num_iterations_reached == icp.max_num_iterations_reached
    assert ti.last_code in (0, 1)
    assert ti.prefiltered_reference_pts_count == icp.prefiltered_reference_pts_count
    assert ti.prefiltered_reading_pts_count == icp.prefiltered_reading_pts_count
    _assert_pose(Tt.numpy(), Tj, extent)
    np.testing.assert_allclose(np.asarray(Tt), dT, atol=0.02)
    np.testing.assert_allclose(ti.get_weighted_point_used_ratio(),
                               icp.get_weighted_point_used_ratio(), rtol=1e-5)


def test_icp_sequence_matches_jax(scene):
    """set_map, then two compute calls; the same again on a map installed
    from the JAX engine's arrays through state.install_map."""
    read, ref, dT, extent = scene
    map_seed = 5
    seq = pm.ICPSequence()
    seq.set_default()
    seq.set_map(pm.PointCloud.from_numpy(ref), seed=map_seed)

    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.reference_filters[0].uniform = _draw(map_seed, 1, len(ref))
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=map_seed)
    jm, jd, _ = seq.get_prefiltered_internal_map().to_numpy()
    tm, td = ps.get_prefiltered_internal_map().to_numpy()
    assert tm.shape == jm.shape
    np.testing.assert_allclose(tm, jm, atol=1e-6 * extent)
    np.testing.assert_allclose(ps.trm_host(), seq.trm_host(), atol=1e-6 * extent)
    np.testing.assert_allclose(
        ps.get_prefiltered_map().to_numpy()[0],
        seq.get_prefiltered_map().to_numpy()[0], atol=1e-6 * extent)

    installed = pt.ICPSequence(device=CPU)
    installed.set_default()
    install_map(installed, jm, jd["normals"], seq.trm_host())

    for seed, T_init in ((11, None), (12, dT)):
        rows = read if T_init is None else read[::2]
        kw = {} if T_init is None else {"T_init": T_init}
        Tj = seq.compute(pm.PointCloud.from_numpy(rows), seed=seed, **kw)
        for engine in (ps, installed):
            engine.reading_filters[0].uniform = _draw(seed, 2, len(rows))
            Tt = engine.compute(pt.PointCloud.from_numpy(rows, device=CPU),
                                seed=seed, **kw)
            assert engine.last_iteration_count == seq.last_iteration_count
            assert engine.max_num_iterations_reached == seq.max_num_iterations_reached
            _assert_pose(Tt.numpy(), Tj, extent)


def test_emptying_filter_raises_convergence_error(scene):
    read, ref, _, _ = scene
    icp = pm.ICP()
    icp.set_default()
    icp.reading_filters = [pm.filters.basic.RandomSamplingDataPointsFilter(
        {"prob": "0"})]
    with pytest.raises(pm.errors.ConvergenceError):
        icp(pm.PointCloud.from_numpy(read), pm.PointCloud.from_numpy(ref))
    ti = pt.ICP(device=CPU)
    ti.set_default()
    ti.load_from_yaml({
        "readingDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0}}],
        "referenceDataPointsFilters": ["SamplingSurfaceNormalDataPointsFilter"],
        "matcher": "KDTreeMatcher",
        "outlierFilters": ["TrimmedDistOutlierFilter"],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "transformationCheckers": ["CounterTransformationChecker"],
    })
    with pytest.raises(pt.ConvergenceError):
        ti(pt.PointCloud.from_numpy(read, device=CPU),
           pt.PointCloud.from_numpy(ref, device=CPU))


def test_sequence_without_map_returns_initial_pose():
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    T = ps.compute(pt.PointCloud.from_numpy(np.zeros((5, 3)), device=CPU))
    np.testing.assert_array_equal(T.numpy(), np.eye(4))
    with pytest.raises(RuntimeError):
        ps.compute(pt.PointCloud.from_numpy(np.zeros((5, 3)), device=CPU),
                   reference=object())
