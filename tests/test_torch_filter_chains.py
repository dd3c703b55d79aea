"""YAML chains with the new data filters, end to end, against the JAX
package's engines on the CPU (the ~2000-point room and the four scans of
``tests/test_torch_loop_chains.py``):

- the map maintenance of the reference's ``align_sequence``
  (align_sequence.cpp:140-144): SurfaceNormal(knn 10, epsilon 5,
  densities) + MaxDensity, then MaxPointCount, as the map's chain of an
  ``ICPSequence``;
- a sensor's reading chain, BoundingBox(removeInside) + MaxDist + MinDist
  + RandomSampling, through ``register_batch_to_map`` and
  ``register_queue_to_map`` (the queue takes it in both packages, and
  gives the batch's result), and a MaxPointCount reading chain, which
  neither queue takes;
- an Elipsoids map, and a VoxelGrid + SurfaceNormal map chain through
  one-shot ``ICP``;
- time channels through the chains and the drivers.

Held equal: the map's rows, the iteration counts and stop codes; the
poses within 1e-4 (rotation entries) and 1e-4 × the scene's extent
(translation), as in the loop-chain tests."""

import numpy as np
import pytest
from test_torch_loop_chains import SEED, MAP_SEED, _assert_info, _assert_poses, make_scene

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.filters.base import apply_filter_chain as jax_chain
from libpointmatcher_tpu.parallel import register_batch as jax_pairs
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_batch
from libpointmatcher_tpu.parallel import register_queue_to_map as jax_queue
from libpointmatcher_tpu.parallel.stream import queue_eligible as jax_eligible

import jax

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.filters import apply_filter_chain
from libpointmatcher_tpu_torch.filters.base import DataPointsFilterRegistrar as TReg
from libpointmatcher_tpu_torch.parallel import (register_batch,
                                                register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.parallel.stream import queue_eligible
from libpointmatcher_tpu_torch.utils import prng

CPU = "cpu"

LOOP = """
matcher:
  KDTreeMatcher
outlierFilters:
  - TrimmedDistOutlierFilter:
      ratio: 0.85
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker:
      maxIterationCount: 30
  - DifferentialTransformationChecker
"""

#: the maintenance chain; MaxDensity's threshold sits inside the small
#: room's densities (it thins about half), MaxPointCount then acts
MAINTENANCE = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.8
referenceDataPointsFilters:
  - SurfaceNormalDataPointsFilter:
      knn: 10
      epsilon: 5
      keepDensities: 1
  - MaxDensityDataPointsFilter:
      maxDensity: 2000
  - MaxPointCountDataPointsFilter:
      maxCount: 900
      seed: 0
""" + LOOP

#: a sensor's reading chain, cut to the small room
SENSOR = """
readingDataPointsFilters:
  - BoundingBoxDataPointsFilter:
      xMin: -0.5
      xMax: 0.5
      yMin: -0.5
      yMax: 0.5
      zMin: -0.5
      zMax: 0.5
      removeInside: 1
  - MaxDistDataPointsFilter:
      dim: -1
      maxDist: 5.5
  - MinDistDataPointsFilter:
      dim: -1
      minDist: 0.3
  - RandomSamplingDataPointsFilter:
      prob: 0.5
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
""" + LOOP

MAX_COUNT = SENSOR.replace("""  - MinDistDataPointsFilter:
      dim: -1
      minDist: 0.3""", """  - MaxPointCountDataPointsFilter:
      maxCount: 500""")

ELIPSOIDS = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.8
referenceDataPointsFilters:
  - ElipsoidsDataPointsFilter:
      samplingMethod: 1
      knn: 5
""" + LOOP

VOXEL = """
readingDataPointsFilters:
  - MinDistDataPointsFilter:
      minDist: 0.2
referenceDataPointsFilters:
  - VoxelGridDataPointsFilter:
      vSizeX: 0.08
      vSizeY: 0.08
      vSizeZ: 0.08
  - SurfaceNormalDataPointsFilter:
      knn: 8
""" + LOOP


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _sequences(ref, text):
    js = pm.ICPSequence()
    js.load_from_yaml(text)
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps = pt.ICPSequence(device=CPU)
    ps.load_from_yaml(text)
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    return js, ps


def _same_map(js, ps):
    mj = js.get_prefiltered_internal_map().to_numpy()[0]
    mt = ps.get_prefiltered_internal_map().to_numpy()[0]
    assert mt.shape == mj.shape
    np.testing.assert_allclose(mt, mj, atol=1e-5)
    return len(mt)


def test_maintenance_chain_sequence(scene):
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, MAINTENANCE)
    assert _same_map(js, ps) == 900
    # MaxDensity acted before MaxPointCount
    f = [TReg.create(n, p) for n, p in (
        ("SurfaceNormalDataPointsFilter", {"knn": "10", "epsilon": "5",
                                           "keepDensities": "1"}),
        ("MaxDensityDataPointsFilter", {"maxDensity": "2000"}))]
    thinned = apply_filter_chain(f, pt.PointCloud.from_numpy(ref, device=CPU),
                                 prng.prng_key(0))
    assert 900 < thinned.count_host() < len(ref)
    for i in (1, 2, 3):
        Tj = js(pm.PointCloud.from_numpy(scans[i]), T_init=inits[i], seed=i)
        Tt = ps(pt.PointCloud.from_numpy(scans[i], device=CPU), T_init=inits[i],
                seed=i)
        assert (ps.last_iteration_count, ps.max_num_iterations_reached) == \
            (js.last_iteration_count, js.max_num_iterations_reached)
        _assert_poses(Tt.numpy(), Tj, [poses[i]], extent)


def _clouds(scans, times=False):
    out = []
    for i, s in enumerate(scans):
        t = {"stamps": np.arange(len(s), dtype=np.int64) + (i << 40)} if times else None
        out.append(pt.PointCloud.from_numpy(s, device=CPU, times=t))
    return out


@pytest.mark.parametrize("text,queued", [(SENSOR, True), (MAX_COUNT, False)])
def test_sensor_chain_batch_and_queue(scene, text, queued):
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, text)
    assert queue_eligible(ps) == jax_eligible(js) == queued
    jc = [pm.PointCloud.from_numpy(s) for s in scans]
    Tj, ij = jax_batch(js, jc, T_inits=inits, seed=SEED)
    Tb, ib = register_batch_to_map(ps, _clouds(scans), T_inits=inits, seed=SEED)
    _assert_info(ib, ij)
    _assert_poses(Tb, Tj, poses, extent)
    Tqj, iqj = jax_queue(js, jc, T_inits=inits, seed=SEED, lanes=2)
    Tq, iq = register_queue_to_map(ps, _clouds(scans, times=True), T_inits=inits,
                                   seed=SEED, lanes=2)
    _assert_info(iq, iqj)
    _assert_poses(Tq, Tqj, poses, extent)
    # the queue gives the batch's result, time channels or not
    _assert_info(iq, ib)
    np.testing.assert_allclose(Tq, Tb, atol=1e-5)


def test_elipsoids_map_sequence(scene):
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, ELIPSOIDS)
    assert _same_map(js, ps) < len(ref)
    for i in (0, 2):
        Tj = js(pm.PointCloud.from_numpy(scans[i]), T_init=inits[i], seed=i)
        Tt = ps(pt.PointCloud.from_numpy(scans[i], device=CPU), T_init=inits[i],
                seed=i)
        assert (ps.last_iteration_count, ps.max_num_iterations_reached) == \
            (js.last_iteration_count, js.max_num_iterations_reached)
        _assert_poses(Tt.numpy(), Tj, [poses[i]], extent)


def test_voxel_chain_one_shot(scene):
    ref, scans, poses, inits, extent = scene
    ij = pm.ICP()
    ij.load_from_yaml(VOXEL)
    it = pt.ICP(device=CPU)
    it.load_from_yaml(VOXEL)
    Tj = ij(pm.PointCloud.from_numpy(scans[1]), pm.PointCloud.from_numpy(ref),
            inits[1], seed=SEED)
    Tt = it(pt.PointCloud.from_numpy(scans[1], device=CPU),
            pt.PointCloud.from_numpy(ref, device=CPU), inits[1], seed=SEED)
    assert it.last_iteration_count == ij.last_iteration_count
    _assert_poses(Tt.numpy(), Tj, [poses[1]], extent)


def test_times_through_a_chain(scene):
    ref = scene[0]
    rng = np.random.default_rng(2)
    times = {"stamps": rng.integers(0, 2**62, len(ref)).astype(np.int64),
             "pair": rng.integers(-2**40, 2**40, (len(ref), 2)).astype(np.int64)}
    spec = [("MaxDistDataPointsFilter", {"maxDist": "5"}),
            ("RandomSamplingDataPointsFilter", {"prob": "0.7"}),
            ("SurfaceNormalDataPointsFilter", {"knn": "6"}),
            ("OctreeGridDataPointsFilter", {"maxPointByNode": "4",
                                            "samplingMethod": "3"}),
            ("ElipsoidsDataPointsFilter", {"knn": "4"})]
    cj = jax_chain([pm.DataPointsFilterRegistrar.create(n, p) for n, p in spec],
                   pm.PointCloud.from_numpy(ref, None, times),
                   jax.random.PRNGKey(11))
    ct = apply_filter_chain([TReg.create(n, p) for n, p in spec],
                            pt.PointCloud.from_numpy(ref, device=CPU, times=times),
                            prng.prng_key(11))
    pj, _, tj = cj.to_numpy()
    pt_, _, tt = ct.to_numpy(with_times=True)
    np.testing.assert_allclose(pt_, pj, atol=1e-6)
    assert list(tt) == list(tj) == ["stamps"]
    np.testing.assert_array_equal(tt["stamps"], tj["stamps"])
    assert tt["stamps"].shape[1] == 3


#: the point-to-point stop of ``tests/test_torch_loop_chains.py``
P2P_STOP = """  - DifferentialTransformationChecker:
      minDiffRotErr: 0.003
      minDiffTransErr: 0.003"""

#: two draws in a row: where the JAX package runs the chain in one program
#: the second draws over the rows the chain was given, not the survivors
TWO_DRAWS = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.9
  - RandomSamplingDataPointsFilter:
      prob: 0.6
referenceDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.9
  - RandomSamplingDataPointsFilter:
      prob: 0.8
""" + LOOP.replace("PointToPlane", "PointToPoint").replace(
    "  - DifferentialTransformationChecker", P2P_STOP)


@pytest.mark.parametrize("driver", ["one_shot", "sequence", "batch", "pairs"])
def test_traced_chain_draws_over_given_rows(scene, driver):
    ref, scans, poses, inits, extent = scene
    if driver == "pairs":
        ij = pm.ICP()
        ij.load_from_yaml(TWO_DRAWS)
        it = pt.ICP(device=CPU)
        it.load_from_yaml(TWO_DRAWS)
        Tj, infj = jax_pairs(
            ij, [pm.PointCloud.from_numpy(s) for s in scans[1:]],
            [pm.PointCloud.from_numpy(ref)] * 3, T_inits=inits[1:], seed=SEED)
        Tt, inft = register_batch(
            it, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans[1:]],
            [pt.PointCloud.from_numpy(ref, device=CPU)] * 3, T_inits=inits[1:],
            seed=SEED)
        _assert_info(inft, infj)
        _assert_poses(Tt, Tj, poses[1:], extent)
        return
    if driver == "one_shot":
        ij = pm.ICP()
        ij.load_from_yaml(TWO_DRAWS)
        it = pt.ICP(device=CPU)
        it.load_from_yaml(TWO_DRAWS)
        Tj = ij(pm.PointCloud.from_numpy(scans[2]), pm.PointCloud.from_numpy(ref),
                inits[2], seed=SEED)
        Tt = it(pt.PointCloud.from_numpy(scans[2], device=CPU),
                pt.PointCloud.from_numpy(ref, device=CPU), inits[2], seed=SEED)
        assert it.last_iteration_count == ij.last_iteration_count
        _assert_poses(Tt.numpy(), Tj, [poses[2]], extent)
        return
    js, ps = _sequences(ref, TWO_DRAWS)
    if driver == "sequence":
        Tj = js(pm.PointCloud.from_numpy(scans[2]), T_init=inits[2], seed=SEED)
        Tt = ps(pt.PointCloud.from_numpy(scans[2], device=CPU), T_init=inits[2],
                seed=SEED)
        assert ps.prefiltered_reading_pts_count == js.prefiltered_reading_pts_count
        _assert_poses(Tt.numpy(), Tj, [poses[2]], extent)
        return
    Tj, ij = jax_batch(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=inits, seed=SEED)
    Tt, it = register_batch_to_map(ps, _clouds(scans), T_inits=inits, seed=SEED)
    _assert_info(it, ij)
    _assert_poses(Tt, Tj, poses, extent)
