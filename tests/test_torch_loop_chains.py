"""YAML chains with the new loop modules, end to end: the port's one-shot
``ICP``, ``register_batch_to_map`` and (the Robust chain, whose filter
carries loop state) ``register_queue_to_map`` against the JAX package's on
the CPU, on a ~2000-point synthetic room and scans of 700-900 points.
Both packages draw the same rows from the same seeds.

Held equal per scan: iteration count and stop code. Held within
tolerance: the pose, 1e-4 on rotation entries and 1e-4 × the scene extent
on translation (the module-parity rule; the two frameworks sum in another
order), and the WithCov chain's covariance within 1e-3 of its largest
entry (a pseudo-inverse of the last iteration's 6x6 Hessian, from poses
equal to about 1e-6).

The Differential checker compares a float32 acos, which moves in steps of
about 6e-5 rad near 1e-3, with its threshold, so poses equal to 1e-6 (the
SVDs of the two frameworks differ in the last bits) can stop an iteration
apart where a scan's step lies within one such step of it; a scan that
misses the stop there may then run to the iteration budget. Measured on
the CPU: at the default 1e-3 thresholds one or two of the four scans did
so on both point-to-point chains, with poses equal to 3e-6 at every fixed
budget. Their thresholds here (3e-3, where those chains' steps lie clear
of every stop) hold iteration counts exactly; the point-to-plane chains
keep the defaults."""

import numpy as np
import pytest
from test_torch_batch import _room, _yaw_pose

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_batch
from libpointmatcher_tpu.parallel import register_queue_to_map as jax_queue

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)

CPU = "cpu"
MAP_SEED = 5
SEED = 3
SCAN_ROWS = (800, 700, 900, 750)

HEAD = """
readingDataPointsFilters:
  - RandomSamplingDataPointsFilter:
      prob: 0.8
{extra}
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher:
  KDTreeMatcher
transformationCheckers:
  - CounterTransformationChecker:
      maxIterationCount: 30
  - DifferentialTransformationChecker{diff}
"""

#: the point-to-point chains' stop thresholds (see the module docstring)
P2P_DIFF = """:
      minDiffRotErr: 0.003
      minDiffTransErr: 0.003"""

CHAINS = {
    "p2p_trimmed": ("", """
outlierFilters:
  - TrimmedDistOutlierFilter:
      ratio: 0.8
errorMinimizer: PointToPointErrorMinimizer
"""),
    "p2plane_robust": ("", """
outlierFilters:
  - RobustOutlierFilter:
      robustFct: cauchy
      scaleEstimator: mad
      nbIterationForScale: 2
errorMinimizer: PointToPlaneErrorMinimizer
"""),
    "cov_median_normal": ("""  - SurfaceNormalDataPointsFilter:
      knn: 8
""", """
outlierFilters:
  - MedianDistOutlierFilter:
      factor: 3.0
  - SurfaceNormalOutlierFilter:
      maxAngle: 0.8
errorMinimizer: PointToPlaneWithCovErrorMinimizer
"""),
    "p2p_vartrimmed": ("", """
outlierFilters:
  - VarTrimmedDistOutlierFilter
errorMinimizer: PointToPointErrorMinimizer
"""),
}


def chain_yaml(name):
    extra, tail = CHAINS[name]
    return HEAD.format(extra=extra.rstrip("\n"),
                       diff=P2P_DIFF if "p2p" in name else "") + tail


def make_scene():
    """A ~2000-point map, four scans displaced from it by known poses (map
    ≈ T · scan) and an initial pose per scan near its truth."""
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
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return ref, scans, poses, inits, extent


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _assert_poses(Tt, Tj, poses, extent, truth_tol=0.03):
    Tt, Tj = np.asarray(Tt), np.asarray(Tj)
    np.testing.assert_allclose(Tt[..., :3, :3], Tj[..., :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[..., :3, 3], Tj[..., :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt.reshape(-1, 4, 4), poses):
        np.testing.assert_allclose(T, gT, atol=truth_tol)


def _assert_cov(ct, cj):
    ct, cj = np.asarray(ct), np.asarray(cj)
    assert ct.shape == cj.shape
    assert np.abs(ct - cj).max() <= 1e-3 * np.abs(cj).max()


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_one_shot_icp(scene, chain):
    ref, scans, poses, inits, extent = scene
    text = chain_yaml(chain)
    ij = pm.ICP()
    ij.load_from_yaml(text)
    it = pt.ICP(device=CPU)
    it.load_from_yaml(text)
    gT = np.linalg.inv(poses[0]) @ poses[1]
    T_init = np.linalg.inv(inits[0]) @ inits[1]
    Tj = ij(pm.PointCloud.from_numpy(scans[1]), pm.PointCloud.from_numpy(scans[0]),
            T_init, seed=SEED)
    Tt = it(pt.PointCloud.from_numpy(scans[1], device=CPU),
            pt.PointCloud.from_numpy(scans[0], device=CPU), T_init, seed=SEED)
    assert (it.last_iteration_count, it.max_num_iterations_reached) == \
        (ij.last_iteration_count, ij.max_num_iterations_reached)
    # two sparse scans register less tightly than a scan to the map: the
    # truth gate is the reference's own 0.1 (tests/conftest.py::validate_3d)
    _assert_poses(Tt.numpy(), Tj, [gT], extent, truth_tol=0.1)
    if chain == "cov_median_normal":
        _assert_cov(it.get_covariance(), ij.get_covariance())
        cov = it.get_covariance()
        np.testing.assert_allclose(cov, cov.T, rtol=1e-5, atol=1e-12)
        assert np.linalg.eigvalsh(cov.astype(np.float64)).min() >= \
            -1e-5 * np.abs(cov).max()


def _sequences(ref, text):
    js = pm.ICPSequence()
    js.load_from_yaml(text)
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps = pt.ICPSequence(device=CPU)
    ps.load_from_yaml(text)
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    return js, ps


def _assert_info(it, ij):
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)


@pytest.mark.parametrize("chain", list(CHAINS))
def test_chain_batch_to_map(scene, chain):
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, chain_yaml(chain))
    Tj, ij = jax_batch(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=inits, seed=SEED)
    Tt, it = register_batch_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED)
    _assert_info(it, ij)
    _assert_poses(Tt, Tj, poses, extent)
    if chain == "cov_median_normal":
        cov = ps.get_covariance()
        assert cov.shape == (len(scans), 6, 6) and np.isfinite(cov).all()


@pytest.mark.parametrize("coarse", [None, (4, 8, 1.0)])
def test_robust_chain_queue(scene, coarse):
    """Two lanes for four scans: each lane takes a second scan, whose
    Robust state must restart at (1, 1), as must every lane in each pass of
    the coarse-to-fine queue; the queue gives the JAX queue's iterations,
    codes and poses, and the batch's."""
    ref, scans, poses, inits, extent = scene
    js, ps = _sequences(ref, chain_yaml("p2plane_robust"))
    Tj, ij = jax_queue(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=inits, seed=SEED, lanes=2, coarse=coarse)
    Tt, it = register_queue_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED, lanes=2, coarse=coarse)
    _assert_info(it, ij)
    _assert_poses(Tt, Tj, poses, extent)
    if coarse is None:
        Tb, ib = register_batch_to_map(
            ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
            T_inits=inits, seed=SEED)
        _assert_info(it, ib)
        np.testing.assert_allclose(Tt, Tb, atol=1e-5)


def test_covariance_through_the_queue(scene):
    """The queue's per-scan output tables carry the WithCov minimizer's
    covariance: each scan's equals the batch's (within 1e-4 of its largest
    entry), as its pose does."""
    ref, scans, _, inits, _ = scene
    text = chain_yaml("p2plane_robust").replace("PointToPlaneErrorMinimizer",
                                                "PointToPlaneWithCovErrorMinimizer")
    ps = pt.ICPSequence(device=CPU)
    ps.load_from_yaml(text)
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    Tq, iq = register_queue_to_map(ps, clouds, T_inits=inits, seed=SEED, lanes=2)
    cq = ps.get_covariance()
    Tb, ib = register_batch_to_map(ps, clouds, T_inits=inits, seed=SEED)
    cb = ps.get_covariance()
    _assert_info(iq, ib)
    np.testing.assert_allclose(Tq, Tb, atol=1e-5)
    assert cq.shape == (len(scans), 6, 6)
    for a, b in zip(cq, cb):
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max()
