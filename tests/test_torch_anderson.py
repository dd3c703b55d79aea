"""Anderson acceleration, the overlap estimate and the engine's accessors
against the JAX package on the CPU.

- ``_small_solve`` for windows of 1 to 4, random and near singular: values
  and ``ok`` flags bit for bit for m ≤ 3 (the same closed-form operations
  in the same order); for m = 4 both solve by LU, held within 1e-4
  relative where the system is well conditioned and by its flag alone
  where it is singular (the two LU codes give different noise there);
- one-shot ``ICP`` with ``acceleration = "anderson"`` at a fixed budget of
  10 iterations: the pose within 1e-6 of JAX's (the plain steps already
  differ by ~1e-9: the frameworks sum the normal equations in another
  order, so bit equality is out of reach); a converging run: the same
  iteration count and the pose within 1e-4;
- ``register_batch_to_map`` of 3 scans with acceleration: each scan's
  iterations and stop code equal JAX's, its pose within 1e-4 (rotation)
  and 1e-4 × the scene extent (translation); the queue refuses the chain
  in both packages and serves it as that batch;
- ``estimate_overlap`` with and without ``simpleSensorNoise``, one scan and
  a batch, within 1e-6; the four accessors after the same run.

Scenes are synthetic (``test_torch_loop_chains.make_scene``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_loop_chains import make_scene

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.icp import _small_solve as jax_small_solve
from libpointmatcher_tpu.minimizers import estimate_overlap as jax_overlap
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_batch
from libpointmatcher_tpu.parallel.stream import queue_eligible as jax_eligible

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.icp import _small_solve
from libpointmatcher_tpu_torch.matchers import Matches
from libpointmatcher_tpu_torch.minimizers import estimate_overlap
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.parallel.stream import queue_eligible

CPU = "cpu"
SEED = 3
MAP_SEED = 5


@pytest.fixture(scope="module")
def scene():
    return make_scene()


def _systems(m, kind, count=12, seed=0):
    rng = np.random.default_rng(seed + m)
    F = rng.standard_normal((count, m, 12)).astype(np.float32) * 1e-2
    if kind == "near_singular":
        F[:, -1] = F[:, 0] * np.float32(1.0001)
    A = np.einsum("bip,bjp->bij", F, F).astype(np.float32)
    return A, np.ones((count, m), np.float32)


@pytest.mark.parametrize("kind", ["random", "near_singular"])
@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_small_solve(m, kind):
    """Each system alone against JAX, and the batch of them at once equal
    to the systems one by one."""
    A, b = _systems(m, kind)
    x_b, ok_b = _small_solve(torch.as_tensor(A), torch.as_tensor(b))
    for i in range(len(A)):
        x, ok = _small_solve(torch.as_tensor(A[i]), torch.as_tensor(b[i]))
        xj, okj = jax_small_solve(jnp.asarray(A[i]), jnp.asarray(b[i]))
        assert bool(ok) == bool(okj) == bool(ok_b[i])
        if m <= 3:
            np.testing.assert_array_equal(x.numpy(), np.asarray(xj))
        elif kind == "random":
            np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-4)
        if m <= 3 or kind == "random":
            np.testing.assert_array_equal(x_b[i].numpy(), x.numpy())
    if m in (2, 3):
        # near singular, the cofactor determinant is noise: not ok
        assert bool(ok_b.all()) == (kind == "random")


def _pair(scene):
    ref, scans, poses, inits, extent = scene
    return scans[1], scans[0], np.linalg.inv(inits[0]) @ inits[1], extent


def _run_pair(scene, budget=None):
    reading, reference, T_init, _ = _pair(scene)
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    for e in (ij, it):
        e.set_default()
        e.acceleration = "anderson"
    if budget is not None:
        ij.checkers = [pm.TransformationCheckerRegistrar.create(
            "CounterTransformationChecker", {"maxIterationCount": str(budget)})]
        it.checkers = [CounterTransformationChecker(
            {"maxIterationCount": str(budget)})]
    Tj = np.asarray(ij(pm.PointCloud.from_numpy(reading),
                       pm.PointCloud.from_numpy(reference), T_init, seed=SEED))
    Tt = it(pt.PointCloud.from_numpy(reading, device=CPU),
            pt.PointCloud.from_numpy(reference, device=CPU), T_init,
            seed=SEED).numpy()
    return ij, it, Tj, Tt


def test_anderson_fixed_budget(scene):
    ij, it, Tj, Tt = _run_pair(scene, budget=10)
    assert it.last_iteration_count == ij.last_iteration_count == 10
    assert it.get_max_num_iterations_reached() and ij.get_max_num_iterations_reached()
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)


def test_anderson_converging(scene):
    """The default checkers: JAX's iteration count, its pose within 1e-4,
    and no more iterations than the plain loop takes."""
    ij, it, Tj, Tt = _run_pair(scene)
    assert it.last_iteration_count == ij.last_iteration_count
    assert not it.get_max_num_iterations_reached()
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    plain = pt.ICP(device=CPU)
    plain.set_default()
    reading, reference, T_init, _ = _pair(scene)
    plain(pt.PointCloud.from_numpy(reading, device=CPU),
          pt.PointCloud.from_numpy(reference, device=CPU), T_init, seed=SEED)
    assert it.last_iteration_count <= plain.last_iteration_count


def test_anderson_batch_and_queue(scene):
    ref, scans, poses, inits, extent = scene
    scans, inits = scans[:3], inits[:3]
    js = pm.ICPSequence()
    js.set_default()
    js.acceleration = "anderson"
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.acceleration = "anderson"
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    Tj, ij = jax_batch(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=inits, seed=SEED)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    Tt, it = register_batch_to_map(ps, clouds, T_inits=inits, seed=SEED)
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt, poses):
        np.testing.assert_allclose(T, gT, atol=0.03)
    assert not queue_eligible(ps) and not jax_eligible(js)
    Tq, iq = register_queue_to_map(ps, clouds, T_inits=inits, seed=SEED, lanes=2)
    np.testing.assert_array_equal(iq["iterations"], it["iterations"])
    np.testing.assert_array_equal(Tq, Tt)


def _overlap_inputs(b, noise, seed=0):
    """Readings, a reference, 2-NN matches (every 7th invalid) and weights
    (every 5th zero), one scan or ``b`` of them."""
    rng = np.random.default_rng(seed)
    ref = rng.uniform(-1, 1, (400, 3)).astype(np.float32)
    shape = (b, 300) if b else (300,)
    pts = (ref[rng.integers(0, 400, shape)]
           + 0.02 * rng.standard_normal(shape + (3,))).astype(np.float32)
    d2 = ((pts[..., None, :] - ref) ** 2).sum(-1)
    ids = np.argsort(d2, axis=-1)[..., :2].astype(np.int32)
    dists = np.take_along_axis(d2, ids, -1).astype(np.float32)
    dists[..., ::7, 1] = np.inf
    ids[..., ::7, 1] = -1
    w = rng.uniform(0.5, 1.0, dists.shape).astype(np.float32)
    w[..., ::5, 0] = 0.0
    mask = np.ones(shape, bool)
    mask[..., ::11] = False
    desc = {"simpleSensorNoise": (0.01 + 0.02 * rng.uniform(size=shape + (1,)))
            .astype(np.float32)} if noise else {}
    return pts, mask, desc, ref, dists, ids, w


@pytest.mark.parametrize("noise", [False, True])
@pytest.mark.parametrize("b", [0, 3])
def test_estimate_overlap(b, noise):
    pts, mask, desc, ref, dists, ids, w = _overlap_inputs(b, noise)
    t = torch.as_tensor
    got = estimate_overlap(
        pt.PointCloud(t(pts), t(mask), {k: t(v) for k, v in desc.items()}),
        pt.PointCloud(t(ref)), t(w), Matches(t(dists), t(ids)),
        t(np.full(b or (), 0.25, np.float32)))

    def one(p, m, dsc, dd, ii, ww):
        return jax_overlap(pm.PointCloud(p, m, dsc), pm.PointCloud(ref), ww,
                           pm.Matches(dd, ii), jnp.float32(0.25))

    fn = jax.vmap(one) if b else one
    want = fn(pts, mask, {k: jnp.asarray(v) for k, v in desc.items()},
              dists, ids, w)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-6)
    if noise:
        assert 0.0 < float(np.min(np.asarray(got))) < 1.0


@pytest.mark.parametrize("noise", [False, True])
def test_accessors(scene, noise):
    """The four accessors after one run of the same chain, with and without
    SimpleSensorNoise on the reading (a noise-aware overlap, from one more
    match at the final pose, or the weighted point-used ratio)."""
    reading, reference, T_init, _ = _pair(scene)
    ij, it = pm.ICP(), pt.ICP(device=CPU)
    for e, reg in ((ij, pm.DataPointsFilterRegistrar),
                   (it, pt.DataPointsFilterRegistrar)):
        e.set_default()
        if noise:
            e.reading_filters.append(reg.create(
                "SimpleSensorNoiseDataPointsFilter", {"sensorType": "2"}))
    ij(pm.PointCloud.from_numpy(reading), pm.PointCloud.from_numpy(reference),
       T_init, seed=SEED)
    it(pt.PointCloud.from_numpy(reading, device=CPU),
       pt.PointCloud.from_numpy(reference, device=CPU), T_init, seed=SEED)
    assert isinstance(it._prefiltered_reading, pt.PointCloud)   # read lazily
    assert it.get_prefiltered_reading_pts_count() == \
        ij.get_prefiltered_reading_pts_count()
    assert it.get_prefiltered_reference_pts_count() == \
        ij.get_prefiltered_reference_pts_count()
    assert it.get_max_num_iterations_reached() == ij.get_max_num_iterations_reached()
    assert (it.last_overlap is None) == (ij.last_overlap is None) == (not noise)
    # a pair within noise of the mean distance may flip: one pair in n
    n = it.get_prefiltered_reading_pts_count()
    assert abs(it.get_overlap() - ij.get_overlap()) <= 1.0 / n + 1e-6
    if not noise:
        assert it.get_overlap() == it.get_weighted_point_used_ratio()
