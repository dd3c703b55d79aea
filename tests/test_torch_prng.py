"""The port's random draws against JAX's: ``utils/prng.py`` against
``jax.random`` bit for bit, then the four drivers with no draw handed in,
each against the JAX engine on the same seed.

Held equal: the keys' data and every uniform value, bit for bit; per scan
or pair the iteration count and stop code. Held within tolerance: the
pose, 1e-4 on rotation entries and 1e-4 × the scene extent on translation
(the frameworks sum the normal equations in another order).
"""

import jax
import numpy as np
import pytest
import torch

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.parallel import register_batch as jax_register_batch
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_serve

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.filters.base import DataPointsFilter
from libpointmatcher_tpu_torch.parallel import (register_batch,
                                                register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.utils import prng

from test_torch_batch import MAP_SEED, SCAN_ROWS
from test_torch_batch import scene as serve_scene  # noqa: F401
from test_torch_icp import _assert_pose, scene  # noqa: F401
from test_torch_pairs import pairs  # noqa: F401

CPU = "cpu"
SEEDS = [0, 3, 7, 123456, 2**31, 2**32 - 1, 2**33 + 7, -1]
FOLDS = [[], [1], [2, 0], [5, 0], [2**32 - 1], [2**31, 17, 3]]


def _key_data(key):
    return tuple(int(x) for x in np.asarray(jax.random.key_data(key)))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_equal_jax(seed):
    kj, kp = jax.random.PRNGKey(seed), prng.prng_key(seed)
    assert _key_data(kj) == kp
    for path in FOLDS:
        kj_f, kp_f = kj, kp
        for d in path:
            kj_f, kp_f = jax.random.fold_in(kj_f, d), prng.fold_in(kp_f, d)
        assert _key_data(kj_f) == kp_f, path


@pytest.mark.parametrize("n", [1, 2, 7, 128, 1000, 18800, 20992, 25000])
@pytest.mark.parametrize("seed,path", [(0, []), (3, [2, 0]), (2**33 + 7, [5, 0]),
                                       (-1, [2**32 - 1])])
def test_uniform_equals_jax(seed, path, n):
    kj, kp = jax.random.PRNGKey(seed), prng.prng_key(seed)
    for d in path:
        kj, kp = jax.random.fold_in(kj, d), prng.fold_in(kp, d)
    uj = np.asarray(jax.random.uniform(kj, (n,)), np.float32)
    up = prng.uniform(kp, n, CPU).numpy()
    assert up.dtype == np.float32
    np.testing.assert_array_equal(up.view(np.uint32), uj.view(np.uint32))


def test_vector_keys_equal_single_keys():
    """A key of B-element tensors draws each key's values in one pass."""
    keys = [prng.fold_in(prng.prng_key(9), i) for i in range(5)]
    k0, k1 = (torch.tensor([k[j] for k in keys]) for j in (0, 1))
    u = prng.uniform((k0, k1), 3000, CPU)
    assert u.shape == (5, 3000)
    for i, k in enumerate(keys):
        assert torch.equal(u[i], prng.uniform(k, 3000, CPU))


def test_one_shot_icp_draws_match_jax(scene):  # noqa: F811
    read, ref, dT, extent = scene
    seed = 3
    icp = pm.ICP()
    icp.set_default()
    Tj = icp(pm.PointCloud.from_numpy(read), pm.PointCloud.from_numpy(ref),
             seed=seed)
    ti = pt.ICP(device=CPU)
    ti.set_default()
    Tt = ti(pt.PointCloud.from_numpy(read, device=CPU),
            pt.PointCloud.from_numpy(ref, device=CPU), seed=seed)
    assert ti.last_iteration_count == icp.last_iteration_count
    assert ti.max_num_iterations_reached == icp.max_num_iterations_reached
    assert ti.prefiltered_reference_pts_count == icp.prefiltered_reference_pts_count
    assert ti.prefiltered_reading_pts_count == icp.prefiltered_reading_pts_count
    _assert_pose(Tt.numpy(), Tj, extent)


def test_icp_sequence_draws_match_jax(scene):  # noqa: F811
    read, ref, dT, extent = scene
    seq = pm.ICPSequence()
    seq.set_default()
    seq.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    np.testing.assert_allclose(ps.get_prefiltered_internal_map().to_numpy()[0],
                               seq.get_prefiltered_internal_map().to_numpy()[0],
                               atol=1e-6 * extent)
    for seed, T_init in ((11, None), (12, dT)):
        kw = {} if T_init is None else {"T_init": T_init}
        Tj = seq.compute(pm.PointCloud.from_numpy(read), seed=seed, **kw)
        Tt = ps.compute(pt.PointCloud.from_numpy(read, device=CPU), seed=seed, **kw)
        assert ps.last_iteration_count == seq.last_iteration_count
        assert ps.prefiltered_reading_pts_count == seq.prefiltered_reading_pts_count
        _assert_pose(Tt.numpy(), Tj, extent)


def _assert_same(jax_out, port_out, extent):
    (Tj, ij), (Tt, it) = jax_out, port_out
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)


class _DrawLog:
    """Records every draw a filter makes from a key."""

    def __init__(self, monkeypatch):
        self.draws = []
        orig = DataPointsFilter.draw_uniform

        def logged(f, cloud, key, scan=None):
            u = orig(f, cloud, key, scan)
            self.draws.append((scan, u.clone()))
            return u

        monkeypatch.setattr(DataPointsFilter, "draw_uniform", logged)


def test_batch_and_queue_draws_match_jax(serve_scene, monkeypatch):  # noqa: F811
    """register_batch_to_map against the JAX batch with no draw handed in;
    the queue's scans draw what the batch's scans draw."""
    ref, scans, _, extent = serve_scene
    seed = 3
    T_inits = [np.eye(4, dtype=np.float32)] * len(scans)
    js = pm.ICPSequence()
    js.set_default()
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    jax_out = jax_serve(js, [pm.PointCloud.from_numpy(s) for s in scans],
                        T_inits=T_inits, seed=seed)
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    log = _DrawLog(monkeypatch)
    port_out = register_batch_to_map(ps, clouds, T_inits=T_inits, seed=seed)
    _assert_same(jax_out, port_out, extent)
    batch_draws, log.draws = log.draws, []
    register_queue_to_map(ps, clouds, T_inits=T_inits, seed=seed, lanes=2)
    assert [s for s, _ in batch_draws] == list(range(len(SCAN_ROWS)))
    assert len(log.draws) == len(batch_draws)
    for (sb, ub), (sq, uq), n in zip(batch_draws, log.draws, SCAN_ROWS):
        assert sb == sq and ub.shape == (n,) and torch.equal(ub, uq)


def test_register_batch_draws_match_jax(pairs):  # noqa: F811
    reads, refs, poses, extent = pairs
    seed = 4
    icp = pm.ICP()
    icp.set_default()
    jax_out = jax_register_batch(icp, [pm.PointCloud.from_numpy(r) for r in reads],
                                 [pm.PointCloud.from_numpy(r) for r in refs],
                                 seed=seed)
    ti = pt.ICP(device=CPU)
    ti.set_default()
    port_out = register_batch(ti, [pt.PointCloud.from_numpy(r, device=CPU)
                                   for r in reads],
                              [pt.PointCloud.from_numpy(r, device=CPU)
                               for r in refs], seed=seed)
    _assert_same(jax_out, port_out, extent)
