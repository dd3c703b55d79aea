"""Batched scan-to-map serving: the port's ``register_batch_to_map`` against
the JAX package's on the CPU, default chain, with the JAX draws fed to the
port's filters. Three routes, taken by both packages:

- dense: the map is under ``SKIP_AUTO_MIN_MAP`` rows;
- resident survivor sweep (K2 + K3): forced with ``PMTPU_SERVE_SKIP=1``,
  the JAX side's Pallas kernels in interpret mode, as
  tests/test_knn_skip.py forces it;
- streaming survivor sweep (K2 + K4): ``SKIP_MAX_MPAD`` lowered in both.

Held equal per scan: iteration count, stop code and the compaction
overflow flag. Held within tolerance: the pose, 1e-4 on rotation entries
and 1e-4 × the scene extent on translation (the two frameworks sum the
normal equations in another order), and the used-point ratios.
"""

import jax
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.matchers as jmatchers
import libpointmatcher_tpu.ops.knn_skip as ks
import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu.cloud import bucket_size
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_serve

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.ops import cuda_build, sweep
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.parallel import (PendingRegistration,
                                                register_batch_to_map)

CPU = "cpu"
MAP_SEED = 5
SCAN_ROWS = (1000, 900, 1100)


def _room(rng, n):
    """Floor, two walls, a table top and a block face: a planar scene."""
    k = n // 5
    return np.concatenate([
        np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
        np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
        np.c_[np.full(k, 4.5), rng.uniform(1, 3, k), rng.uniform(0, 1.5, k)]])


def _yaw_pose(ang, t):
    T = np.eye(4)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                 [0, 0, 1]]
    T[:3, 3] = t
    return T


@pytest.fixture(scope="module")
def scene():
    """A ~4000-point map and three scans of 900-1100 points, each displaced
    from the map frame by a known pose (map ≈ T · scan)."""
    rng = np.random.default_rng(0)
    world = _room(rng, 8000)
    ref = world[rng.choice(len(world), 4000, replace=False)].astype(np.float32)
    scans, poses = [], []
    for i, n in enumerate(SCAN_ROWS):
        rows = world[rng.choice(len(world), n, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = _yaw_pose(0.03 * (i - 1), [0.06, -0.04 + 0.02 * i, 0.02])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return ref, scans, poses, extent


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(k2.pl, "pallas_call", patched)
    monkeypatch.setattr(ks.pl, "pallas_call", patched)


def _map_draw(n):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(MAP_SEED), 1), 0)
    return np.asarray(jax.random.uniform(key, (bucket_size(n),)))[:n]


def _scan_draws(seed, rows):
    """The JAX batch driver's draws: scan i's first filter takes key
    fold_in(fold_in(PRNGKey(seed), i), 0) over the stacked row count."""
    stacked = bucket_size(max(bucket_size(n) for n in rows))
    return np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed), i), 0),
        (stacked,))) for i in range(len(rows))])


def _port_sequence(ref):
    seq = pt.ICPSequence(device=CPU)
    seq.set_default()
    seq.reference_filters[0].uniform = _map_draw(len(ref))
    seq.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    return seq


def _serve_both(scene, seed=3, **kw):
    ref, scans, poses, _ = scene
    T_inits = [np.eye(4, dtype=np.float32)] * len(scans)
    js = pm.ICPSequence()
    js.set_default()
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    Tj, ij = jax_serve(js, [pm.PointCloud.from_numpy(s) for s in scans],
                       T_inits=T_inits, seed=seed, **kw)
    ps = _port_sequence(ref)
    ps.reading_filters[0].uniform = _scan_draws(seed, SCAN_ROWS)
    Tt, it = register_batch_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=T_inits, seed=seed, **kw)
    return (Tj, ij), (Tt, it), js, ps


def _assert_same(jax_out, port_out, scene):
    (Tj, ij), (Tt, it) = jax_out, port_out
    _, _, poses, extent = scene
    assert set(ij) <= set(it)
    for key in ("iterations", "codes", "compact_overflow"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    for key in ("point_used_ratio", "weighted_point_used_ratio"):
        np.testing.assert_allclose(it[key], ij[key], rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt, poses):
        np.testing.assert_allclose(T, gT, atol=0.02)


@pytest.mark.parametrize("route", ["dense", "K3", "K4"])
def test_batch_serving_matches_jax(scene, monkeypatch, interpret_mode, route,
                                   detail_telemetry):
    if route == "dense":
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "auto")
    else:
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
        monkeypatch.setattr(jmatchers, "_use_pallas", lambda: True)
    if route == "K4":
        monkeypatch.setattr(ks, "SKIP_MAX_MPAD", 512)
        monkeypatch.setattr(sweep, "SKIP_MAX_MPAD", 512)
    jax_out, port_out, js, ps = _serve_both(scene)
    _assert_same(jax_out, port_out, scene)
    mat = ps.matcher
    for m in (js.matcher, mat):
        assert (m._skip_shared is not None) == (route != "dense")
        assert m._skip_stream == (route == "K4")
    if route != "dense":
        # one survivor share per lockstep iteration, one entry per scan
        shares = detail_telemetry("survivor_share")
        assert len(shares) == int(port_out[1]["iterations"].max())
        assert all(np.shape(f) == (3,) for f in shares)


def test_pinned_compaction_overflow_matches_jax(scene):
    """A pinned capacity below the filtered count cuts every scan to its
    first rows in the same order in both packages and reports it."""
    jax_out, port_out, _, _ = _serve_both(scene, compact_rows=600)
    assert port_out[1]["compact_overflow"].all()
    _assert_same(jax_out, port_out, scene)


def test_block_false_warmup_and_emptied_scan(scene):
    ref, scans, _, _ = scene
    ps = _port_sequence(ref)
    assert ps.has_map()
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    T, info = register_batch_to_map(ps, clouds, seed=2)
    pending = register_batch_to_map(ps, clouds, seed=2, block=False)
    assert isinstance(pending, PendingRegistration)
    T2, info2 = pending.result()
    assert pending.result()[0] is T2
    np.testing.assert_array_equal(T2, T)
    np.testing.assert_array_equal(info2["iterations"], info["iterations"])
    assert ps.warmup(500, batch=2) > 0
    # a scan its filters empty stops with the no-inliers code, no raise
    ps.reading_filters[0].uniform = np.ones((2, 1100), np.float32)
    _, info3 = register_batch_to_map(ps, clouds[:2], seed=2)
    np.testing.assert_array_equal(info3["codes"], [4, 4])
    ps.clear_map()
    assert not ps.has_map()
    with pytest.raises(RuntimeError, match="set_map"):
        register_batch_to_map(ps, clouds)


def test_entry_points_and_kernels_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.ICPSequence()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt.PointCloud.from_numpy(np.zeros((4, 3), np.float32))
    try:
        cuda_build._nvcc()
    except RuntimeError:
        for lib in (kc.LIBRARY, sc.LIBRARY):
            with pytest.raises(RuntimeError, match="nvcc"):
                lib.load()
