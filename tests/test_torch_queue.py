"""The continuous-batching queue: the port's ``register_queue_to_map``
against the JAX package's on the CPU, default chain, with the JAX draws fed
to the port's filters, on four routes taken by both packages:

- dense: the map is under ``SKIP_AUTO_MIN_MAP`` rows;
- K3: the resident survivor sweep, forced with ``PMTPU_SERVE_SKIP=1``;
- K4: the streaming survivor sweep, ``SKIP_MAX_MPAD`` lowered in both;
- K6: ``knn`` = 3 under ``PMTPU_SERVE_SKIP=1``, the top-k survivor sweep.

The JAX side's Pallas kernels run in interpret mode, as
tests/test_torch_batch.py runs them. Six scans of 900-1100 points through
four lanes, each from its own initial pose. Held equal per scan: iteration
count, stop code and compaction overflow flag; held within tolerance: the
pose, 1e-4 on rotation entries and 1e-4 × the scene extent on translation
(the two frameworks sum the normal equations in another order). The
coarse-to-fine schedule is held the same way in
tests/test_torch_queue_c2f.py.

The Differential checker compares a float32 acos, which moves in steps of
about 5e-4 rad near the identity, with 1e-3: where a scan's mean rotation
lies within a step of it, poses equal to 2e-7 (the JAX interpreter
contracts the survivor kernels' d² into FMAs, the port does not) can stop
one iteration apart. Measured on the CPU: with other initial poses one
scan of six did so on the survivor routes' coarse-to-fine runs, its pose
equal to 1.3e-7. The initial poses here keep every stop clear of that
step on every route, so iteration counts are held exactly.
"""

import numpy as np
import pytest
from test_torch_batch import (_map_draw, _room, _scan_draws, _yaw_pose,
                              interpret_mode)  # noqa: F401
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.matchers as jmatchers
import libpointmatcher_tpu.ops.knn_skip as ks
from libpointmatcher_tpu.parallel import register_queue_to_map as jax_queue

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.filters.normals import (
    SamplingSurfaceNormalDataPointsFilter)
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.ops import sweep
from libpointmatcher_tpu_torch.parallel import (PendingRegistration,
                                                queue_eligible,
                                                register_batch_to_map,
                                                register_queue_to_map)

CPU = "cpu"
MAP_SEED = 5
SEED = 3
LANES = 4
SCAN_ROWS = (1000, 900, 1100, 950, 1050, 1000)


@pytest.fixture(scope="module")
def scene():
    """A ~4000-point map, six scans of 900-1100 points displaced from the
    map frame by known poses (map ≈ T · scan) and an initial pose per scan
    near its truth."""
    rng = np.random.default_rng(0)
    world = _room(rng, 8000)
    ref = world[rng.choice(len(world), 4000, replace=False)].astype(np.float32)
    scans, poses, inits = [], [], []
    for i, n in enumerate(SCAN_ROWS):
        rows = world[rng.choice(len(world), n, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = _yaw_pose(0.03 * (i - 2), [0.06, -0.04 + 0.02 * i, 0.02])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
        inits.append((_yaw_pose(0.025 * (i % 3), [0.0, 0.04 * (i % 2), 0.0])
                      @ T).astype(np.float32))
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return ref, scans, poses, inits, extent


def force_route(monkeypatch, route):
    """Route both packages the same way (see the module docstring) → the
    matcher parameters."""
    if route == "dense":
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "auto")
    else:
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
        monkeypatch.setattr(jmatchers, "_use_pallas", lambda: True)
    if route == "K4":
        monkeypatch.setattr(ks, "SKIP_MAX_MPAD", 512)
        monkeypatch.setattr(sweep, "SKIP_MAX_MPAD", 512)
    return {"knn": "3"} if route == "K6" else {}


def queue_both(scene, params, **kw):
    """The JAX queue and the port's on the same scans, draws and poses →
    ((T, info) JAX, (T, info) port, JAX sequence, port sequence)."""
    ref, scans, _, inits, _ = scene
    js = pm.ICPSequence()
    js.set_default()
    js.matcher = pm.matchers.KDTreeMatcher(dict(params))
    js.set_map(pm.PointCloud.from_numpy(ref), seed=MAP_SEED)
    jax_out = jax_queue(js, [pm.PointCloud.from_numpy(s) for s in scans],
                        T_inits=inits, seed=SEED, lanes=LANES, **kw)
    ps = port_sequence(ref, params)
    port_out = register_queue_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED, lanes=LANES, **kw)
    return jax_out, port_out, js, ps


def port_sequence(ref, params=None):
    """The port's sequence with the JAX draws of the map and the scans."""
    ps = pt.ICPSequence(device=CPU)
    ps.set_default()
    ps.matcher = KDTreeMatcher(dict(params or {}))
    ps.reference_filters[0].uniform = _map_draw(len(ref))
    ps.reading_filters[0].uniform = _scan_draws(SEED, SCAN_ROWS)
    ps.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=MAP_SEED)
    return ps


def assert_same(jax_out, port_out, scene):
    (Tj, ij), (Tt, it) = jax_out, port_out
    _, _, poses, _, extent = scene
    assert set(ij) <= set(it)
    for key in ("iterations", "codes", "compact_overflow"):
        np.testing.assert_array_equal(it[key], ij[key], err_msg=key)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt, poses):
        np.testing.assert_allclose(T, gT, atol=0.02)


def assert_routes_agree(js, ps, route):
    for m in (js.matcher, ps.matcher):
        assert (m._skip_shared is not None) == (route != "dense")
        assert m._skip_stream == (route == "K4")


@pytest.mark.parametrize("route", ["dense", "K3", "K4", "K6"])
def test_queue_matches_jax_and_batch(scene, monkeypatch, interpret_mode, route,
                                    detail_telemetry):
    """Per scan, the JAX queue's iterations, codes, overflow flags and
    poses; and the port's own batch serving of the same scans, whose poses
    the queue gives within 1e-6."""
    params = force_route(monkeypatch, route)
    jax_out, port_out, js, ps = queue_both(scene, params)
    assert_same(jax_out, port_out, scene)
    assert_routes_agree(js, ps, route)
    if route != "dense":
        # one survivor share per lane iteration, one entry per lane
        shares = detail_telemetry("survivor_share")
        assert shares and all(np.shape(f) == (LANES,) for f in shares)
    _, scans, _, inits, _ = scene
    Tb, ib = register_batch_to_map(
        ps, [pt.PointCloud.from_numpy(s, device=CPU) for s in scans],
        T_inits=inits, seed=SEED)
    Tq, iq = port_out
    for key in ("iterations", "codes", "compact_overflow"):
        np.testing.assert_array_equal(iq[key], ib[key], err_msg=key)
    np.testing.assert_allclose(Tq, Tb, atol=1e-6)


@pytest.mark.parametrize("lanes", [1, 8])
def test_queue_lane_counts(scene, lanes):
    """One lane serves the scans one after another, eight lanes hold the
    whole queue at once (more lanes than scans): both give the batch's
    result per scan."""
    ref, scans, _, inits, _ = scene
    ps = port_sequence(ref)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans[:3]]
    Tb, ib = register_batch_to_map(ps, clouds, T_inits=inits[:3], seed=SEED)
    Tq, iq = register_queue_to_map(ps, clouds, T_inits=inits[:3], seed=SEED,
                                   lanes=lanes)
    np.testing.assert_array_equal(iq["iterations"], ib["iterations"])
    np.testing.assert_array_equal(iq["codes"], ib["codes"])
    np.testing.assert_allclose(Tq, Tb, atol=1e-6)


def test_block_false_emptied_scan_and_warmup(scene):
    ref, scans, _, inits, _ = scene
    ps = port_sequence(ref)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    T, info = register_queue_to_map(ps, clouds, T_inits=inits, seed=SEED,
                                    lanes=LANES)
    pending = register_queue_to_map(ps, clouds, T_inits=inits, seed=SEED,
                                    lanes=LANES, block=False)
    assert isinstance(pending, PendingRegistration)
    T2, info2 = pending.result()
    np.testing.assert_array_equal(T2, T)
    np.testing.assert_array_equal(info2["iterations"], info["iterations"])
    # scan 2's filter keeps nothing: it stops with the no-inliers code,
    # and the scans around it keep their results
    draws = _scan_draws(SEED, SCAN_ROWS).copy()
    draws[2] = 1.0
    ps.reading_filters[0].uniform = draws
    T3, info3 = register_queue_to_map(ps, clouds, T_inits=inits, seed=SEED,
                                      lanes=LANES)
    assert info3["codes"][2] == 4
    keep = np.arange(len(scans)) != 2
    np.testing.assert_array_equal(info3["iterations"][keep],
                                  info["iterations"][keep])
    np.testing.assert_allclose(T3[keep], T[keep], atol=1e-6)
    assert ps.warmup(500, batch=2, lanes=2, queue_len=3, coarse=(4, 12)) > 0
    ps.clear_map()
    with pytest.raises(RuntimeError, match="set_map"):
        register_queue_to_map(ps, clouds)


def test_ineligible_chain_is_served_as_a_batch(scene):
    """A reading chain with a host-step filter (SamplingSurfaceNormal) is
    served by register_batch_to_map, as in the JAX package."""
    ref, scans, _, inits, _ = scene
    ps = port_sequence(ref)
    assert queue_eligible(ps)
    ps.reading_filters = [SamplingSurfaceNormalDataPointsFilter()]
    assert not queue_eligible(ps)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans[:3]]
    Tq, iq = register_queue_to_map(ps, clouds, T_inits=inits[:3], seed=SEED,
                                   lanes=2)
    Tb, ib = register_batch_to_map(ps, clouds, T_inits=inits[:3], seed=SEED)
    np.testing.assert_array_equal(Tq, Tb)
    np.testing.assert_array_equal(iq["iterations"], ib["iterations"])
