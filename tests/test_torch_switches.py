"""The JAX package's five ``PMTPU_*`` switches in the port, each held to the
JAX package on the CPU. The port reads two of them, each at its decision
point (``PMTPU_CACHE_DIR`` when a library is first built or loaded), so
each case sets it with ``monkeypatch.setenv``; the other three stand in
ROADMAP Queue 3, and their cases show that the port's results do not
move under them.

- ``PMTPU_KNN_IMPL=mxu``: every dense k = 1 search takes K9. The routing
  with the kernels stubbed and counted, beside the JAX package's (whose CPU
  path ignores the switch, so its TPU routing is read with ``use_pallas``
  stubbed, as tests/test_matchers.py does); K9's plain version against the
  Pallas kernel in interpret mode (d² within K9's 2^-20·(q²+r²), ids where
  the neighbour is unique); a default-chain ``ICPSequence`` and a dense
  batch under the switch equal bit for bit to the port's ε = 10 route and
  within the pose gates (0.02 rad, 0.05 m) of the ground truth.
- ``PMTPU_SOLVE``, not read by the port (ROADMAP Queue 3 #52): under
  ``chol`` the port's eigensolve is unchanged bit for bit; against the JAX
  branch, called unjitted, within 1e-5 relative on full-rank 6x6 and 3x3
  systems, and on singular ones (a tilted plane) the JAX error that the
  port does not share; the one-shot engine against the JAX engine under
  ``chol``, the JAX program traced afresh (``jax.clear_caches()``): the same
  iteration count, T within 1e-4.
- ``PMTPU_SELECT``, not read by the port (Queue 3 #53): under ``bisect`` the
  sort select's value bit for bit, and the JAX radix and bisection selects'
  values (−0 and +0 equal, Queue 3 #50), with ties, ±0, masked NaN and
  ±inf, and batch dims.
- ``PMTPU_STACK_NUMPY``, not read by the port (Queue 3 #49): host scans
  with one set of channels are stacked on the host; the batch, the queue
  and the tile batch bit for bit equal under unset, ``0`` and ``1`` and
  with each scan moved on its own.
- ``PMTPU_CACHE_DIR``: the native library built into a fresh directory, and
  a second process loading it without a rebuild.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_batch import _room, _yaw_pose
from test_torch_blockgrid import BENCH, _chain, _terrain, _prior_error

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.ops.knn_pallas as kp
from libpointmatcher_tpu.minimizers import \
    solve_possibly_underdetermined as jax_solve
from libpointmatcher_tpu.ops import dispatch as jax_dispatch
from libpointmatcher_tpu.utils.masked import masked_quantile as jax_quantile

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.minimizers import solve_possibly_underdetermined
from libpointmatcher_tpu_torch.ops import cuda_build, dispatch
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.utils.masked import (masked_mad, masked_median,
                                                    masked_quantile)

CPU = "cpu"
REPO = Path(__file__).resolve().parent.parent
ROT_TOL, TRANS_TOL = 0.02, 0.05


def _pose_error(T, G):
    R = np.asarray(T)[:3, :3] @ G[:3, :3].T
    ang = float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return ang, float(np.linalg.norm(np.asarray(T)[:3, 3] - G[:3, 3]))


# ------------------------------------------------------------ PMTPU_KNN_IMPL
@pytest.mark.parametrize("env,eps,port,jax_route", [
    (None, 0.0, "vpu", "vpu"),
    (None, 1e-5, "vpu", "mxu"),           # the port's floor is 10 (Queue 3 #3)
    (None, dispatch.MXU_EPSILON_FLOOR, "mxu", "mxu"),
    ("vpu", 0.0, "vpu", "vpu"),
    ("other", 0.0, "vpu", "vpu"),
    ("mxu", 0.0, "mxu", "mxu"),
    ("mxu", 1e-8, "mxu", "mxu"),
])
def test_knn_search_routing(monkeypatch, env, eps, port, jax_route):
    """k = 1 goes to K9 under ``PMTPU_KNN_IMPL=mxu`` at any ε in both
    packages; any other value leaves the choice to ε; k > 1 ignores it."""
    if env is None:
        monkeypatch.delenv("PMTPU_KNN_IMPL", raising=False)
    else:
        monkeypatch.setenv("PMTPU_KNN_IMPL", env)
    calls = []

    def fake(name):
        return lambda q, qm, r, rm, *a: (calls.append(name), (q[..., 0], q[..., 0]))[1]

    monkeypatch.setattr(dispatch, "knn1", fake("vpu"))
    monkeypatch.setattr(dispatch, "knn1_mxu", fake("mxu"))
    monkeypatch.setattr(dispatch, "knnk", lambda q, qm, r, rm, k: (
        calls.append("knnk"), (q, q))[1])
    q, m = torch.zeros(4, 3), torch.ones(4, dtype=torch.bool)
    dispatch.knn_search(q, m, q, m, k=1, epsilon=eps)
    dispatch.knn_search(q, m, q, m, k=3, epsilon=eps)
    assert calls == [port, "knnk"]

    calls.clear()
    monkeypatch.setattr(jax_dispatch, "use_pallas", lambda: True)
    monkeypatch.setattr(jax_dispatch, "knn1_pallas", fake("vpu"))
    monkeypatch.setattr(jax_dispatch, "knn1_pallas_mxu", fake("mxu"))
    jq, jm = jnp.zeros((4, 3)), jnp.ones(4, bool)
    jax_dispatch.knn_search(jq, jm, jq, jm, k=1, epsilon=eps)
    assert calls == [jax_route]


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(kp.pl, "pallas_call", patched)


def test_k9_under_the_switch_matches_pallas(monkeypatch, interpret_mode):
    """On the CPU the switch runs K9's plain version (the JAX package's CPU
    path would ignore it): through ``knn_search`` equal bit for bit to
    ``knn1_mxu_plain``, and held to the Pallas K9 in interpret mode."""
    rng = np.random.default_rng(1)
    world = _room(rng, 4000).astype(np.float32)
    q = (world[:600] + 0.01 * rng.standard_normal((600, 3))).astype(np.float32)
    r = world[1000:2500]
    qm, rm = np.ones(600, bool), np.ones(1500, bool)
    qm[7:11] = False
    rm[::5] = False
    monkeypatch.setenv("PMTPU_KNN_IMPL", "mxu")
    args = [torch.from_numpy(x) for x in (q, qm, r, rm)]
    dt, it = dispatch.knn_search(*args, k=1)
    dp, ip = kc.knn1_mxu_plain(*args)
    assert torch.equal(dt[:, 0], dp) and torch.equal(it[:, 0], ip)
    dj, ij = map(np.asarray, kp.knn1_pallas_mxu(q, qm, r, rm))
    dt, it = dt[:, 0].numpy(), it[:, 0].numpy()
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(fin, np.isfinite(dt))
    tol = 2.0 ** -20 * ((q ** 2).sum(1) + float((r[rm] ** 2).sum(1).max()))
    assert np.all(np.abs(dt[fin] - dj[fin]) <= tol[fin])
    # ids wherever the exact neighbour leads the runner-up by more than
    # both kernels' error
    d2 = ((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)
    d2[:, ~rm] = np.inf
    two = np.sort(d2, axis=1)[:, :2]
    uniq = qm & (two[:, 1] - two[:, 0] > 4 * tol)
    np.testing.assert_array_equal(it[uniq], ij[uniq])


@pytest.fixture(scope="module")
def room():
    """A ~4000-point map (under 16 384 rows: dense serving) and four scans
    of 1 200 points, each displaced from the map frame by a known pose."""
    rng = np.random.default_rng(0)
    world = _room(rng, 8000)
    ref = world[rng.choice(len(world), 4000, replace=False)].astype(np.float32)
    scans, poses = [], []
    for i in range(4):
        rows = world[rng.choice(len(world), 1200, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = _yaw_pose(0.02 * (i - 1), [0.05, -0.03 + 0.02 * i, 0.02])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
    return ref, scans, poses


def _count_k1_k9(monkeypatch):
    """Wrap the dense k = 1 kernels' entries in ``knn_search`` to count
    calls (the CPU path counts no launch)."""
    counts = {"K1": 0, "K9": 0}
    for name, key in (("knn1", "K1"), ("knn1_mxu", "K9")):
        fn = getattr(dispatch, name)

        def spy(*a, _fn=fn, _key=key):
            counts[_key] += 1
            return _fn(*a)

        monkeypatch.setattr(dispatch, name, spy)
    return counts


def _sequence(ref, matcher=None):
    seq = pt.ICPSequence(device=CPU)
    seq.set_default()
    if matcher is not None:
        seq.matcher = KDTreeMatcher(matcher)
    seq.set_map(pt.PointCloud.from_numpy(ref, device=CPU), seed=0)
    return seq


def test_mxu_switch_serves_sequence_and_batch_through_k9(monkeypatch, room):
    """A default-chain ``ICPSequence`` and a dense ``register_batch_to_map``
    under the switch: every search K9, none K1, poses equal bit for bit to
    the ε = 10 route (K9 by ε) and within the ground truth's gates."""
    ref, scans, poses = room
    counts = _count_k1_k9(monkeypatch)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    eps_seq = _sequence(ref, {"epsilon": str(dispatch.MXU_EPSILON_FLOOR)})
    want = [eps_seq.compute(c, seed=i).numpy() for i, c in enumerate(clouds[:2])]
    want_batch = register_batch_to_map(eps_seq, clouds, seed=1)

    monkeypatch.setenv("PMTPU_KNN_IMPL", "mxu")
    seq = _sequence(ref)
    counts.update(K1=0, K9=0)
    iters = 0
    for i, c in enumerate(clouds[:2]):
        T = seq.compute(c, seed=i).numpy()
        iters += seq.last_iteration_count
        assert np.array_equal(T, want[i])
        ang, tr = _pose_error(T, poses[i])
        assert ang < ROT_TOL and tr < TRANS_TOL
    assert counts == {"K1": 0, "K9": iters}

    counts.update(K1=0, K9=0)
    T, info = register_batch_to_map(seq, clouds, seed=1)
    assert counts == {"K1": 0, "K9": int(info["iterations"].max())}
    assert np.array_equal(T, want_batch[0])
    assert np.array_equal(info["iterations"], want_batch[1]["iterations"])
    for Ti, P in zip(T, poses):
        ang, tr = _pose_error(Ti, P)
        assert ang < ROT_TOL and tr < TRANS_TOL


def test_mxu_switch_leaves_the_survivor_route_exact(monkeypatch, room):
    """Route choice does not read the switch: under ``PMTPU_SERVE_SKIP=1``
    the batch takes the survivor route (K2 + K3), launches no dense search
    and gives the result it gives without the switch."""
    ref, scans, _ = room
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    seq = _sequence(ref)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    want = register_batch_to_map(seq, clouds, seed=1)
    counts = _count_k1_k9(monkeypatch)
    monkeypatch.setenv("PMTPU_KNN_IMPL", "mxu")
    T, info = register_batch_to_map(seq, clouds, seed=1)
    assert counts == {"K1": 0, "K9": 0} and seq.matcher.survivor_fractions
    assert np.array_equal(T, want[0])


# --------------------------------------------------------------- PMTPU_SOLVE
def _system(p, seed):
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(300, p)).astype(np.float32)
    return (F.T @ F).astype(np.float32), rng.normal(size=p).astype(np.float32)


def _tilted_plane(seed):
    """A singular point-to-plane system: 400 points of a tilted plane with
    its normal, the map 0.5 m along it (rank 3 of 6; the null directions
    are not axis-aligned, so float32 rounding leaves right-hand components
    along them)."""
    rng = np.random.default_rng(seed)
    n = rng.normal(size=3)
    n /= np.linalg.norm(n)
    e1 = np.cross(n, [1.0, 0.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    uv = rng.uniform(-2, 2, (400, 2))
    p = (uv[:, :1] * e1 + uv[:, 1:] * e2 + 0.3).astype(np.float32)
    F = np.c_[np.cross(p, np.tile(n, (400, 1))), np.tile(n, (400, 1))]
    F = F.astype(np.float32)
    dot = np.full(400, -0.5, np.float32)
    return (F.T @ F).astype(np.float32), -(F.T @ dot).astype(np.float32)


def _port_solve(A, b):
    return solve_possibly_underdetermined(torch.from_numpy(A),
                                          torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("p,seed", [(6, 0), (6, 1), (3, 2)])
def test_chol_switch_agrees_with_the_eigensolve_at_full_rank(monkeypatch, p, seed):
    """The port does not read ``PMTPU_SOLVE`` (ROADMAP Queue 3 #52): under
    ``chol`` it gives its eigensolve bit for bit, which at full rank is the
    JAX ridged Cholesky's solution within 1e-5 relative."""
    A, b = _system(p, seed)
    exact = _port_solve(A, b)
    monkeypatch.setenv("PMTPU_SOLVE", "chol")
    got = _port_solve(A, b)
    assert got.tobytes() == exact.tobytes()
    want = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("seed", [2, 4, 5])
def test_chol_solve_reproduces_the_jax_error_on_singular_systems(monkeypatch,
                                                                 seed):
    """The JAX ``chol`` branch's ridge amplifies the right-hand side's
    rounding along the null directions by 1/λ (more than a tenth of the
    solution here). The port does not reproduce that error: it ignores the
    switch (Queue 3 #52) and gives the minimal-norm eigensolve, which
    equals JAX's default solve within 1e-5 of the solution's size."""
    A, b = _tilted_plane(seed)
    exact = _port_solve(A, b)
    jax_eigh = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(b)))
    monkeypatch.setenv("PMTPU_SOLVE", "chol")
    got = _port_solve(A, b)
    jax_chol = np.asarray(jax_solve(jnp.asarray(A), jnp.asarray(b)))
    assert got.tobytes() == exact.tobytes()
    np.testing.assert_allclose(got, jax_eigh, atol=1e-5 * np.abs(jax_eigh).max())
    assert np.abs(jax_chol - exact).max() > 0.1 * np.abs(exact).max()


@pytest.fixture
def fresh_jax_programs():
    """No JAX program traced under another setting is reused, before or
    after."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def test_engine_under_chol_matches_jax(monkeypatch, room, fresh_jax_programs):
    """The one-shot engine with ``PMTPU_SOLVE=chol`` set: the JAX engine
    solves by its ridged Cholesky, the port by its eigensolve (the switch
    unread, its result bit for bit the one without it); on this full-rank
    problem the two keep the same iteration count and T within 1e-4."""
    ref, scans, poses = room

    def port():
        ti = pt.ICP(device=CPU)
        ti.set_default()
        T = ti(pt.PointCloud.from_numpy(scans[1], device=CPU),
               pt.PointCloud.from_numpy(ref, device=CPU), seed=3).numpy()
        return T, ti.last_iteration_count

    want = port()
    monkeypatch.setenv("PMTPU_SOLVE", "chol")
    icp = pm.ICP()
    icp.set_default()
    Tj = np.asarray(icp(pm.PointCloud.from_numpy(scans[1]),
                        pm.PointCloud.from_numpy(ref), seed=3))
    Tt, iters = port()
    assert Tt.tobytes() == want[0].tobytes() and iters == want[1]
    assert iters == icp.last_iteration_count
    np.testing.assert_allclose(Tt, Tj, atol=1e-4)
    ang, tr = _pose_error(Tt, poses[1])
    assert ang < ROT_TOL and tr < TRANS_TOL


# -------------------------------------------------------------- PMTPU_SELECT
def _select_inputs():
    """[4, 257] float32: ties, ±0, ±inf, NaN, and a row with no finite
    entry."""
    rng = np.random.default_rng(3)
    v = rng.choice(np.float32([0.0, -0.0, 1.5, -1.5, 2.0, np.inf, -np.inf,
                               np.nan]), size=(4, 257)).astype(np.float32)
    noise = rng.normal(size=(4, 257)).astype(np.float32)
    v = np.where(rng.random((4, 257)) < 0.4, noise, v)
    v[2] = np.abs(v[2])
    v[3] = np.where(np.isfinite(v[3]), np.nan, v[3])
    return v


@pytest.mark.parametrize("q", [0.0, 0.1, 0.5, 0.73, 1.0])
def test_bisect_select_equals_sort_and_jax(monkeypatch, q):
    """The port does not read ``PMTPU_SELECT`` (Queue 3 #53): under
    ``bisect`` its sort select gives its value without the switch bit for
    bit, and the JAX radix and bisection selects' values, −0 and +0 taken
    as equal (Queue 3 #50)."""
    v = _select_inputs()
    t = torch.from_numpy(v)
    sort = masked_quantile(t, q, batch_dims=1)
    jax_radix = np.asarray(jax.vmap(lambda x: jax_quantile(x, q))(jnp.asarray(v)))
    monkeypatch.setenv("PMTPU_SELECT", "bisect")
    got = masked_quantile(t, q, batch_dims=1)
    jax_bisect = np.asarray(jax.vmap(lambda x: jax_quantile(x, q))(jnp.asarray(v)))
    assert got.numpy().tobytes() == sort.numpy().tobytes()
    # the row without a finite entry: +inf in the port (Queue 3 #46)
    assert np.isinf(float(got[3])) and np.isnan(jax_radix[3]) and np.isnan(jax_bisect[3])
    assert np.array_equal(got[:3].numpy(), jax_radix[:3])
    assert np.array_equal(got[:3].numpy(), jax_bisect[:3])


def test_bisect_keeps_median_and_mad(monkeypatch):
    v = torch.from_numpy(_select_inputs()[:3])
    want = (masked_median(v, 1), masked_mad(v, 1))
    monkeypatch.setenv("PMTPU_SELECT", "bisect")
    got = (masked_median(v, 1), masked_mad(v, 1))
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == w.numpy().tobytes()


# ------------------------------------------- PMTPU_STACK_NUMPY and the upload
def _per_scan(readings, dev):
    return [rd.to(dev) for rd in readings]


def _each_upload(monkeypatch, run):
    """``run()`` with the host scans stacked (the port's path for them),
    under ``PMTPU_STACK_NUMPY=0`` and ``1`` (unread: Queue 3 #49), and with
    each scan moved on its own, the path of scans off the host."""
    from libpointmatcher_tpu_torch.parallel import batch

    out = []
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("PMTPU_STACK_NUMPY", raising=False)
        else:
            monkeypatch.setenv("PMTPU_STACK_NUMPY", value)
        out.append(run())
    monkeypatch.delenv("PMTPU_STACK_NUMPY", raising=False)
    monkeypatch.setattr(batch, "_upload", _per_scan)
    out.append(run())
    return out


def _assert_equal_runs(outs):
    (T0, i0), *rest = outs
    for T, info in rest:
        assert np.array_equal(T, T0)
        for key in i0:
            assert np.array_equal(info[key], i0[key]), key


@pytest.mark.parametrize("driver", ["batch", "queue", "survivor batch"])
def test_stack_numpy_keeps_the_batch_and_queue(monkeypatch, room, driver):
    ref, scans, _ = room
    if driver == "survivor batch":
        monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    seq = _sequence(ref)
    # the scans lie on the host with one set of channels: stacked there
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    clouds[1] = clouds[1].with_descriptor(
        "intensity", torch.arange(1200, dtype=torch.float32))
    for i in range(len(clouds)):
        if i != 1:
            clouds[i] = clouds[i].with_descriptor(
                "intensity", torch.zeros(clouds[i].num_points))

    def run():
        if driver == "queue":
            return register_queue_to_map(seq, clouds, seed=1, lanes=2)
        return register_batch_to_map(seq, clouds, seed=1)

    _assert_equal_runs(_each_upload(monkeypatch, run))


def test_stack_numpy_uploads_one_stack(monkeypatch):
    """Host scans with the same channels become views of one stack whose
    rows are a multiple of 64, whatever ``PMTPU_STACK_NUMPY`` says; scans
    whose channels differ are moved one by one."""
    from libpointmatcher_tpu_torch.parallel import batch

    rng = np.random.default_rng(0)
    clouds = [pt.PointCloud.from_numpy(rng.normal(size=(n, 3)), device=CPU,
                                       times={"t": np.arange(n)})
              for n in (70, 5, 129)]
    for value in (None, "0", "1"):
        if value is None:
            monkeypatch.delenv("PMTPU_STACK_NUMPY", raising=False)
        else:
            monkeypatch.setenv("PMTPU_STACK_NUMPY", value)
        out = batch._upload(clouds, CPU)
        assert len({c.points.untyped_storage().data_ptr() for c in out}) == 1
        assert out[0].points.untyped_storage().nbytes() == 3 * 192 * 3 * 4
        for c, rd in zip(out, clouds):
            assert torch.equal(c.points, rd.points) and torch.equal(c.mask, rd.mask)
            assert torch.equal(c.get_time("t"), rd.get_time("t"))
    mixed = clouds[:2] + [clouds[2].with_descriptor("w", torch.ones(129))]
    assert len({c.points.untyped_storage().data_ptr()
                for c in batch._upload(mixed, CPU)}) == 3


def test_stack_numpy_keeps_the_tile_batch(monkeypatch):
    rng = np.random.default_rng(7)
    pts, side = _terrain(4000, rng)
    scans = []
    for _ in range(3):
        c = rng.uniform(2.0, side - 2.0, 2)
        sel = np.linalg.norm(pts[:, :2] - c[None, :], axis=1) < 2.0
        Ti = np.linalg.inv(_prior_error(rng, c))
        scans.append((pts[sel] @ Ti[:3, :3].T + Ti[:3, 3]).astype(np.float32))
    seq = _chain(pt.ICPSequence(device=CPU), "libpointmatcher_tpu_torch", BENCH)
    seq.set_map(pt.PointCloud.from_numpy(pts, device=CPU), seed=0)
    clouds = [pt.PointCloud.from_numpy(s, device=CPU) for s in scans]
    outs = _each_upload(monkeypatch,
                        lambda: register_batch_to_map(seq, clouds, seed=3))
    assert "motion_bound_exceeded" in outs[0][1]
    _assert_equal_runs(outs)


# ----------------------------------------------------------- PMTPU_CACHE_DIR
_LOAD = textwrap.dedent("""
    import subprocess, sys
    from libpointmatcher_tpu_torch.io import native
    if sys.argv[1] == "load":
        def refuse(*a, **k):
            raise AssertionError("rebuilt: " + str(a[0]))
        subprocess.run = refuse
    assert native.available()
    print(native._so_path())
""")


def _native(mode, cache, tmp_path):
    env = dict(os.environ, PMTPU_CACHE_DIR=str(cache), TMPDIR=str(tmp_path))
    env.pop("PMTPU_NO_NATIVE", None)
    out = subprocess.run([sys.executable, "-c", _LOAD, mode], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr
    return Path(out.stdout.strip())


def test_cache_dir_holds_the_native_library(tmp_path):
    """A fresh ``PMTPU_CACHE_DIR`` (created if missing) receives the native
    library; a second process loads it from there without running g++."""
    cache = tmp_path / "cache" / "libs"
    built = _native("build", cache, tmp_path)
    assert built.parent == cache and built.exists()
    mtime = built.stat().st_mtime_ns
    assert _native("load", cache, tmp_path) == built
    assert built.stat().st_mtime_ns == mtime
    assert [p.name for p in cache.iterdir()] == [built.name]


def test_cache_dir_names_the_kernel_libraries(monkeypatch, tmp_path):
    """The CUDA libraries build into and load from the same directory;
    unset, ``.torch_ext_build/`` beside the package."""
    monkeypatch.delenv("PMTPU_CACHE_DIR", raising=False)
    assert kc.LIBRARY.path().parent == REPO / ".torch_ext_build"
    monkeypatch.setenv("PMTPU_CACHE_DIR", str(tmp_path))
    assert cuda_build.build_dir() == tmp_path
    path = kc.LIBRARY.path()
    assert path.parent == tmp_path and path.name.startswith("libpm_knn_")
