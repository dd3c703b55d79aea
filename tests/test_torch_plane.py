"""The point-to-plane kernel pair's plain version and its route
(``libpointmatcher_tpu_torch/ops/plane_cuda.py``), on the CPU.

- The torch Jacobi (:func:`plane_cuda.eigh_jacobi`) is the JAX package's
  ``utils/smalleig.py::eigh_jacobi``: the same rounds in the same order, so
  its eigenvalues lie within 1e-6 × max|w| of JAX's (the two round the
  matrix products of a round differently), and its solve within 2e-6 ×
  ‖x‖∞ of JAX's and of the float64 minimal-norm solution, at full rank and
  singular (measured: under 5e-7).
- The plain version (the minimizer's torch body with the Jacobi solve)
  against ``PointToPlaneErrorMinimizer.compute`` on the CPU
  (``torch.linalg.eigh``): integer statistics and the used ratio equal,
  poses within 2e-5 × ‖x‖∞ + 4e-7 (ROADMAP Queue 3 #40 found the two
  eigensolvers within 7e-6 × ‖x‖∞; 4e-7 covers float32 rounding of the
  rotation's entries near 1), on one scan, a batch, a pair axis, k = 3,
  a scan with no valid pair and rank-deficient scenes (a floor, a
  corridor) whose dropped eigenvalues lie far under the cutoff.
- The predicate that picks the kernel: CUDA, 3-D, six degrees of freedom,
  not WithCov; a reference laid out over a mesh takes the kernel with a
  table of its pairs' rows a scan, which gives the single-device result
  bit for bit (here with a stand-in for the mesh's gather; the real one in
  ``tests/test_torch_sharding.py``).
- ``minimize_kernel_share`` at ``detail``: 0.0 a step on the CPU path,
  1.0 a step with the route forced onto the plain version, whose serving
  results agree with the CPU path's and which counts no host sync.
"""

from __future__ import annotations

import sys
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpointmatcher_tpu import minimizers as jmin
from libpointmatcher_tpu.utils.smalleig import eigh_jacobi as jax_eigh_jacobi

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.cloud import PointCloud
from libpointmatcher_tpu_torch.matchers import Matches
from libpointmatcher_tpu_torch.minimizers import (
    PointToPlaneErrorMinimizer, PointToPlaneWithCovErrorMinimizer)
from libpointmatcher_tpu_torch.ops import plane_cuda as pc
from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.utils import se3
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
from plane_micro import make_scene  # noqa: E402

P = 6


def _system(seed: int, singular: bool):
    """A = FᵀF and b = Fᵀr in float32 at a point-to-plane scale (the
    translation columns 5x the rotation ones); singular: two equal columns."""
    rng = np.random.default_rng(seed)
    F = rng.normal(size=(300, P)).astype(np.float32) * np.float32([1, 1, 1, 5, 5, 5])
    if singular:
        F[:, 5] = F[:, 4]
    return ((F.T @ F).astype(np.float32),
            (F.T @ rng.normal(size=300)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("singular", [False, True])
def test_jacobi_matches_jax_and_float64(seed, singular):
    A, b = _system(seed, singular)
    w, V = pc.eigh_jacobi(torch.as_tensor(A)[None])
    wj, Vj = map(np.asarray, jax_eigh_jacobi(jnp.asarray(A)))
    scale_w = np.abs(wj).max()
    np.testing.assert_allclose(w[0].numpy(), wj, rtol=0, atol=1e-6 * scale_w)
    recon = (V[0].double() * w[0].double()) @ V[0].double().T
    np.testing.assert_allclose(recon.numpy(), A, rtol=0, atol=1e-5 * scale_w)
    x = pc.solve_jacobi(torch.as_tensor(A)[None], torch.as_tensor(b)[None])[0]
    x_jax = np.asarray(jmin.solve_possibly_underdetermined(jnp.asarray(A),
                                                           jnp.asarray(b)))
    x64 = np.linalg.pinv(A.astype(np.float64), rcond=P * 1e-7) @ b
    scale = np.abs(x64).max()
    np.testing.assert_allclose(x.numpy(), x_jax, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(x.numpy(), x64, rtol=0, atol=2e-6 * scale)
    if singular:
        # minimal norm: nothing along the null direction e4 − e5
        assert abs(float(x[4] - x[5])) < 2e-6 * scale


def test_jacobi_cutoff_drops_what_jax_drops():
    """An eigenvalue just under the cutoff is dropped, one just over kept,
    as in the JAX package's solve."""
    rng = np.random.default_rng(3)
    Q, _ = np.linalg.qr(rng.normal(size=(P, P)))
    b = rng.normal(size=P).astype(np.float32)
    for factor, kept in ((0.5, False), (2.0, True)):
        w = np.array([factor * P * 1e-7, 0.3, 0.5, 0.7, 0.9, 1.0])
        A = (Q @ np.diag(w) @ Q.T).astype(np.float32)
        x = pc.solve_jacobi(torch.as_tensor(A)[None], torch.as_tensor(b)[None])[0]
        x_jax = np.asarray(jmin.solve_possibly_underdetermined(
            jnp.asarray(A), jnp.asarray(b)))
        along = [abs(float(Q[:, 0] @ v)) for v in (x.numpy(), x_jax)]
        assert all((a > 1e3) == kept for a in along), along


def test_jacobi_of_zeros_and_nan():
    """A system of zeros solves to 0; a NaN one to a non-finite x, read
    nowhere (the JAX package's Jacobi gives the same)."""
    A = torch.zeros(2, 6, 6)
    b = torch.zeros(2, 6)
    A[1, 2, 3] = A[1, 3, 2] = float("nan")
    b[1, 2] = float("nan")
    x = pc.solve_jacobi(A, b)
    assert torch.equal(x[0], torch.zeros(6))
    assert not torch.isfinite(x[1]).all()


def _plain(reading, reference, weights, matches):
    return pc.point_to_plane(reading.points, reading.mask, reference.points,
                             reference.get_descriptor("normals"), matches.dists,
                             matches.ids, weights)


def _x(T):
    """[rotation vector, translation] of ``T`` in float64."""
    T = T.double()
    return torch.cat([se3.log_rotation(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def _assert_poses_close(T, T_ref, rel):
    x, x_ref = _x(T), _x(T_ref)
    scale = x_ref.abs().amax(dim=-1, keepdim=True)
    assert torch.all((x - x_ref).abs() <= rel * scale + 4e-7), (
        float(((x - x_ref).abs() / scale).max()))


CASES = {
    "batch": {},
    "one_scan": {"B": 1},
    "pair_axis": {"pair": True},
    "k3": {"k": 3},
    "floor": {"shape": "floor"},
    "corridor": {"shape": "corridor"},
    "floor_rotated": {"shape": "floor", "rotate": True},
    "corridor_rotated": {"shape": "corridor", "rotate": True},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_the_cpu_minimizer(case):
    kw = CASES[case]
    reading, reference, weights, matches = make_scene(7, "cpu", **kw)
    if case == "one_scan":
        reading = PointCloud(reading.points[0], reading.mask[0])
        weights = weights[0]
        matches = Matches(matches.dists[0], matches.ids[0])
    T, st = PointToPlaneErrorMinimizer().compute(reading, reference, weights,
                                                 matches)
    out = _plain(reading, reference, weights, matches)
    assert out.T.shape == T.shape and out.residual.shape == st.residual.shape
    _assert_poses_close(out.T, T, 2e-5)
    assert torch.equal(out.point_used_ratio, st.point_used_ratio)
    assert torch.equal(out.rejected_matches, st.nb_rejected_matches)
    assert torch.equal(out.rejected_points, st.nb_rejected_points)
    torch.testing.assert_close(out.weighted_point_used_ratio,
                               st.weighted_point_used_ratio, rtol=1e-6, atol=0)
    torch.testing.assert_close(out.residual, st.residual, rtol=1e-5, atol=0)
    x = _x(out.T)
    if kw.get("shape") == "floor" and not kw.get("rotate"):
        # minimal norm: no rotation about the floor's normal, no move in it
        assert torch.all(x[..., [2, 3, 4]].abs() < 1e-6)
    if kw.get("shape") == "corridor" and not kw.get("rotate"):
        assert torch.all(x[..., 3].abs() < 1e-6)


def test_scan_without_a_valid_pair_is_the_identity():
    reading, reference, weights, matches = make_scene(2, "cpu", B=2)
    d = matches.dists.clone()
    d[1] = float("inf")
    w = weights.clone()
    w[0] = 0.0
    out = _plain(reading, reference, w, Matches(d, matches.ids))
    assert torch.equal(out.T, torch.eye(4).expand(2, 4, 4))
    assert torch.equal(out.residual, torch.zeros(2))
    assert torch.equal(out.point_used_ratio, torch.zeros(2))
    assert torch.equal(out.weighted_point_used_ratio, torch.zeros(2))
    finite = torch.isfinite(matches.dists[0]).sum()
    assert out.rejected_matches.tolist() == [int(finite), 0]
    assert out.rejected_points.tolist() == reading.mask.sum(-1).tolist()


def test_wrapper_refuses_mismatched_shapes():
    reading, reference, weights, matches = make_scene(3, "cpu", B=2)
    with pytest.raises(ValueError):
        pc.point_to_plane(reading.points, reading.mask, reference.points,
                          reference.get_descriptor("normals"), matches.dists,
                          matches.ids, weights[:1])
    with pytest.raises(ValueError):
        pc.point_to_plane(reading.points, reading.mask,
                          reference.points[None].expand(3, -1, -1),
                          reference.get_descriptor("normals")[None].expand(3, -1, -1),
                          matches.dists, matches.ids, weights)


def _stub(device="cuda", dim=3):
    return SimpleNamespace(device=torch.device(device), dim=dim)


@pytest.mark.parametrize("params,reading,want", [
    ({}, _stub(), True),
    ({}, _stub("cpu"), False),
    ({}, _stub(dim=2), False),
    ({"force2D": "1"}, _stub(), False),
    ({"force4DOF": "1"}, _stub(), False),
])
def test_kernel_path_predicate(params, reading, want):
    assert PointToPlaneErrorMinimizer(params)._kernel_path(reading) is want


def test_kernel_path_refuses_withcov():
    assert not PointToPlaneWithCovErrorMinimizer()._kernel_path(_stub())


class _OneRankMesh:
    """A reference laid out over a mesh of one rank: its own rows, a
    ``mesh``, and the mesh's gather (here plain indexing)."""

    def __init__(self, cloud):
        self.cloud, self.mesh = cloud, object()
        self.points = cloud.points
        self.gathers = 0

    def get_descriptor(self, name):
        return self.cloud.get_descriptor(name)

    def gather(self, table, ids):
        self.gathers += 1
        return table[ids]


@pytest.mark.parametrize("case", ["batch", "one_scan", "k3"])
def test_kernel_route_on_a_mesh_equals_single_device(case):
    """The kernel route against a reference laid out over a mesh (its pairs'
    map rows and normals gathered, read at slot ids 0..n·k−1) gives the
    single-device route's transforms and statistics bit for bit."""
    reading, reference, weights, matches = make_scene(8, "cpu", **CASES[case])
    if case == "one_scan":
        reading = PointCloud(reading.points[0], reading.mask[0])
        weights = weights[0]
        matches = Matches(matches.dists[0], matches.ids[0])
    m = PointToPlaneErrorMinimizer()
    meshed = _OneRankMesh(reference)
    got = m._kernel(reading, meshed, weights, matches)
    want = m._kernel(reading, reference, weights, matches)
    assert meshed.gathers == 2
    for a, b in zip((got[0], *got[1]), (want[0], *want[1])):
        if a is None:
            assert b is None
        else:
            assert a.shape == b.shape and torch.equal(a, b)


ITERS = 3


def _room_cloud(rng, n):
    u, v = rng.uniform(0, 1, (2, n))
    k = rng.integers(0, 4, n)
    pts = np.where(k[:, None] == 0, np.stack([3 * u, 2 * v, 0 * u], 1),
                   np.where(k[:, None] == 1, np.stack([3 * u, 0 * u, 1.5 * v], 1),
                            np.where(k[:, None] == 2,
                                     np.stack([0 * u, 2 * u, 1.5 * v], 1),
                                     np.stack([1 + 0.4 * u, 1 + 0.4 * v,
                                               0.5 + 0 * u], 1))))
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def serving_scene():
    rng = np.random.default_rng(25)
    world = _room_cloud(rng, 3000)
    scans = []
    for i in range(4):
        c, s = np.cos(0.02 * i), np.sin(0.02 * i)
        R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        rows = world[rng.choice(len(world), 500, replace=False)]
        scans.append(((rows - np.float32([0.03, -0.02, 0.01])) @ R).astype(np.float32))
    return world[:1500], scans


def _serve(scene, forced, monkeypatch):
    ref, scans = scene
    if forced:
        monkeypatch.setattr(PointToPlaneErrorMinimizer, "_kernel_path",
                            lambda self, reading: True)
    seq = pt.ICPSequence(device="cpu")
    seq.set_default()
    seq.checkers = [CounterTransformationChecker({"maxIterationCount": str(ITERS)})]
    seq.set_map(PointCloud.from_numpy(ref, device="cpu"), seed=5)
    telemetry.reset()
    clouds = [PointCloud.from_numpy(s, device="cpu") for s in scans]
    out = [register_batch_to_map(seq, clouds[:2], seed=3),
           register_queue_to_map(seq, clouds, seed=3, lanes=2)]
    recs = telemetry.snapshot()
    monkeypatch.undo()
    return out, recs


def test_minimize_kernel_share_and_route(serving_scene, monkeypatch,
                                         detail_telemetry):
    """At ``detail``, one share value a step: 0.0 on the CPU path, 1.0 with
    the route forced onto the kernel's plain version. The forced route
    serves the same iterations and poses within the solvers' tolerance, and
    counts one host sync a step fewer (no eigh flag read)."""
    kept, recs_kept = _serve(serving_scene, False, monkeypatch)
    forced, recs_forced = _serve(serving_scene, True, monkeypatch)
    for rk, rf in zip(recs_kept, recs_forced):
        steps = rk["counters"]["steps"]
        assert rk["counters"]["minimize_kernel_share"] == [0.0] * steps
        assert rf["counters"]["minimize_kernel_share"] == [1.0] * steps
        assert rf["counters"]["host_syncs"] == rk["counters"]["host_syncs"] - steps
    for (Tk, ik), (Tf, if_) in zip(kept, forced):
        np.testing.assert_array_equal(if_["iterations"], ik["iterations"])
        np.testing.assert_allclose(Tf, Tk, rtol=0, atol=1e-5)


def test_minimize_kernel_share_absent_at_spans(serving_scene, monkeypatch):
    telemetry.set_level("spans")
    _, recs = _serve(serving_scene, True, monkeypatch)
    assert all("minimize_kernel_share" not in r["counters"] for r in recs)
