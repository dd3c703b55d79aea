"""The port's single-device pose graph against the JAX package's, on the
CPU: ``log_rotation`` (near 0, in the middle, near π), the residual, one
Gauss-Newton step and the whole ``optimize_pose_graph`` (K = 6 poses, the
odometry chain and one loop closure, 10 Gauss-Newton steps of 30 CG
iterations each), unweighted and with [C] and [C, 6] weights; and
``edges_from_numpy``.

Tolerances: refined rotations within 1e-4, translations within 1e-4 × the
trajectory's extent, the residual norm within 1e-4 relative. Both sides run
float32; JAX differentiates through the residual inside each product, the
port takes the Jacobian's 6x6 blocks once per step, so the products round
differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libpointmatcher_tpu.parallel import posegraph as jpg
from libpointmatcher_tpu.utils import se3 as jse3

from libpointmatcher_tpu_torch.parallel import posegraph as tpg
from libpointmatcher_tpu_torch.utils import se3 as tse3

K = 6


def _rotz(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def graph():
    """Ground truth on an arc, noisy relative measurements of the chain
    and of the loop closure 0 → K-1, and drifted initial poses."""
    rng = np.random.default_rng(3)
    gt = []
    for k in range(K):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rotz(0.1 * k)
        T[:3, 3] = [0.5 * k, 0.2 * k, 0.02 * k]
        gt.append(T)
    ii = list(range(K - 1)) + [0]
    jj = list(range(1, K)) + [K - 1]
    meas = []
    for a, b in zip(ii, jj):
        M = np.linalg.inv(gt[a]) @ gt[b]
        M[:3, :3] = M[:3, :3] @ _rotz(rng.normal(scale=0.005))
        M[:3, 3] += rng.normal(scale=0.01, size=3)
        meas.append(M.astype(np.float32))
    noisy = [gt[0]]
    for k in range(1, K):
        P = gt[k].copy()
        P[:3, :3] = P[:3, :3] @ _rotz(rng.normal(scale=0.03))
        P[:3, 3] += rng.normal(scale=0.05, size=3)
        noisy.append(P)
    extent = float(np.linalg.norm(gt[-1][:3, 3] - gt[0][:3, 3]))
    weights = {"none": None,
               "per_edge": rng.uniform(0.5, 2.0, len(ii)).astype(np.float32),
               "per_component": rng.uniform(0.5, 2.0, (len(ii), 6)).astype(np.float32)}
    return ii, jj, np.stack(meas), np.stack(noisy).astype(np.float32), extent, weights


def _edges(graph, weight):
    ii, jj, meas, _, _, weights = graph
    w = weights[weight]
    return (jpg.edges_from_numpy(ii, jj, meas, w),
            tpg.edges_from_numpy(ii, jj, meas, w, device="cpu"))


@pytest.mark.parametrize("angle", [0.0, 1e-7, 1e-4, 0.3, 2.0, 3.1])
def test_log_rotation_equals_jax(angle):
    rng = np.random.default_rng(int(angle * 1000))
    axis = rng.normal(size=3)
    omega = (angle * axis / np.linalg.norm(axis)).astype(np.float32)
    R = np.array(jse3.rodrigues(jnp.asarray(omega)))
    want = np.asarray(jse3.log_rotation(jnp.asarray(R)))
    got = tse3.log_rotation(torch.from_numpy(R)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-6)
    np.testing.assert_allclose(got, omega, atol=1e-3)
    # batched
    Rb = torch.from_numpy(np.stack([R, np.eye(3, dtype=np.float32)]))
    np.testing.assert_allclose(tse3.log_rotation(Rb).numpy()[0], got, atol=0)


@pytest.mark.parametrize("weight", ["none", "per_edge", "per_component"])
def test_residual_equals_jax(graph, weight):
    noisy = graph[3]
    ej, et = _edges(graph, weight)
    want = np.asarray(jpg.relative_pose_residual(jnp.asarray(noisy), ej))
    got = tpg.relative_pose_residual(torch.from_numpy(noisy), et).numpy()
    assert got.shape == (K, 6)
    np.testing.assert_allclose(got, want, atol=1e-6)


def _check_poses(got, want, extent):
    got = got.numpy()
    want = np.asarray(want)
    np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], atol=1e-4 * extent)


@pytest.mark.parametrize("weight", ["none", "per_edge", "per_component"])
@pytest.mark.parametrize("gn_iters", [1, 10])
def test_optimize_equals_jax(graph, weight, gn_iters):
    """One Gauss-Newton step and the whole solve."""
    noisy, extent = graph[3], graph[4]
    ej, et = _edges(graph, weight)
    Pj, rj = jpg.optimize_pose_graph(noisy, ej, gn_iters=gn_iters, cg_iters=30)
    Pt, rt = tpg.optimize_pose_graph(noisy, et, gn_iters=gn_iters, cg_iters=30)
    assert Pt.shape == (K, 4, 4) and Pt.dtype == torch.float32
    _check_poses(Pt, Pj, extent)
    np.testing.assert_array_equal(Pt[0].numpy(), noisy[0])   # the gauge
    np.testing.assert_allclose(float(rt), float(rj), rtol=1e-4, atol=1e-7)
    r0 = float(tpg.relative_pose_residual(torch.from_numpy(noisy), et).norm())
    assert float(rt) < r0


@pytest.mark.parametrize("weight", ["none", "per_edge", "per_component"])
def test_edges_from_numpy(graph, weight):
    ii, jj, meas, _, _, weights = graph
    ej, et = _edges(graph, weight)
    assert et.i.dtype == torch.int64 and et.j.dtype == torch.int64
    assert et.T_meas.dtype == torch.float32 and et.T_meas.shape == (K, 4, 4)
    for a, b in zip(et, ej):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    want_shape = {"none": (K,), "per_edge": (K,), "per_component": (K, 6)}[weight]
    assert tuple(et.weight.shape) == want_shape
    if weight == "none":
        assert bool((et.weight == 1).all())
    assert all(t.device.type == "cpu" for t in et)
