"""Pair-parallel one-shot ICP: the port's ``register_batch`` against the JAX
package's on the CPU, default chain, with the JAX draws fed to the port's
filters; one pair against ``ICP.compute``; and the dense kernels' pair axis
(K1, K9 and K5 take ``[B, N, d]`` queries against ``[B, M, d]``
references) against per-pair searches.

Held equal per pair: iteration count and stop code; within tolerance: the
pose, 1e-4 on rotation entries and 1e-4 × the scene extent on translation
(the two frameworks sum the normal equations in another order). The pair
axis of the kernels' plain versions is held bit for bit.
"""

import jax
import numpy as np
import pytest
import torch
from test_torch_batch import _room, _yaw_pose

import libpointmatcher_tpu as pm
from libpointmatcher_tpu.cloud import bucket_size
from libpointmatcher_tpu.parallel import register_batch as jax_register_batch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops.dispatch import MXU_EPSILON_FLOOR, knn_search
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force
from libpointmatcher_tpu_torch.parallel import register_batch

CPU = "cpu"
SEED = 4
REF_ROWS = (3000, 2600, 3400)
READ_ROWS = (1000, 900, 1100)


@pytest.fixture(scope="module")
def pairs():
    """Three pairs, each reading displaced from its own reference by a
    known pose (reference ≈ T · reading), of different row counts."""
    rng = np.random.default_rng(1)
    world = _room(rng, 9000)
    refs, reads, poses = [], [], []
    for i, (m, n) in enumerate(zip(REF_ROWS, READ_ROWS)):
        refs.append(world[rng.choice(len(world), m, replace=False)]
                    .astype(np.float32))
        rows = world[rng.choice(len(world), n, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = _yaw_pose(0.02 * (i - 1), [0.05, 0.03 - 0.02 * i, -0.02])
        reads.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return reads, refs, poses, extent


def _pair_draws(seed, rows, stream):
    """The JAX per-pair path's draws: pair i's reading chain takes key
    fold_in(PRNGKey(seed), 2i), its reference chain 2i + 1, and the first
    filter folds 0, over the cloud's bucketed rows; one row per pair."""
    width = max(bucket_size(n) for n in rows)
    out = np.zeros((len(rows), width), np.float32)
    for i, n in enumerate(rows):
        key = jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(seed), 2 * i + stream), 0)
        out[i, :bucket_size(n)] = np.asarray(
            jax.random.uniform(key, (bucket_size(n),)))
    return out


def _port_icp():
    icp = pt.ICP(device=CPU)
    icp.set_default()
    return icp


def test_register_batch_matches_jax(pairs):
    reads, refs, poses, extent = pairs
    inits = [(_yaw_pose(0.01, [0.02, 0.0, 0.01]) @ T).astype(np.float32)
             for T in poses]
    icp = pm.ICP()
    icp.set_default()
    Tj, ij = jax_register_batch(icp, [pm.PointCloud.from_numpy(r) for r in reads],
                                [pm.PointCloud.from_numpy(r) for r in refs],
                                T_inits=inits, seed=SEED)
    ti = _port_icp()
    ti.reading_filters[0].uniform = _pair_draws(SEED, READ_ROWS, 0)
    ti.reference_filters[0].uniform = _pair_draws(SEED, REF_ROWS, 1)
    Tt, it = register_batch(ti, [pt.PointCloud.from_numpy(r, device=CPU)
                                 for r in reads],
                            [pt.PointCloud.from_numpy(r, device=CPU)
                             for r in refs], T_inits=inits, seed=SEED)
    assert set(ij) <= set(it)
    np.testing.assert_array_equal(it["iterations"], ij["iterations"])
    np.testing.assert_array_equal(it["codes"], ij["codes"])
    np.testing.assert_allclose(it["point_used_ratio"], ij["point_used_ratio"],
                               rtol=1e-5)
    np.testing.assert_allclose(Tt[:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(Tt[:, :3, 3], Tj[:, :3, 3], atol=1e-4 * extent)
    for T, gT in zip(Tt, poses):
        np.testing.assert_allclose(T, gT, atol=0.02)


def test_one_pair_is_icp_compute(pairs):
    """One pair through the lockstep loop gives what ICP.compute gives on
    the same draws."""
    reads, refs, poses, _ = pairs
    rng = np.random.default_rng(2)
    u_read = rng.random(len(reads[0])).astype(np.float32)
    u_ref = rng.random(len(refs[0])).astype(np.float32)
    outs = []
    for batched in (False, True):
        icp = _port_icp()
        icp.reading_filters[0].uniform = u_read
        icp.reference_filters[0].uniform = u_ref
        read = pt.PointCloud.from_numpy(reads[0], device=CPU)
        ref = pt.PointCloud.from_numpy(refs[0], device=CPU)
        if batched:
            T, info = register_batch(icp, [read], [ref])
            outs.append((T[0], int(info["iterations"][0]), int(info["codes"][0])))
        else:
            T = icp(read, ref).numpy()
            outs.append((T, icp.last_iteration_count, icp.last_code))
    (T1, it1, c1), (T2, it2, c2) = outs
    assert (it1, c1) == (it2, c2)
    np.testing.assert_allclose(T2, T1, atol=1e-6)
    np.testing.assert_allclose(T1, poses[0], atol=0.02)


def test_register_batch_refuses_unpaired_inputs(pairs):
    reads, refs, _, _ = pairs
    clouds = [pt.PointCloud.from_numpy(r, device=CPU) for r in reads]
    with pytest.raises(ValueError, match="as many"):
        register_batch(_port_icp(), clouds, clouds[:2])
    icp = _port_icp()
    icp.reading_filters[0].uniform = np.ones((3, 1100), np.float32)
    with pytest.raises(pt.ConvergenceError):
        register_batch(icp, clouds, [pt.PointCloud.from_numpy(r, device=CPU)
                                     for r in refs])


@pytest.mark.parametrize("k", [1, 3])
def test_pair_axis_equals_per_pair_search(k):
    """Three pairs of 500 queries against references of 700 rows (masks of
    their own), with exact duplicates for ties: the batched plain search,
    the kernels' wrappers and the dispatcher give each pair's own search."""
    rng = np.random.default_rng(k)
    q = rng.uniform(-3, 3, (3, 500, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, (3, 700, 3)).astype(np.float32)
    r[:, 1::2] = r[:, ::2]
    qm = rng.random((3, 500)) < 0.9
    rm = rng.random((3, 700)) < 0.9
    rm[2] = False                                   # a pair with no reference
    q, qm, r, rm = map(torch.from_numpy, (q, qm, r, rm))
    want = [knn_brute_force(q[b], qm[b], r[b], rm[b], k=k) for b in range(3)]
    want_d = torch.stack([w[0] for w in want])
    want_i = torch.stack([w[1] for w in want])
    for d, i in (knn_brute_force(q, qm, r, rm, k=k),
                 knn_search(q, qm, r, rm, k=k)):
        assert d.shape == (3, 500, k)
        assert torch.equal(d, want_d) and torch.equal(i, want_i)
    if k == 1:
        d, i = kc.knn1(q, qm, r, rm)
        assert torch.equal(d, want_d[..., 0]) and torch.equal(i, want_i[..., 0])
        d9, _ = knn_search(q, qm, r, rm, k=1, epsilon=MXU_EPSILON_FLOOR)
        for b in range(3):
            assert torch.equal(d9[b, :, 0], kc.knn1_mxu_plain(q[b], qm[b], r[b],
                                                              rm[b])[0])
    assert bool((want_i[2] == -1).all())
    with pytest.raises(ValueError, match="query sets"):
        kc.knn1(q, qm, r[:2], rm[:2])
