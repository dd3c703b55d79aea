"""The port on the card: the K1, K9 and K5 kernels against their plain
versions on CUDA tensors, and a registration on the card against the same
registration on the CPU. Every test needs a CUDA device and skips without
one. The file imports neither JAX nor the JAX package, so it runs on a
machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1 and K5 equal their plain versions bit for bit (the same
rounded operations in the same order); K9 agrees within 2^-20·(q² + r²),
its expansion form's rounding bound, and its excess over the exact
neighbour distance stays below MXU_EPSILON_FLOOR.
"""

import numpy as np
import pytest
import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.ops import dispatch
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, m, seed, device, all_masked=False):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    r = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    r[1::2] = r[::2][: len(r[1::2])]              # exact duplicates: ties
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::13] = False
    rm[::3] = False
    if all_masked:
        rm[:] = False
    return [torch.from_numpy(a).to(device) for a in (q, qm, r, rm)]


@pytest.mark.parametrize("n,m", [(3000, 5003), (1, 1), (0, 7), (7, 0), (300, 2)])
@pytest.mark.parametrize("k", [1, 2, 10, 32])
def test_k1_k5_equal_plain(cuda, n, m, k):
    q, qm, r, rm = _inputs(n, m, n + m + k, cuda)
    if k == 1:
        d, i = kc.knn1(q, qm, r, rm)
        d, i = d[:, None], i[:, None]
    else:
        d, i = kc.knnk(q, qm, r, rm, k)
    dp, ip = knn_brute_force(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)


def test_all_references_masked(cuda):
    q, qm, r, rm = _inputs(500, 900, 1, cuda, all_masked=True)
    for d, i in (kc.knn1(q, qm, r, rm), kc.knn1_mxu(q, qm, r, rm),
                 kc.knnk(q, qm, r, rm, 5)):
        assert bool(torch.isinf(d).all()) and bool((i == -1).all())


def test_k9_within_bound(cuda):
    q, qm, r, rm = _inputs(4000, 7001, 2, cuda)
    d9, i9 = kc.knn1_mxu(q, qm, r, rm)
    dp, _ = kc.knn1_mxu_plain(q, qm, r, rm)
    d1, _ = kc.knn1(q, qm, r, rm)
    fin = torch.isfinite(dp)
    assert torch.equal(fin, torch.isfinite(d9))
    tol = 2.0 ** -20 * ((q * q).sum(1) + (r[rm] * r[rm]).sum(1).max())
    assert bool(((d9 - dp).abs() <= tol)[fin].all())
    diff = q - r[i9.clamp(min=0).long()]
    dj = (diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1]) + diff[:, 2] * diff[:, 2]
    ok = fin & (d1 > 0)
    assert float((torch.sqrt(dj[ok] / d1[ok]) - 1).max()) < dispatch.MXU_EPSILON_FLOOR


def test_launch_counts(cuda):
    q, qm, r, rm = _inputs(100, 200, 3, cuda)
    kc.reset_launch_counts()
    dispatch.knn_search(q, qm, r, rm, k=1)
    dispatch.knn_search(q, qm, r, rm, k=1, epsilon=dispatch.MXU_EPSILON_FLOOR)
    dispatch.knn_search(q, qm, r, rm, k=4)
    assert (kc.knn1.launches, kc.knn1_mxu.launches, kc.knnk.launches) == (1, 1, 1)


def test_registration_on_card_matches_cpu(cuda):
    """The default chain at a fixed budget on both devices, fed the same
    draws: the poses agree to float32 summation noise."""
    rng = np.random.default_rng(4)
    k = 1500
    world = np.concatenate([
        np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
        np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
    ]).astype(np.float32)
    ref = world[::2]
    read = world[1::2] + np.float32([0.05, -0.03, 0.02])
    u_ref = rng.random(len(ref)).astype(np.float32)
    u_read = rng.random(len(read)).astype(np.float32)
    poses = []
    for dev in ("cpu", "cuda"):
        icp = pt.ICP(device=dev)
        icp.set_default()
        icp.checkers = [CounterTransformationChecker({"maxIterationCount": "10"})]
        icp.reference_filters[0].uniform = u_ref
        icp.reading_filters[0].uniform = u_read
        T = icp(pt.PointCloud.from_numpy(read, device=dev),
                pt.PointCloud.from_numpy(ref, device=dev))
        assert T.device.type == dev and icp.last_iteration_count == 10
        poses.append(T.cpu().numpy())
    np.testing.assert_allclose(poses[1], poses[0], atol=1e-5)
    np.testing.assert_allclose(poses[1][:3, 3], [-0.05, 0.03, -0.02], atol=1e-2)
