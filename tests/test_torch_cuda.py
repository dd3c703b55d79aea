"""The port on the card: the K1, K9, K5, K2, K3, K4, K6, K7, K8, K10, K11,
T1-T5 kernels against their plain versions on CUDA tensors (K1 and K5 with
a pair axis, masked query tails and short references too, K5 at every k;
T1 and T2 against K1 as well), the tile sweep against
dense K1 within maxDist, JAX's threefry draws formed on the card against
the same draws on the CPU, registrations, batch and queue serving (the
tile route too) and pair-parallel one-shot ICP on the card against the same
calls on the CPU, and the v1 skip routes' batch against the survivor
route's. Every test
needs a CUDA device and skips without one. The file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1, K5, K2, K3, K4, K6, K7, K8, K10, K11 and T1-T5 equal their
plain versions bit for bit (the same rounded operations in the same order),
and the draws their CPU counterparts (the same integer operations);
K9 agrees within 2^-20·(q² + r²), its expansion form's rounding bound, and
its excess over the exact neighbour distance stays below MXU_EPSILON_FLOOR.
"""

import numpy as np
import pytest
import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
from libpointmatcher_tpu_torch.filters.normals import SurfaceNormalDataPointsFilter
from libpointmatcher_tpu_torch.ops import (dispatch, skip, skip_cuda, sweep,
                                          tile_cuda, tilesweep)
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force
from libpointmatcher_tpu_torch.ops.morton import morton_argsort
from libpointmatcher_tpu_torch.matchers import (BlockGridMatcher, KDTreeMatcher,
                                                tile_aux_to_device)
from libpointmatcher_tpu_torch.parallel import (register_batch,
                                                register_batch_to_map,
                                                register_queue_to_map)
from libpointmatcher_tpu_torch.parallel.batch import _pad_tile_aux_np
from libpointmatcher_tpu_torch.utils import prng

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


@pytest.mark.parametrize("k", range(2, kc.KNNK_MAX + 1))
def test_k5_every_k_equals_plain(cuda, k):
    """Every K5 list length (k slots up to 16, 32 above) on one shape with
    duplicated rows: ties across groups and chunks."""
    q, qm, r, rm = _inputs(2500, 5003, 7, cuda)
    d, i = kc.knnk(q, qm, r, rm, k)
    dp, ip = knn_brute_force(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)


def _knn(q, qm, r, rm, k):
    if k == 1:
        return tuple(x[..., None] for x in kc.knn1(q, qm, r, rm))
    return kc.knnk(q, qm, r, rm, k)


@pytest.mark.parametrize("n", [255, 257, 511])
@pytest.mark.parametrize("k", [1, 5, 17])
def test_masked_query_tails(cuda, n, k):
    """Queries masked from row 100 on, as the dense batch pads each scan:
    whole warps and blocks of masked queries skip their sweep and still
    give (+inf, -1)."""
    q, qm, r, rm = _inputs(n, 3001, n + k, cuda)
    qm[100:] = False
    d, i = _knn(q, qm, r, rm, k)
    dp, ip = knn_brute_force(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert bool(torch.isinf(d[100:]).all()) and bool((i[100:] == -1).all())


@pytest.mark.parametrize("m", [1, 3, 4, 5, 7, 9])
def test_short_references(cuda, m):
    """References shorter than a group (8 rows) or a float4, or one row
    past a group: the padded rows never win."""
    q, qm, r, rm = _inputs(300, m, m, cuda)
    for k in (1, 2, 5, 17):
        d, i = _knn(q, qm, r, rm, k)
        dp, ip = knn_brute_force(q, qm, r, rm, k=k)
        torch.cuda.synchronize()
        assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_pair_axis_masked_tails(cuda, k):
    """Three pairs whose queries are masked from different rows on: one
    launch equals the single launches and the plain version."""
    pairs = [_inputs(700, 2001, 60 + b, cuda) for b in range(3)]
    for b, p in enumerate(pairs):
        p[1][200 + 200 * b:] = False
    q, qm, r, rm = (torch.stack(x) for x in zip(*pairs))
    d, i = _knn(q, qm, r, rm, k)
    single = [_knn(*p, k) for p in pairs]
    dp, ip = knn_brute_force(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert torch.equal(d, torch.stack([a for a, _ in single]))
    assert torch.equal(i, torch.stack([b for _, b in single]))
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


def _survivor_inputs(seed, n, m, device):
    """Two Morton-sorted scans of clustered queries, a sorted map and its
    tables, every 9th query and 13th map row masked."""
    rng = np.random.default_rng(seed)
    pts = lambda k: np.concatenate([rng.normal(size=(k * 3 // 4, 3)) * 0.7,
                                    rng.uniform(-8, 8, (k - k * 3 // 4, 3))])
    r = pts(m).astype(np.float32)
    rm = np.ones(m, bool)
    rm[::13] = False
    order, _ = morton_argsort(r, rm)
    rs, rsm = r[order], rm[order]
    qs, qms = [], []
    for _ in range(2):
        q = (pts(n) + 0.01).astype(np.float32)
        qm = np.ones(n, bool)
        qm[::9] = False
        o, _ = morton_argsort(q, qm)
        qs.append(q[o])
        qms.append(qm[o])
    t = lambda a: torch.as_tensor(a, device=device)
    return (t(np.stack(qs)), t(np.stack(qms)), t(rs), t(rsm),
            t(sweep.chunked_ref_table(rs, rsm)), t(sweep.chunk_summaries(rs, rsm)))


@pytest.mark.parametrize("k", [1, 2])
def test_k2_k3_k4_equal_plain(cuda, k):
    qs, qm, rs, rsm, rt3, ct = _survivor_inputs(5, 3000, 5000, cuda)
    ub_t = torch.full(qm.shape, float("inf"), device=cuda)
    d_prev = None
    for _ in range(2):                      # cold, then a transported bound
        if d_prev is not None:
            ub_t = (torch.sqrt(d_prev) + 0.01) * sweep.UP
        qp = sweep.query_table(qs, qm, ub_t)
        ub, surv = sc.survivors_and_bounds(qp, ct, k)
        ubp, survp = sc.survivors_and_bounds_plain(qp, ct, k)
        ubc, survc = sc.survivors_and_bounds(qp, ct, k, nch=rt3.shape[0])
        torch.cuda.synchronize()
        assert torch.equal(ub, ubp) and torch.equal(surv, survp)
        assert torch.equal(ubc, ub) and torch.equal(survc, surv)
        _sweeps_equal_plain(qp, rt3, survc)
        d2, ids, _ = sweep.nn1_sorted_v2(qs, qm, ub_t, rt3, ct)
        d1, i1 = kc.knn1(qs.reshape(-1, 3), qm.reshape(-1), rs, rsm)
        assert torch.equal(d2.reshape(-1), d1)
        assert torch.equal(ids.reshape(-1), i1)
        d_prev = torch.where(torch.isfinite(d2), d2, torch.zeros_like(d2))


def _sweeps_equal_plain(qp, rt3, surv, across=True):
    """K3 and K4 at K2's 256-query flags and at their 1024-query fold: each
    equal to the plain version bit for bit, K3 to K4, and (``across``: the
    flags are K2's, not edited) the two folds to each other on the valid
    queries."""
    out = {}
    for flags in (surv, surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)):
        d3, i3 = sc.nn1_survivor_sweep(qp, rt3, flags)
        d4, i4 = sc.nn1_survivor_sweep_stream(qp, rt3, flags)
        dp, ip = sc.survivor_sweep_plain(qp, rt3, flags)
        torch.cuda.synchronize()
        assert torch.equal(d3, dp) and torch.equal(i3, ip)
        assert torch.equal(d4, d3) and torch.equal(i4, i3)
        out[flags.shape[0]] = d3, i3
    (da, ia), (db, ib) = out.values()
    valid = qp[:, 3] == 0
    if across:
        assert torch.equal(da[valid], db[valid])
        assert torch.equal(ia[valid], ib[valid])
    return out[surv.shape[0]]


@pytest.mark.parametrize("case", ["no_survivor", "whole_map", "near_max_chunks",
                                  "duplicated_rows", "all_masked_lane"])
def test_k3_k4_schedule_cases(cuda, case):
    """The new schedule's edges: a tile with no survivor gives (+inf, 0); a
    cold tile whose list is the whole map; a map of nearly MAX_CHUNKS chunks;
    duplicated map rows (ties: the lowest index); a queue's idle lane, all
    masked, whose tiles keep no chunk."""
    rng = np.random.default_rng(30)
    if case == "near_max_chunks":
        m = (sc.MAX_CHUNKS - 3) * 128 - 17
        rs = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
        rsm = np.ones(m, bool)
        rsm[::13] = False
        qs = torch.as_tensor(rng.uniform(-8, 8, (1, 2048, 3)).astype(np.float32),
                             device=cuda)
        qm = torch.ones((1, 2048), dtype=torch.bool, device=cuda)
        rt3 = torch.as_tensor(sweep.chunked_ref_table(rs, rsm), device=cuda)
        qp = sweep.query_table(qs, qm, torch.full(qm.shape, float("inf"),
                                                  device=cuda))
        surv = (torch.rand((8, 128 * -(-rt3.shape[0] // 128)), device=cuda,
                           generator=torch.Generator(cuda).manual_seed(3))
                < 0.03).to(torch.int32)
        surv[:, rt3.shape[0]:] = 0
        d, i = _sweeps_equal_plain(qp, rt3, surv, across=False)
        assert bool(torch.isfinite(d).all())
        return
    qs, qm, rs, rsm, rt3, ct = _survivor_inputs(31, 3000, 5000, cuda)
    if case == "duplicated_rows":
        r = rs.cpu().numpy()
        r[1::2] = r[::2][: len(r[1::2])]
        rs = torch.as_tensor(r, device=cuda)
        rt3 = torch.as_tensor(sweep.chunked_ref_table(r, rsm.cpu().numpy()),
                              device=cuda)
        ct = torch.as_tensor(sweep.chunk_summaries(r, rsm.cpu().numpy()),
                             device=cuda)
    if case == "all_masked_lane":
        qm[1] = False
    qp = sweep.query_table(qs, qm, torch.full(qm.shape, float("inf"), device=cuda))
    _, surv = sc.survivors_and_bounds(qp, ct, nch=rt3.shape[0])
    if case == "no_survivor":
        surv[[0, 5]] = 0
    if case == "whole_map":
        surv[[1, 2], :rt3.shape[0]] = 1
    d, i = _sweeps_equal_plain(qp, rt3, surv, across=case != "no_survivor")
    empty = (surv.sum(dim=1) == 0).repeat_interleave(256)
    assert bool(torch.isinf(d[empty]).all()) and not bool(i[empty].any())
    if case == "no_survivor":
        assert bool(empty[:256].all())
    if case == "all_masked_lane":
        lane = qp.shape[0] // 2
        assert bool(empty[lane:].all())
    if case in ("duplicated_rows", "all_masked_lane"):
        d2, ids, _ = sweep.nn1_sorted_v2(qs, qm, torch.full(qm.shape, float("inf"),
                                                            device=cuda), rt3, ct)
        d1, i1 = kc.knn1(qs.reshape(-1, 3), qm.reshape(-1), rs, rsm)
        assert torch.equal(d2.reshape(-1), d1) and torch.equal(ids.reshape(-1), i1)


def _room(rng, n):
    k = n // 4
    return np.concatenate([
        np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
        np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
    ]).astype(np.float32)


@pytest.mark.parametrize("route", ["dense", "K3", "K4"])
def test_batch_serving_on_card_matches_cpu(cuda, monkeypatch, route):
    """register_batch_to_map of three scans on both devices, fed the same
    draws: iterations and codes equal, poses to float32 summation noise,
    and the launches follow the route."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "0" if route == "dense" else "1")
    if route == "K4":
        monkeypatch.setattr(sweep, "SKIP_MAX_MPAD", 512)
    rng = np.random.default_rng(6)
    world = _room(rng, 8000)
    scans = [world[rng.choice(len(world), 1500, replace=False)]
             + np.float32([0.05, -0.03, 0.02]) for _ in range(3)]
    u_map = rng.random(len(world)).astype(np.float32)
    u_scans = rng.random((3, 1500)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        seq.reference_filters[0].uniform = u_map
        seq.reading_filters[0].uniform = u_scans
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        kc.reset_launch_counts()
        sc.reset_launch_counts()
        T, info = register_batch_to_map(
            seq, [pt.PointCloud.from_numpy(s, device=dev) for s in scans])
        out[dev] = T, info
    (Tc, ic), (Tg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
    np.testing.assert_array_equal(ig["codes"], ic["codes"])
    np.testing.assert_allclose(Tg, Tc, atol=1e-5)
    it = int(ig["iterations"].max())
    launches = (kc.knn1.launches, sc.survivors_and_bounds.launches,
                sc.nn1_survivor_sweep.launches,
                sc.nn1_survivor_sweep_stream.launches)
    assert launches == {"dense": (it, 0, 0, 0), "K3": (0, it, it, 0),
                        "K4": (0, it, 0, it)}[route]


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_equals_plain(cuda, k):
    qs, qm, rs, rsm, rt3, ct = _survivor_inputs(7, 3000, 5000, cuda)
    ub_t = torch.full(qm.shape, float("inf"), device=cuda)
    for _ in range(2):                      # cold, then a transported bound
        qp = sweep.query_table(qs, qm, ub_t)
        _, surv = sc.survivors_and_bounds(qp, ct, k, nch=rt3.shape[0])
        surv = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
        d6, i6 = sc.nnk_survivor_sweep(qp, rt3, surv, k)
        dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
        torch.cuda.synchronize()
        assert torch.equal(d6, dp) and torch.equal(i6, ip)
        dk, ik, _ = sweep.nnk_sorted_v2(qs, qm, ub_t, rt3, ct, k)
        de, ie = kc.knnk(qs.reshape(-1, 3), qm.reshape(-1), rs, rsm, k)
        assert torch.equal(dk.reshape(-1, k), de)
        assert torch.equal(ik.reshape(-1, k), ie)
        fin = torch.isfinite(dk[..., -1])
        ub_t = torch.where(fin, (torch.sqrt(dk[..., -1]) + 0.01) * sweep.UP,
                           torch.full_like(dk[..., -1], float("inf")))


@pytest.mark.parametrize("k", [1, 2, 10])
def test_pair_axis_equals_single_launches(cuda, k):
    pairs = [_inputs(2000, 3001, 20 + b, cuda) for b in range(3)]
    q, qm, r, rm = (torch.stack(x) for x in zip(*pairs))
    if k == 1:
        d, i = kc.knn1(q, qm, r, rm)
        single = [kc.knn1(*p) for p in pairs]
        d, i = d[..., None], i[..., None]
        single = [(a[:, None], b[:, None]) for a, b in single]
    else:
        d, i = kc.knnk(q, qm, r, rm, k)
        single = [kc.knnk(*p, k) for p in pairs]
    dp, ip = knn_brute_force(q, qm, r, rm, k=k)
    torch.cuda.synchronize()
    assert torch.equal(d, torch.stack([a for a, _ in single]))
    assert torch.equal(i, torch.stack([b for _, b in single]))
    assert torch.equal(d, dp) and torch.equal(i, ip)


def _serving_scene(seed, scans=5):
    rng = np.random.default_rng(seed)
    world = _room(rng, 8000)
    clouds = [world[rng.choice(len(world), 1500, replace=False)]
              + np.float32([0.05, -0.03, 0.02]) for _ in range(scans)]
    return (world, clouds, rng.random(len(world)).astype(np.float32),
            rng.random((scans, 1500)).astype(np.float32))


@pytest.mark.parametrize("route,coarse", [("dense", None), ("K3", (4, 16, 1.0)),
                                          ("K6", None), ("K6", (4, 12))])
def test_queue_on_card_matches_cpu(cuda, monkeypatch, route, coarse):
    """register_queue_to_map of five scans through two lanes on both
    devices, fed the same draws: iterations and codes equal, poses to
    float32 summation noise, and the launches follow the route."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "0" if route == "dense" else "1")
    world, scans, u_map, u_scans = _serving_scene(8)
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        if route == "K6":
            seq.matcher = KDTreeMatcher({"knn": "3"})
        seq.reference_filters[0].uniform = u_map
        seq.reading_filters[0].uniform = u_scans
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        kc.reset_launch_counts()
        sc.reset_launch_counts()
        out[dev] = register_queue_to_map(
            seq, [pt.PointCloud.from_numpy(s, device=dev) for s in scans],
            lanes=2, coarse=coarse)
    (Tc, ic), (Tg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
    np.testing.assert_array_equal(ig["codes"], ic["codes"])
    np.testing.assert_allclose(Tg, Tc, atol=1e-5)
    sweeps = {"dense": 0, "K3": sc.nn1_survivor_sweep.launches,
              "K6": sc.nnk_survivor_sweep.launches}[route]
    if route == "dense":
        assert kc.knn1.launches > 0 and sc.survivors_and_bounds.launches == 0
    else:
        assert kc.knn1.launches == kc.knnk.launches == 0
        assert sweeps == sc.survivors_and_bounds.launches > 0


def test_register_batch_on_card_matches_cpu(cuda):
    """Three pairs, each scan against its own reference, on both devices
    fed the same draws; one K1 launch per lockstep iteration on the card."""
    world, scans, _, u_scans = _serving_scene(9, scans=6)
    u_refs = np.random.default_rng(10).random((3, 1500)).astype(np.float32)
    out = {}
    for dev in ("cpu", "cuda"):
        icp = pt.ICP(device=dev)
        icp.set_default()
        icp.reference_filters[0].uniform = u_refs
        icp.reading_filters[0].uniform = u_scans[:3]
        kc.reset_launch_counts()
        out[dev] = register_batch(
            icp, [pt.PointCloud.from_numpy(s, device=dev) for s in scans[:3]],
            [pt.PointCloud.from_numpy(s - np.float32([0.05, -0.03, 0.02]),
                                      device=dev) for s in scans[3:]])
    (Tc, ic), (Tg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
    np.testing.assert_allclose(Tg, Tc, atol=1e-5)
    assert kc.knn1.launches == int(ig["iterations"].max())


def _tile_inputs(seed, T, tq, m, dim, device):
    """Random tiles with ties (every fourth candidate a copy of the one
    before) and a padded tail of candidates (penalty +inf, id −1)."""
    rng = np.random.default_rng(seed)
    q = np.zeros((T, tq, 8), np.float32)
    q[..., :dim] = rng.uniform(-2, 2, (T, tq, dim))
    cand = np.zeros((T, 8, m), np.float32)
    cand[:, :dim] = rng.uniform(-2, 2, (T, dim, m))
    cand[:, :dim, 1::4] = cand[:, :dim, 0::4][..., : cand[:, :, 1::4].shape[2]]
    cand[:, 7] = rng.permutation(T * m).reshape(T, m)
    pad = rng.integers(0, m // 3, T)
    for t in range(T):
        cand[t, 6, m - pad[t]:] = np.inf
        cand[t, 7, m - pad[t]:] = -1
    return torch.as_tensor(q, device=device), torch.as_tensor(cand, device=device)


@pytest.mark.parametrize("T,tq,m,dim", [(37, 64, 1024, 3), (5, 300, 640, 3),
                                        (9, 50, 1152, 2), (3, 8, 128, 3)])
@pytest.mark.parametrize("k", [1, 2, 10, 32])
def test_k7_k8_equal_plain(cuda, T, tq, m, dim, k):
    q, cand = _tile_inputs(T + tq + k, T, tq, m, dim, cuda)
    if k == 1:
        d, i = tile_cuda.tile_sweep(q, cand, dim)
        dp, ip = tile_cuda.tile_sweep_plain(q, cand, dim)
    else:
        d, i = tile_cuda.tile_sweep_k(q, cand, dim, k)
        dp, ip = tile_cuda.tile_sweep_k_plain(q, cand, dim, k)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)


def _terrain(rng, n):
    side = float(np.sqrt(n / 120.0))
    xy = rng.uniform(0, side, (n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(xy[:, 1] * 0.7) + 0.05 * rng.standard_normal(n)
    return np.c_[xy, z].astype(np.float32), side


def test_tile_batch_matches_dense_k1(cuda):
    """One K7 launch over the tiles of two scans in tile order, with maxDist
    applied, against dense K1: equal d² wherever K1's neighbour lies within
    maxDist (the exactness contract, given the motion bound), equal ids
    where it is unique, and +inf beyond."""
    rng = np.random.default_rng(11)
    world, side = _terrain(rng, 20000)
    ref = torch.as_tensor(world, device=cuda)
    refm = torch.ones(len(world), dtype=torch.bool, device=cuda)
    bg = BlockGridMatcher({"maxDist": "0.5", "motionBound": "1.0",
                           "tileQueries": "64", "blockCap": "256"})
    bg.init(pt.PointCloud(ref, refm))
    scans = [world[rng.choice(len(world), 3000, replace=False)]
             + 0.02 * rng.standard_normal((3000, 3)).astype(np.float32)
             for _ in range(2)]
    pers = [bg.prepare_loop_host(s, np.ones(len(s), bool)) for s in scans]
    aux = tile_aux_to_device(_pad_tile_aux_np(pers, bg.units.shape[0] - 1),
                             bg.units)
    q_rows = aux.pop("q_rows").reshape(2, -1)
    qs = torch.stack([torch.as_tensor(s, device=cuda)[r.clamp(min=0)]
                      for s, r in zip(scans, q_rows)])
    qm = q_rows >= 0
    tile_cuda.reset_launch_counts()
    d, i = tilesweep.tile_nn1_from_candidates(qs, qm, None, aux["cand_t"], 0.5,
                                              aux["parent"], aux["vrows"])
    assert tile_cuda.tile_sweep.launches == 1
    d1, i1 = kc.knn1(qs.reshape(-1, 3), qm.reshape(-1), ref, refm)
    d2, _ = kc.knnk(qs.reshape(-1, 3), qm.reshape(-1), ref, refm, 2)
    torch.cuda.synchronize()
    d, i = d.reshape(-1), i.reshape(-1)
    inside = qm.reshape(-1) & (d1 <= float(np.float32(0.5) ** 2))
    assert torch.equal(torch.isfinite(d), inside)
    assert torch.equal(d[inside], d1[inside])
    unique = inside & (d2[:, 1] > d1)
    assert torch.equal(i[unique], i1[unique])
    assert int(unique.sum()) > 5000


@pytest.mark.parametrize("knn", [1, 3])
def test_tile_serving_on_card_matches_cpu(cuda, knn):
    """BlockGridMatcher (knn 1: K7; knn 3: K8) through the batch, the queue
    and one-shot ICP on both devices, fed the same draws: iterations and
    codes equal, poses to float32 summation noise, one tile launch per
    lockstep or lane iteration."""
    rng = np.random.default_rng(12)
    world, side = _terrain(rng, 8000)
    scans = []
    for _ in range(4):
        c = rng.uniform(2.5, side - 2.5, 2)
        ball = world[np.linalg.norm(world[:, :2] - c, axis=1) < 2.5][:2000]
        scans.append(ball + np.float32([0.05, -0.03, 0.02]))
    u_scans = rng.random((4, 2000)).astype(np.float32)
    params = {"maxDist": "0.5", "motionBound": "1.0", "tileQueries": "64",
              "blockCap": "1024", "knn": str(knn)}
    launches = (lambda: tile_cuda.tile_sweep.launches if knn == 1
                else tile_cuda.tile_sweep_k.launches)
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        seq.reference_filters = [SurfaceNormalDataPointsFilter({"knn": "10"})]
        seq.matcher = BlockGridMatcher(params)
        seq.reading_filters[0].uniform = u_scans
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        clouds = [pt.PointCloud.from_numpy(s, device=dev) for s in scans]
        tile_cuda.reset_launch_counts()
        kc.reset_launch_counts()
        out[dev] = [register_batch_to_map(seq, clouds), launches()]
        tile_cuda.reset_launch_counts()
        out[dev] += [register_queue_to_map(seq, clouds, lanes=2), launches()]
        assert kc.knn1.launches == 0
        seq.reading_filters[0].uniform = u_scans[0]
        out[dev].append(seq.compute(clouds[0]).cpu().numpy())
        seq.reading_filters[0].uniform = u_scans
    (bc, _, qc, _, oc), (bg, nb, qg, nq, og) = out["cpu"], out["cuda"]
    for (Tc, ic), (Tg, ig) in ((bc, bg), (qc, qg)):
        np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
        np.testing.assert_array_equal(ig["codes"], ic["codes"])
        np.testing.assert_array_equal(ig["motion_bound_exceeded"],
                                      ic["motion_bound_exceeded"])
        np.testing.assert_allclose(Tg, Tc, atol=1e-5)
    np.testing.assert_allclose(og, oc, atol=1e-5)
    assert nb == int(bg[1]["iterations"].max())
    assert 0 < nq <= int(qg[1]["iterations"].sum())


def test_surface_normal_culled_on_card_matches_cpu(cuda):
    """SurfaceNormal of a 70 000-point terrain, above CULL_MIN_POINTS: one
    K8 launch (and K5 for the rows the tile sweep cannot resolve), normals
    equal to the CPU's up to sign, the k-NN ids equal."""
    world, _ = _terrain(np.random.default_rng(13), 70000)
    out = {}
    for dev in ("cpu", "cuda"):
        tile_cuda.reset_launch_counts()
        f = SurfaceNormalDataPointsFilter({"knn": "10", "keepMatchedIds": "1"})
        out[dev] = f.filter(pt.PointCloud.from_numpy(world, device=dev))
    assert tile_cuda.tile_sweep_k.launches == 1
    nc, ng = (out[d].descriptors["normals"].cpu().numpy() for d in ("cpu", "cuda"))
    assert np.all(np.abs(np.sum(nc * ng, axis=1)) >= 1 - 1e-5)
    assert torch.equal(out["cuda"].descriptors["matchedIds"].cpu(),
                       out["cpu"].descriptors["matchedIds"])


def _skip_inputs(seed, n, m, device):
    """Two Morton-sorted scans of clustered queries (every 9th masked), a
    sorted map (every 13th row masked) and the v1 route's tables."""
    qs, qm, rs, rsm, _, _ = _survivor_inputs(seed, n, m, "cpu")
    m_pad = 128 * -(-m // 128)
    rt, rpen = skip.v1_tables(rs.numpy(), rsm.numpy(), m_pad)
    ra, _ = skip.augmented_ref_table(rs.numpy(), rsm.numpy(), m_pad)
    cbox = skip.chunk_bboxes(rs.numpy(), rsm.numpy(), skip_cuda.SUPER)
    t = lambda a: torch.as_tensor(a, device=device)
    return [t(a) for a in (qs, qm, rs, rsm, rt, rpen, ra, cbox)]


@pytest.mark.parametrize("n,m", [(3000, 5000), (300, 700), (1, 128)])
def test_k10_k11_equal_plain(cuda, n, m):
    """K10 and K11 bit for bit against their plain versions, cold and with a
    transported bound; K11 equal to K1 on the sorted map; the bound above
    K1's exact d² on every valid query."""
    qs, qm, rs, rsm, rt, rpen, ra, cbox = _skip_inputs(n + m, n, m, cuda)
    n_pad = -(-n // skip_cuda.TILE_Q) * skip_cuda.TILE_Q
    ub2 = torch.full(qm.shape, float("inf"), device=cuda)
    for _ in range(2):
        qa, q2 = skip.augment_queries(qs, n_pad)
        amin = skip_cuda.approx_min_sorted(qa, ra)
        aminp = skip_cuda.approx_min_sorted_plain(qa, ra)
        flags = skip.build_skip_mask(qs, qm, ub2, cbox)
        d, i = skip_cuda.nn1_sorted_skip(qs, qm, rt, rpen, flags)
        dp, ip = skip_cuda.nn1_sorted_skip_plain(qs, qm, rt, rpen, flags)
        torch.cuda.synchronize()
        assert torch.equal(amin, aminp)
        assert torch.equal(d, dp) and torch.equal(i, ip)
        d1, i1 = kc.knn1(qs.reshape(-1, 3), qm.reshape(-1), rs, rsm)
        assert torch.equal(d.reshape(-1), d1) and torch.equal(i.reshape(-1), i1)
        amin = amin[:, :n]
        bound = amin + skip.bound_margin(q2, amin)
        assert bool((bound[qm] >= d[qm]).all())
        ub2 = (torch.sqrt(d) + 0.01) ** 2 * sweep.UP
        qs = qs + torch.tensor([0.006, -0.006, 0.0048], device=cuda)


@pytest.mark.parametrize("T,tq,m,dim", [(37, 64, 1024, 3), (5, 300, 640, 3),
                                        (9, 50, 1152, 2), (20, 256, 4096, 3)])
def test_t4_t5_equal_plain_and_k7(cuda, T, tq, m, dim):
    q, cand = _tile_inputs(T + tq, T, tq, m, dim, cuda)
    d4 = tile_cuda.tile_min_only(q, cand, dim)
    d5 = tile_cuda.tile_min_one(q, cand, dim)
    dp = tile_cuda.tile_min_plain(q, cand, dim)
    d7, _ = tile_cuda.tile_sweep(q, cand, dim)
    torch.cuda.synchronize()
    assert torch.equal(d4, dp) and torch.equal(d5, dp) and torch.equal(d7, dp)


def test_v1_batch_equals_survivor_route(cuda, monkeypatch):
    """register_batch_to_map on the card under PMTPU_SKIP_V1=1, with and
    without PMTPU_SKIP_MXU_BOUND=1, against the survivor route: per scan
    the same iterations and codes, poses within 1e-6; K11 (and K10) launch
    once per lockstep iteration and no other k-NN kernel does."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    rng = np.random.default_rng(6)
    world = _room(rng, 8000)
    scans = [world[rng.choice(len(world), 1500, replace=False)]
             + np.float32([0.05, -0.03, 0.02]) for _ in range(3)]
    seq = pt.ICPSequence(device="cuda")
    seq.set_default()
    seq.reference_filters[0].uniform = rng.random(len(world)).astype(np.float32)
    seq.reading_filters[0].uniform = rng.random((3, 1500)).astype(np.float32)
    seq.set_map(pt.PointCloud.from_numpy(world, device="cuda"))
    clouds = [pt.PointCloud.from_numpy(s, device="cuda") for s in scans]
    out = {}
    for route, env in (("survivor", {}), ("v1", {"PMTPU_SKIP_V1": "1"}),
                       ("v1_mxu", {"PMTPU_SKIP_V1": "1",
                                   "PMTPU_SKIP_MXU_BOUND": "1"})):
        for k in ("PMTPU_SKIP_V1", "PMTPU_SKIP_MXU_BOUND"):
            monkeypatch.setenv(k, env.get(k, "0"))
        kc.reset_launch_counts()
        sc.reset_launch_counts()
        skip_cuda.reset_launch_counts()
        T, info = register_batch_to_map(seq, clouds)
        it = int(info["iterations"].max())
        launches = (kc.knn1.launches, sc.survivors_and_bounds.launches,
                    sc.nn1_survivor_sweep.launches,
                    skip_cuda.approx_min_sorted.launches,
                    skip_cuda.nn1_sorted_skip.launches)
        assert launches == {"survivor": (0, it, it, 0, 0),
                            "v1": (0, 0, 0, 0, it),
                            "v1_mxu": (0, 0, 0, it, it)}[route]
        out[route] = T, info
    Ts, infos = out["survivor"]
    for route in ("v1", "v1_mxu"):
        T, info = out[route]
        np.testing.assert_array_equal(info["iterations"], infos["iterations"])
        np.testing.assert_array_equal(info["codes"], infos["codes"])
        np.testing.assert_allclose(T, Ts, atol=1e-6)


@pytest.mark.parametrize("n,m,dim", [(3000, 5003, 3), (20480, 12459, 3),
                                     (333, 1234, 2), (1, 1, 3), (0, 7, 3),
                                     (7, 0, 3), (2049, 300, 3)])
def test_t1_t2_t3_equal_plain(cuda, n, m, dim):
    """T1 and T2 equal K1 and their plain version bit for bit, ties
    included; T3 equals its plain version bit for bit."""
    q, qm, r, rm = _inputs(n, m, n + m + dim, cuda)
    q, r = q[:, :dim].contiguous(), r[:, :dim].contiguous()
    d1, i1 = kc.knn1(q, qm, r, rm)
    for fn in (kv.knn1_chunked, kv.knn1_transposed):
        d, i = fn(q, qm, r, rm)
        dp, ip = fn(q.cpu(), qm.cpu(), r.cpu(), rm.cpu())
        torch.cuda.synchronize()
        assert torch.equal(d, d1) and torch.equal(i, i1)
        assert torch.equal(d.cpu(), dp) and torch.equal(i.cpu(), ip)
    d, i = kv.knn1_mxu(q, qm, r, rm)
    dp, ip = kv.knn1_mxu3_plain(q, qm, r, rm)
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)


def test_variant_launch_counts(cuda):
    q, qm, r, rm = _inputs(500, 900, 3, cuda)
    kv.reset_launch_counts()
    for fn in (kv.knn1_chunked, kv.knn1_transposed, kv.knn1_mxu):
        fn(q, qm, r, rm)
        fn(q.cpu(), qm.cpu(), r.cpu(), rm.cpu())
        assert fn.launches == 1


@pytest.mark.parametrize("seed,n", [(0, 1), (3, 20992), (2**33 + 7, 25000)])
def test_draws_on_card_equal_cpu(cuda, seed, n):
    """prng.uniform on the card, one key and eight at once, bit for bit
    against the CPU."""
    keys = [prng.fold_in(prng.fold_in(prng.prng_key(seed), i), 0)
            for i in range(8)]
    for key in keys[:2]:
        assert torch.equal(prng.uniform(key, n, cuda).cpu(),
                           prng.uniform(key, n, "cpu"))
    k0, k1 = (torch.tensor([k[j] for k in keys]) for j in (0, 1))
    u = prng.uniform((k0.to(cuda), k1.to(cuda)), n)
    assert u.device.type == "cuda"
    assert torch.equal(u.cpu(), prng.uniform((k0, k1), n, "cpu"))
