"""The port on the card: the K1, K9, K5, K2, K3, K4, K6, K7, K8, K10, K11,
T1-T5 kernels against their plain versions on CUDA tensors (K1 and K5 with
a pair axis, masked query tails and short references too, K5 at every k;
K7 and K8 in the per-tile form and in the parent form, K8 at every k, with
several virtual tiles a parent, sentinel virtual tiles, masked warps and
``q_rows``, one launch a step; T1 and T2 against K1 as well), the tile
sweep against
dense K1 within maxDist, JAX's threefry draws formed on the card against
the same draws on the CPU, registrations, batch and queue serving (the
tile route too) and pair-parallel one-shot ICP on the card against the same
calls on the CPU, the v1 skip routes' batch against the survivor
route's, the loop modules (outlier filters, minimizers, transformations)
and their YAML chains on the card against the CPU at the tolerances of
tools_torch/loop_modules.py, and the engine features: Anderson acceleration
at a fixed budget (poses within 1e-5), FixStepSampling's masks (equal), the
stepped driver's rows (equal), matches and pose, and ``estimate_overlap``,
each on the card against the CPU on the same inputs; and the data
filters, each on the card against the CPU on the same input at the
tolerances of tools_torch/filter_checks.py, with the sensor chain's queue
against its batch on the card; and IO and the cell-grid matchers: every
loader onto the card (the same arrays as a load onto the CPU), ``cell_knn``
on the card against the CPU (d² bit for bit, ids equal: elementwise
operations in the same order) and KDTreeVarDistMatcher's culled route
against its dense one (K1, K5) on the card; and the applications ``icp``
and ``compute_overlap`` with ``--device cuda`` against ``--device cpu``;
and the multi-device layer: every sharded op and both drivers' mesh
arguments at NCCL world size 1 in this process and on 2 gloo ranks on the
card against the single-device ops (bit for bit; ``register_batch``
within 1e-5), ``gather_rows``' sharded case keeping −0.0 and ±inf.
Every test
needs a CUDA device and skips without one. The file imports neither JAX
nor the JAX package, so it runs on a machine with the card alone:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Tolerances: K1, K5, K2, K3, K4, K6, K7, K8, K10, K11 and T1-T5 equal their
plain versions bit for bit (the same rounded operations in the same order),
and the draws their CPU counterparts (the same integer operations);
K9 agrees within 2^-20·(q² + r²), its expansion form's rounding bound, and
its excess over the exact neighbour distance stays below MXU_EPSILON_FLOOR.
"""

import sys
from pathlib import Path

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

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
import dense_micro  # noqa: E402
import knn_micro  # noqa: E402
import loop_modules  # noqa: E402
import tile_kernel_micro  # noqa: E402
import tile_micro  # noqa: E402
import torch_survivor_emulation as em  # noqa: E402
import torch_skip_emulation as skem  # noqa: E402

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


def _k9_case(case, device, n=3000, m=9001, seed=21):
    """Inputs of one K9 schedule case (numpy, then on ``device``) at K9's own
    chunks for the card (``k9_split``): "masked_blocks", two whole blocks of
    512 queries, a warp's run and one more block all masked but one query;
    "ties", rows repeated within a group, across groups and across the first
    chunk boundary; "negative", 20 queries whose two nearest rows, in the
    first and second chunk, have negative expansion-form d²; "2d"."""
    rng = np.random.default_rng(seed)
    dim = 2 if case == "2d" else 3
    q = rng.uniform(-8, 8, (n, dim)).astype(np.float32)
    r = rng.uniform(-8, 8, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    rm[::7] = False
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    splits, chunk = kc.k9_split(n, m, sms)
    assert splits >= 2
    if case == "masked_blocks":
        qm[512:1536] = False                   # two whole blocks
        qm[1664:1792] = False                  # a warp's 128 queries
        qm[2048:2560] = False                  # a block but one query
        qm[2300] = True
    if case in ("ties", "2d"):
        g = kc.K9_GROUP_ROWS
        r[1::4] = r[0::4][:len(r[1::4])]       # within a group
        r[g + 3:chunk:2 * g] = r[3:chunk - g:2 * g][:len(r[g + 3:chunk:2 * g])]
        w = min(100, chunk)
        r[chunk:chunk + w] = r[chunk - w:chunk]
        rm[chunk:chunk + w] = rm[chunk - w:chunk]
    if case == "negative":
        # twins whose d² in K9's fused arithmetic are both negative, the
        # second's (placed in the second chunk) the more negative
        tq, less, more = knn_micro.negative_twins(rng, 400)
        d9 = lambda a, b: dense_micro.k9_reference(a[None], [True], b[None],
                                                   [True])[0][0]
        fused = lambda a, b: dense_micro._fma32(-2.0, dense_micro._fma32(
            a[2], b[2], dense_micro._fma32(a[1], b[1], a[0] * b[0])),
            ((a[0] * a[0] + a[1] * a[1]) + a[2] * a[2])
            + ((b[0] * b[0] + b[1] * b[1]) + b[2] * b[2]))
        keep = [k for k in range(len(tq))
                if fused(tq[k], more[k]) < fused(tq[k], less[k]) < 0
                and d9(tq[k], more[k]) == 0][:20]
        assert len(keep) == 20 and chunk >= 30
        q[:20] = tq[keep]
        r[10:30], r[chunk + 10:chunk + 30] = less[keep], more[keep]
        rm[10:30] = rm[chunk + 10:chunk + 30] = True
    return [torch.from_numpy(a).to(device) for a in (q, qm, r, rm)], chunk


@pytest.mark.parametrize("case", ["masked_blocks", "ties", "negative", "2d"])
def test_k9_equals_its_reference(cuda, case):
    """K9 equals ``dense_micro.k9_reference`` (its fused arithmetic in
    numpy, the lowest index of the least d², then the clamp) bit for bit:
    masked blocks and warps, ties within a group, across groups and across
    a chunk boundary, two chunks with negative minima, 2-D; and lies within
    2^-20·(q² + r²max) of its plain version."""
    (q, qm, r, rm), chunk = _k9_case(case, cuda)
    d, i = kc.knn1_mxu(q, qm, r, rm)
    dr, ir = dense_micro.k9_reference(*(x.cpu().numpy() for x in (q, qm, r, rm)))
    dp, _ = kc.knn1_mxu_plain(q, qm, r, rm)
    torch.cuda.synchronize()
    assert torch.equal(d.cpu().view(torch.int32), torch.from_numpy(dr).view(torch.int32))
    assert torch.equal(i.cpu(), torch.from_numpy(ir))
    fin = torch.isfinite(dp)
    tol = 2.0 ** -20 * ((q * q).sum(1) + (r[rm] * r[rm]).sum(1).max())
    assert torch.equal(fin, torch.isfinite(d)) and bool(((d - dp).abs() <= tol)[fin].all())
    if case == "masked_blocks":
        assert bool((i[~qm] == -1).all()) and bool(torch.isinf(d[~qm]).all())
        assert int(i[2300]) >= 0
    if case == "negative":     # the later, more negative minimum wins
        assert bool((d[:20] == 0).all())
        assert torch.equal(i[:20].cpu(), torch.arange(chunk + 10, chunk + 30,
                                                      dtype=torch.int32))


def test_k9_pair_axis_equals_single_launches(cuda):
    """Three pairs in one launch (one pair's queries all masked but its
    first warp, one with every reference masked): equal to the single
    launches and to each pair's reference bit for bit."""
    pairs = [_k9_case(c, cuda, 3000, 5003, seed=30 + b)[0]
             for b, c in enumerate(("ties", "masked_blocks", "negative"))]
    pairs[1][1][128:] = False
    pairs[2][3][:] = False
    q, qm, r, rm = (torch.stack(x) for x in zip(*pairs))
    d, i = kc.knn1_mxu(q, qm, r, rm)
    torch.cuda.synchronize()
    for b, p in enumerate(pairs):
        ds, is_ = kc.knn1_mxu(*p)
        dr, ir = dense_micro.k9_reference(*(x.cpu().numpy() for x in p))
        torch.cuda.synchronize()
        assert torch.equal(d[b], ds) and torch.equal(i[b], is_)
        assert torch.equal(ds.cpu().view(torch.int32), torch.from_numpy(dr).view(torch.int32))
        assert torch.equal(is_.cpu(), torch.from_numpy(ir))
    assert bool((i[2] == -1).all())


@pytest.mark.parametrize("case", ["masked_blocks", "ties_across_accumulators"])
def test_t1_cases_equal_k1(cuda, case):
    """T1 at its own chunks (``t1_split``): masked blocks and warps, and
    equal rows in different accumulators (the lower index odd, the higher
    even; and the lower even) resolve to the lowest index; T1 equals K1
    and the plain version bit for bit."""
    rng = np.random.default_rng(40)
    n, m = 3000, 9001
    q = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    r = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
    qm, rm = np.ones(n, bool), np.ones(m, bool)
    rm[::11] = False
    splits, chunk = kv.t1_split(n, m, torch.cuda.get_device_properties(cuda)
                                .multi_processor_count)
    assert splits >= 2
    if case == "masked_blocks":
        qm[512:1536] = False
        qm[1664:1792] = False
        qm[2100] = False
    else:
        r[2::8] = r[1::8][:len(r[2::8])]       # rows 8k + 1 (odd) and 8k + 2
        r[5::8] = r[4::8][:len(r[5::8])]       # rows 8k + 4 (even) and 8k + 5
        r[chunk:chunk + 64] = r[chunk - 64:chunk]
    q, qm, r, rm = (torch.from_numpy(a).to(cuda) for a in (q, qm, r, rm))
    d, i = kv.knn1_chunked(q, qm, r, rm)
    d1, i1 = kc.knn1(q, qm, r, rm)
    dp, ip = knn_brute_force(q.cpu(), qm.cpu(), r.cpu(), rm.cpu(), k=1)
    torch.cuda.synchronize()
    assert torch.equal(d, d1) and torch.equal(i, i1)
    assert torch.equal(d.cpu(), dp[:, 0]) and torch.equal(i.cpu(), ip[:, 0])
    if case != "masked_blocks":        # never the higher of two equal rows
        picked = i[qm].long().cpu()
        twin = (picked - 1).clamp(min=0)
        rc, rmc = r.cpu(), rm.cpu()
        higher = (((picked % 8 == 2) | (picked % 8 == 5)) & rmc[twin]
                  & (rc[twin] == rc[picked]).all(-1))
        assert int((picked % 8 == 2).sum()) > 0 and not bool(higher.any())


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


def _warm_bound(qs, qm, rs, rsm, k):
    """The k-th distance of each query, moved by 1 cm (+inf where masked)."""
    d, _ = kc.knnk(qs.reshape(-1, 3), qm.reshape(-1), rs, rsm, k)
    d = d[:, -1].reshape(qm.shape)
    return torch.where(qm & torch.isfinite(d), (torch.sqrt(d) + 0.01) * sweep.UP,
                       torch.full_like(d, float("inf")))


@pytest.mark.parametrize("case", ["cold", "warm", "margin", "all_padding"])
@pytest.mark.parametrize("k", [1, 3])
def test_k2_cases_equal_plain(cuda, case, k):
    """K2's pruned schedule against its plain version bit for bit: cold (no
    bound, the ring order from the nearest chunk sets it), warm, with two
    tiles placed exactly on the prefilter's boundary
    (``torch_survivor_emulation.margin_rows``), and with warps made wholly
    of padding and of masked rows with real coordinates; and equal to its
    schedule's emulation (``emulate_k2``), which prunes pairs in both
    passes."""
    qs, qm, rs, rsm, rt3, ct = _survivor_inputs(40, 3000, 5000, cuda)
    nch = rt3.shape[0]
    ub_t = (torch.full(qm.shape, float("inf"), device=cuda) if case == "cold"
            else _warm_bound(qs, qm, rs, rsm, k))
    qp = sweep.query_table(qs, qm, ub_t)
    c2 = None
    if case == "margin":
        qp, _, c2 = em.margin_rows(qp, ct, nch, np.random.default_rng(5))
    if case == "all_padding":
        pad = torch.zeros((1024, 8), device=cuda)
        pad[:, 3] = sweep.FAR
        pad[:, 4] = float("inf")
        qp = torch.cat([qp, pad])
        qp[:512, 3] = sweep.FAR                # masked rows, real coordinates
    ub, surv = sc.survivors_and_bounds(qp, ct, k, nch=nch)
    ubp, survp = sc.survivors_and_bounds_plain(qp, ct, k, nch=nch)
    torch.cuda.synchronize()
    assert torch.equal(ub, ubp) and torch.equal(surv, survp)
    # on the card, where torch's square root is correctly rounded too
    ube, surve, counts = em.emulate_k2(qp, ct, k, nch=nch)
    assert torch.equal(ube, ub) and torch.equal(surve, surv)
    assert 0 < counts["pass2"] <= counts["pass2_box"] <= counts["pairs"]
    assert 0 < counts["pass1"] <= counts["pairs"]
    if case == "margin" and k == 1:
        assert int(surv[1, c2]) == 1
    if case == "all_padding":
        assert not bool(surv[:2].any()) and not bool(surv[-4:].any())


def _k6_case(cuda, case, k):
    """Query table, map table and flags of one K6 card case."""
    if case == "long":                       # one list of > 8 x 32 chunks
        rng = np.random.default_rng(41)
        m = 300 * 128 + 57
        r = rng.uniform(-8, 8, (m, 3)).astype(np.float32)
        rm = np.ones(m, bool)
        rm[::11] = False
        rt3 = torch.as_tensor(sweep.chunked_ref_table(r, rm), device=cuda)
        q = torch.as_tensor(rng.uniform(-8, 8, (1, 2048, 3)).astype(np.float32),
                            device=cuda)
        qm = torch.ones((1, 2048), dtype=torch.bool, device=cuda)
        qp = sweep.query_table(q, qm, torch.full(qm.shape, float("inf"),
                                                 device=cuda))
        nch_pad = 128 * -(-rt3.shape[0] // 128)
        surv = torch.zeros((8, nch_pad), dtype=torch.int32, device=cuda)
        surv[3, :rt3.shape[0]] = 1
        surv[5, ::3] = 1
        surv[:, rt3.shape[0]:] = 0
        return qp, rt3, surv
    qs, qm, rs, rsm, rt3, ct = _survivor_inputs(42, 3000, 5000, cuda)
    if case == "duplicated":
        r = rs.cpu().numpy()
        r[1::2] = r[::2][: len(r[1::2])]
        rm = rsm.cpu().numpy()
        rt3 = torch.as_tensor(sweep.chunked_ref_table(r, rm), device=cuda)
        ct = torch.as_tensor(sweep.chunk_summaries(r, rm), device=cuda)
        rs = torch.as_tensor(r, device=cuda)
    qp = sweep.query_table(qs, qm, _warm_bound(qs, qm, rs, rsm, k))
    _, surv = sc.survivors_and_bounds(qp, ct, k, nch=rt3.shape[0])
    if case == "empty":
        surv[[0, 3, 6]] = 0
    return qp, rt3, surv


@pytest.mark.parametrize("case", ["own", "fold", "duplicated", "empty", "long"])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_cases_equal_plain(cuda, case, k):
    """K6 on K3/K4's schedule against its plain version bit for bit at
    K2's own 256-query flags, and (``fold``) on the valid queries against
    the plain version at the 1024-query fold (which the wrapper refuses
    on the card); with duplicated map rows
    (ties: the lower index first), with tiles whose list is empty ((+inf,
    -1) throughout), and with a list longer than 8 segments of 32
    chunks."""
    qp, rt3, surv = _k6_case(cuda, case, k)
    d6, i6 = sc.nnk_survivor_sweep(qp, rt3, surv, k)
    dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
    torch.cuda.synchronize()
    assert torch.equal(d6, dp) and torch.equal(i6, ip)
    if case == "fold":
        fold = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
        with pytest.raises(ValueError, match="surv"):
            sc.nnk_survivor_sweep(qp, rt3, fold, k)  # the kernel takes K2's rows
        d4, i4 = sc.nnk_survivor_sweep_plain(qp, rt3, fold, k)
        valid = qp[:, 3] == 0
        assert torch.equal(d6[valid], d4[valid])
        assert torch.equal(i6[valid], i4[valid])
    empty = (surv.sum(dim=1) == 0).repeat_interleave(sc.SWEEPK_TILE)
    assert bool(torch.isinf(d6[empty]).all()) and bool((i6[empty] == -1).all())
    if case == "empty":
        assert bool(empty[:256].all())
    if case == "long":
        assert int(surv[3].sum()) > 8 * 32
        assert bool(torch.isfinite(d6[3 * 256:4 * 256]).all())


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


@pytest.fixture(scope="module")
def parent_cases():
    """The parent form's inputs of tools_torch/tile_micro.py's cases: the
    ``q_rows`` form and the tile order (a batch of two scans, sentinel
    virtual tiles, masked warps) at TQ 64 and 256, 2-D, and the tie case;
    parents of up to eight virtual tiles, one without a candidate."""
    cases = []
    for dim, tq in ((3, 64), (3, 256), (2, 64)):
        a, b = (tile_micro.make_case("random", dim, tq, seed=s) for s in (0, 1))
        cases += [a["args"], tile_micro.tile_order([a, b])[0]]
    cases.append(tile_micro.make_case("ties")["args"])
    return cases


@pytest.mark.parametrize("k", range(0, 33))
def test_k7_k8_parents_equal_plain(cuda, parent_cases, k):
    """The parent-form K7 (k 0) and K8 (k 1..32) equal their plain versions
    bit for bit, maxDist finite and infinite, one launch a call."""
    for args in parent_cases:
        args = [None if x is None else x.to(cuda) for x in args]
        for md in (float("inf"), 0.6):
            tile_cuda.reset_launch_counts()
            if k == 0:
                d, i = tile_cuda.tile_sweep_parents(*args, md)
                dp, ip = tile_cuda.tile_sweep_parents_plain(*args, md)
            else:
                d, i = tile_cuda.tile_sweep_k_parents(*args, md, k)
                dp, ip = tile_cuda.tile_sweep_k_parents_plain(*args, md, k)
            torch.cuda.synchronize()
            assert torch.equal(d, dp) and torch.equal(i, ip)
            assert (tile_cuda.tile_sweep.launches,
                    tile_cuda.tile_sweep_k.launches) == ((1, 0) if k == 0 else (0, 1))


@pytest.mark.parametrize("teams", [1, 2, 3])
def test_k7_teams_equal_plain(cuda, parent_cases, teams, monkeypatch):
    """K7 with each parent's virtual tiles dealt to 1-3 warps of a block
    (the default is ``tile_cuda.TEAMS``) equals its plain version bit for
    bit."""
    monkeypatch.setattr(tile_cuda, "TEAMS", teams)
    for args in parent_cases:
        args = [None if x is None else x.to(cuda) for x in args]
        d, i = tile_cuda.tile_sweep_parents(*args, 0.6)
        dp, ip = tile_cuda.tile_sweep_parents_plain(*args, 0.6)
        torch.cuda.synchronize()
        assert torch.equal(d, dp) and torch.equal(i, ip)


@pytest.mark.parametrize("k", [1, 3])
def test_tile_step_is_one_launch(cuda, parent_cases, k):
    """``tile_nn1_from_candidates`` / ``tile_knnk_from_candidates`` make one
    kernel launch, and without ``ncols`` (every column swept) give the
    same result."""
    pts, qm, q_rows, cand_t, ncols, vrows = (
        None if x is None else x.to(cuda) for x in parent_cases[1])
    tile_cuda.reset_launch_counts()
    if k == 1:
        out = tilesweep.tile_nn1_from_candidates(pts, qm, None, cand_t, 0.6,
                                                 None, vrows, ncols)
        full = tilesweep.tile_nn1_from_candidates(pts, qm, None, cand_t, 0.6,
                                                  None, vrows)
        assert tile_cuda.tile_sweep.launches == 2
    else:
        out = tilesweep.tile_knnk_from_candidates(pts, qm, None, cand_t, 0.6,
                                                  None, vrows, k, ncols)
        full = tilesweep.tile_knnk_from_candidates(pts, qm, None, cand_t, 0.6,
                                                   None, vrows, k)
        assert tile_cuda.tile_sweep_k.launches == 2
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, full))


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
                                              None, aux["vrows"], aux["ncols"])
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


@pytest.mark.parametrize("offset", [1e3, 1e4])
@pytest.mark.parametrize("n,m", [(3000, 5000), (700, 1000)])
def test_k10_k11_offsets_equal_plain(cuda, n, m, offset):
    """K10 (pruned on its exact lower bound) and K11 bit for bit against
    their plain versions with the scene translated far from the origin,
    where the expansion form cancels hardest: cold, with K10's bound and
    with a transported bound; K10 also equal to its emulation on the card,
    and K11 to its emulation."""
    qs, qm, rs, rsm, _, _, _, _ = _skip_inputs(n + m + 7, n, m, "cpu")
    shift = torch.tensor([offset, -0.7 * offset, 0.3 * offset])
    qs, rs = qs + shift, (rs + shift).numpy()
    m_pad = 128 * -(-m // 128)
    rt, rpen = skip.v1_tables(rs, rsm.numpy(), m_pad)
    ra, _ = skip.augmented_ref_table(rs, rsm.numpy(), m_pad)
    cbox = skip.chunk_bboxes(rs, rsm.numpy(), skip_cuda.SUPER)
    qs, qm, rt, rpen, ra, cbox = (torch.as_tensor(x).to(cuda)
                                  for x in (qs, qm, rt, rpen, ra, cbox))
    n_pad = -(-n // skip_cuda.TILE_Q) * skip_cuda.TILE_Q
    qa, q2 = skip.augment_queries(qs, n_pad)
    amin = skip_cuda.approx_min_sorted(qa, ra)
    torch.cuda.synchronize()
    assert torch.equal(amin, skip_cuda.approx_min_sorted_plain(qa, ra))
    assert torch.equal(amin, skem.emulate_k10(qa, ra)[0])
    amin = amin[:, :n]
    d = None
    for ub2 in (torch.full(qm.shape, float("inf"), device=cuda),
                amin + skip.bound_margin(q2, amin), None):
        if ub2 is None:                     # transported from the last step
            ub2 = (torch.sqrt(d) + 0.01) ** 2 * sweep.UP
        flags = skip.build_skip_mask(qs, qm, ub2, cbox)
        d, i = skip_cuda.nn1_sorted_skip(qs, qm, rt, rpen, flags)
        dp, ip = skip_cuda.nn1_sorted_skip_plain(qs, qm, rt, rpen, flags)
        de, ie, _ = skem.emulate_k11(qs, qm, rt, rpen, flags)
        torch.cuda.synchronize()
        assert torch.equal(d, dp) and torch.equal(i, ip)
        assert torch.equal(d, de) and torch.equal(i, ie)


@pytest.mark.parametrize("T,tq,m,dim", [(37, 64, 1024, 3), (5, 300, 640, 3),
                                        (9, 50, 1152, 2), (20, 256, 4096, 3),
                                        (11, 24, 1001, 3), (6, 20, 30, 2),
                                        (3, 1100, 130, 3), (13, 64, 100, 2),
                                        (17, 5, 4, 3), (4, 40, 4099, 2),
                                        (2, 256, tile_cuda.MIN_ONE_MAX, 3)])
def test_t4_t5_equal_plain_and_k7(cuda, T, tq, m, dim):
    """T4 and T5 equal their plain version and, where K7 takes the table
    (M a multiple of 128), K7's d²: M % 4 != 0 (4-byte copies), M under one
    stage (T4) or one slice's group (T5), T not a multiple of T4's tiles a
    block, TQ under a warp and over one slice (1024), 2-D, M at T5's largest
    list, and each on a table not 16-byte aligned; T5 equals its schedule's
    emulation."""
    q, cand = _tile_inputs(T + tq, T, tq, m, dim, cuda)
    d4 = tile_cuda.tile_min_only(q, cand, dim)
    d5 = tile_cuda.tile_min_one(q, cand, dim)
    dp = tile_cuda.tile_min_plain(q, cand, dim)
    shifted = torch.empty(cand.numel() + 1, device=cuda)[1:].view(cand.shape)
    shifted.copy_(cand)
    d4u = tile_cuda.tile_min_only(q, shifted, dim)
    d5u = tile_cuda.tile_min_one(q, shifted, dim)
    de = tile_kernel_micro.emulate_t5(q, cand, dim)
    torch.cuda.synchronize()
    assert torch.equal(d4, dp) and torch.equal(d5, dp) and torch.equal(d4u, dp)
    assert torch.equal(d5u, dp) and torch.equal(de, dp)
    if m % 128 == 0:
        d7, _ = tile_cuda.tile_sweep(q, cand, dim)
        assert torch.equal(d7, dp)


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


@pytest.mark.parametrize("n,m,dim,edges", [
    (3000, 5003, 3, False), (20480, 12459, 3, False), (333, 1234, 2, False),
    (1, 1, 3, False), (0, 7, 3, False), (7, 0, 3, False), (2049, 300, 3, False),
    (4000, 9000, 3, True), (700, 5000, 2, True), (60000, 7003, 3, True),
    (4000, 9000, 3, "t3"), (700, 5000, 2, "t3"), (20480, 12459, 3, "t3"),
    (3000, 5003, 3, "tiny")])
def test_t1_t2_t3_equal_plain(cuda, n, m, dim, edges):
    """T1 and T2 equal K1 and their plain version bit for bit, ties
    included; T3 equals its plain version and its schedule's emulation bit
    for bit. With ``edges``, at T2's own chunks (``t2_split``, or with "t3"
    T3's, ``t3_split``; several, the last partial): rows at the start of the
    second chunk repeat the first chunk's last rows (ties across a chunk
    boundary) and the third chunk is all masked; with "t3" also queries
    whose two nearest rows, in the first and second chunk, have negative
    expansion-form d², the second's more negative. "tiny": coordinates of
    magnitude below 1e-19 (subnormal products)."""
    q, qm, r, rm = _inputs(n, m, n + m + dim, cuda)
    q, r = q[:, :dim].contiguous(), r[:, :dim].contiguous()
    if edges == "tiny":
        q, r = q * 1e-20, r * 1e-20
    elif edges:
        split = kv.t3_split if edges == "t3" else kv.t2_split
        splits, chunk = split(n, m, kc._sms(q.device))
        assert splits >= 3 and m % chunk
        r[chunk:chunk + 200] = r[chunk - 200:chunk]
        rm[chunk:chunk + 200] = rm[chunk - 200:chunk]
        rm[2 * chunk:3 * chunk] = False
    if edges == "t3" and dim == 3:
        tq, less, more = (torch.as_tensor(a, device=cuda) for a in
                          knn_micro.negative_twins(np.random.default_rng(n), 20))
        q[:20], qm[:20] = tq, True
        r[10:30], rm[10:30] = less, True
        r[chunk + 210:chunk + 230], rm[chunk + 210:chunk + 230] = more, True
    d1, i1 = kc.knn1(q, qm, r, rm)
    for fn in (kv.knn1_chunked, kv.knn1_transposed):
        d, i = fn(q, qm, r, rm)
        dp, ip = fn(q.cpu(), qm.cpu(), r.cpu(), rm.cpu())
        torch.cuda.synchronize()
        assert torch.equal(d, d1) and torch.equal(i, i1)
        assert torch.equal(d.cpu(), dp) and torch.equal(i.cpu(), ip)
    d, i = kv.knn1_mxu(q, qm, r, rm)
    dp, ip = kv.knn1_mxu3_plain(q, qm, r, rm)
    de, ie = knn_micro.emulate_t3(q, qm, r, rm, sms=kc._sms(q.device))
    torch.cuda.synchronize()
    assert torch.equal(d, dp) and torch.equal(i, ip)
    assert torch.equal(de, dp) and torch.equal(ie, ip)
    if edges == "t3" and dim == 3:       # the more negative, later chunk wins
        assert bool((i[:20] == torch.arange(chunk + 210, chunk + 230,
                                            device=cuda)).all())


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


def _loop_scene(seed, scans=3, rows=4000):
    rng = np.random.default_rng(seed)
    world = _room(rng, 20000)
    shift = np.float32([0.05, -0.03, 0.02])
    return world, [world[rng.choice(len(world), rows, replace=False)] + shift
                   for _ in range(scans)]


@pytest.mark.parametrize("layout", ["one", "batch"])
@pytest.mark.parametrize("knn", [1, 3])
def test_loop_modules_on_card_match_cpu(cuda, knn, layout):
    """Every outlier filter, minimizer and transformation at a recorded
    step (one scan through ICPSequence.compute, or three through
    register_batch_to_map) on the card against the same modules on the
    CPU (tools_torch/loop_modules.py: weights equal, Robust within 1e-6
    relative, transforms within 1e-5, covariances within 1e-4)."""
    world, scans = _loop_scene(9)
    seq = pt.ICPSequence(device=cuda)
    seq.load_from_yaml(loop_modules.chain_yaml("cov_median_normal", knn=knn))
    seq.set_map(pt.PointCloud.from_numpy(world, device=cuda))
    clouds = [pt.PointCloud.from_numpy(s, device=cuda) for s in scans]
    run = ((lambda: seq.compute(clouds[0])) if layout == "one"
           else (lambda: register_batch_to_map(seq, clouds)))
    step = loop_modules.record_step(run)
    assert step[2].dists.shape[-1] == knn
    assert step[2].dists.ndim == (2 if layout == "one" else 3)
    records = loop_modules.check_modules(*step, f"knn={knn}", reps=1,
                                         log=lambda msg: None)
    assert len(records) == (len(loop_modules.FILTERS) + len(loop_modules.ROBUST)
                            + len(loop_modules.MINIMIZERS)
                            + len(loop_modules.TRANSFORMATIONS))


@pytest.mark.parametrize("chain", [c for c in loop_modules.CHAINS if c != "default"])
def test_loop_chains_on_card_match_cpu(cuda, chain):
    """Each chain of tools_torch/loop_modules.py at a fixed budget of 6
    iterations (Counter alone, so that no stop threshold meets float32
    noise) through register_batch_to_map of three scans, and the Robust
    chain through register_queue_to_map (2 lanes, so that each lane takes a
    second scan and restarts its Robust state): the card's poses within
    1e-4 of the CPU's (the module-parity rule: six iterations of float32
    noise, each of which may move a pair across the trimming limit), the
    covariances within 1e-4 of their largest entry."""
    world, scans = _loop_scene(10)
    text = loop_modules.chain_yaml(chain, stop=(6, None))
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.load_from_yaml(text)
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        clouds = [pt.PointCloud.from_numpy(s, device=dev) for s in scans]
        T, info = register_batch_to_map(seq, clouds, seed=2)
        cov = (seq.get_covariance() if seq.error_minimizer.PRODUCES_COVARIANCE
               else None)
        Tq = (register_queue_to_map(seq, clouds, seed=2, lanes=2)[0]
              if chain == "p2plane_robust" else None)
        out[dev] = T, info, cov, Tq
    (Tc, ic, cc, qc), (Tg, ig, cg, qg) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
    np.testing.assert_allclose(Tg, Tc, atol=1e-4)
    if cc is not None:
        assert np.abs(cg - cc).max() <= 1e-4 * np.abs(cc).max()
    if qc is not None:
        np.testing.assert_allclose(qg, qc, atol=1e-4)
        np.testing.assert_allclose(qc, Tc, atol=1e-5)


def test_anderson_on_card_matches_cpu(cuda):
    """Anderson acceleration at a fixed budget of 10 iterations (Counter
    alone, so that no stop threshold meets float32 noise): one scan through
    ICPSequence.compute and three through register_batch_to_map, the card's
    poses within 1e-5 of the CPU's."""
    world, scans = _loop_scene(11)
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        seq.acceleration = "anderson"
        seq.checkers = [CounterTransformationChecker({"maxIterationCount": "10"})]
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        clouds = [pt.PointCloud.from_numpy(s, device=dev) for s in scans]
        T1 = seq.compute(clouds[0], seed=2).cpu().numpy()
        out[dev] = (T1,) + register_batch_to_map(seq, clouds, seed=2)
    (T1c, Tc, ic), (T1g, Tg, ig) = out["cpu"], out["cuda"]
    np.testing.assert_array_equal(ig["iterations"], ic["iterations"])
    np.testing.assert_allclose(T1g, T1c, atol=1e-5)
    np.testing.assert_allclose(Tg, Tc, atol=1e-5)


@pytest.mark.parametrize("sched", [(4, 1, 0.5), (25, 1, 1.4)])
def test_fixstep_masks_on_card_match_cpu(cuda, sched):
    """FixStepSampling's ``mask_at_iteration`` on a masked cloud: one scan
    at iterations 0..5 and 700, and a batch at per-scan iterations."""
    from libpointmatcher_tpu_torch.filters import FixStepSamplingDataPointsFilter

    f = FixStepSamplingDataPointsFilter({"startStep": str(sched[0]),
                                         "endStep": str(sched[1]),
                                         "stepMult": str(sched[2])})
    rng = np.random.default_rng(3)
    pts = rng.uniform(-5, 5, (3, 5000, 3)).astype(np.float32)
    mask = rng.uniform(size=(3, 5000)) < 0.8
    iters = np.array([0, 3, 700])
    masks = {}
    for dev in ("cpu", "cuda"):
        c = pt.PointCloud(torch.as_tensor(pts, device=dev),
                          torch.as_tensor(mask, device=dev))
        one = [f.mask_at_iteration(pt.PointCloud(c.points[0], c.mask[0]), i).mask
               for i in list(range(6)) + [700]]
        batch = f.mask_at_iteration(c, torch.as_tensor(iters, device=dev)).mask
        masks[dev] = [m.cpu() for m in one + [batch]]
    for a, b in zip(masks["cuda"], masks["cpu"]):
        assert torch.equal(a, b)


def test_stepped_driver_on_card_matches_cpu(cuda):
    """A RandomSampling step filter (the stepped driver) and an inspector
    that keeps each iteration's host copies: on the card the same rows at
    every iteration (the same draws), the first iteration's matches equal
    to the CPU's where the neighbour is clear (the reading is moved by the
    reference's mean, summed in another order on each device), the same
    iteration count, and the pose within 1e-5."""
    from libpointmatcher_tpu_torch.filters import RandomSamplingDataPointsFilter
    from libpointmatcher_tpu_torch.inspectors import Inspector

    class Keep(Inspector):
        needs_iteration_data = True
        wants_stats = False

        def __init__(self):
            super().__init__()
            self.calls = []

        def dump_iteration(self, iteration, T_iter, reference, reading, matches,
                           outlier_weights, checkers):
            self.calls.append((reading.mask, matches))

    world, scans = _loop_scene(12, scans=1)
    out = {}
    for dev in ("cpu", "cuda"):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        seq.reading_step_filters = [RandomSamplingDataPointsFilter({"prob": "0.5"})]
        seq.inspector = Keep()
        seq.set_map(pt.PointCloud.from_numpy(world, device=dev))
        kc.reset_launch_counts()
        T = seq.compute(pt.PointCloud.from_numpy(scans[0], device=dev),
                        seed=4).cpu().numpy()
        out[dev] = T, seq.last_iteration_count, seq.inspector.calls
        if dev == "cuda":
            assert kc.knn1.launches == seq.last_iteration_count
    (Tc, nc, cc), (Tg, ng, cg) = out["cpu"], out["cuda"]
    assert ng == nc == len(cg)
    for (mg, _), (mc, _) in zip(cg, cc):
        assert torch.equal(mg, mc)
    (dg, ig), (dc, ic) = cg[0][1], cc[0][1]
    ok = torch.isfinite(dc)
    assert torch.equal(torch.isfinite(dg), ok)
    np.testing.assert_allclose(dg[ok].numpy(), dc[ok].numpy(), rtol=1e-4, atol=1e-9)
    assert (ig == ic).float().mean() > 0.999
    np.testing.assert_allclose(Tg, Tc, atol=1e-5)


def test_estimate_overlap_on_card_matches_cpu(cuda):
    """The overlap estimate with ``simpleSensorNoise`` for one scan and a
    batch of three: equal on the card and the CPU, or one pair apart
    where a pair lies at the mean distance plus its noise (the mean is
    summed in another order)."""
    from libpointmatcher_tpu_torch.matchers import Matches
    from libpointmatcher_tpu_torch.minimizers import estimate_overlap

    rng = np.random.default_rng(5)
    ref = rng.uniform(-1, 1, (2000, 3)).astype(np.float32)
    for shape in ((3000,), (3, 3000)):
        pts = (ref[rng.integers(0, 2000, shape)]
               + 0.02 * rng.standard_normal(shape + (3,))).astype(np.float32)
        noise = (0.01 + 0.02 * rng.uniform(size=shape + (1,))).astype(np.float32)
        w = (rng.uniform(size=shape + (1,)) > 0.1).astype(np.float32)
        vals = {}
        for dev in ("cpu", "cuda"):
            t = lambda a: torch.as_tensor(a, device=dev)
            reading = pt.PointCloud(t(pts), None, {"simpleSensorNoise": t(noise)})
            reference = pt.PointCloud(t(ref))
            d, i = knn_brute_force(reading.points.reshape(-1, 3),
                                   reading.mask.reshape(-1), reference.points,
                                   reference.mask, k=1)
            m = Matches(d.reshape(shape + (1,)), i.reshape(shape + (1,)))
            vals[dev] = estimate_overlap(reading, reference, t(w), m,
                                         t(np.zeros(shape[:-1], np.float32))).cpu()
        assert torch.allclose(vals["cuda"], vals["cpu"], rtol=0,
                              atol=1.0 / shape[-1] + 1e-7)


def _filter_scene(n, seed):
    """Planes of a room, 2 mm of noise, a time channel; normals, densities
    and eigenvalues from SurfaceNormal on the CPU."""
    rng = np.random.default_rng(seed)
    k = n // 4
    parts = [np.c_[rng.uniform(0, 5, k), rng.uniform(0, 4, k), np.zeros(k)],
             np.c_[rng.uniform(0, 5, k), np.zeros(k), rng.uniform(0, 3, k)],
             np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 3, k)],
             np.c_[rng.uniform(1, 3, n - 3 * k), rng.uniform(1, 3, n - 3 * k),
                   np.full(n - 3 * k, 0.8)]]
    pts = (np.concatenate(parts) + 0.002 * rng.standard_normal((n, 3))).astype(np.float32)
    times = {"stamps": 10**18 + rng.integers(0, 10**9, n)}
    cloud = pt.PointCloud.from_numpy(pts, device="cpu", times=times)
    sn = SurfaceNormalDataPointsFilter({"knn": "8", "keepDensities": "1",
                                        "keepEigenValues": "1"}).filter(cloud)
    return cloud, sn.with_descriptor(
        "observationDirections", torch.tensor([2.5, 2.0, 1.3]) - sn.points)


FILTER_CASES = [
    ("BoundingBoxDataPointsFilter", {"xMax": "2", "yMax": "2", "zMax": "2"}, "base", {}),
    ("MaxDistDataPointsFilter", {"maxDist": "4"}, "base", {}),
    ("MinDistDataPointsFilter", {"minDist": "2"}, "base", {}),
    ("DistanceLimitDataPointsFilter", {"dim": "1", "dist": "2"}, "base", {}),
    ("MaxQuantileOnAxisDataPointsFilter", {"dim": "2", "ratio": "0.7"}, "base", {}),
    ("RemoveNaNDataPointsFilter", {}, "base", {}),
    ("MaxDensityDataPointsFilter", {"maxDensity": "3000"}, "desc", {}),
    ("MaxPointCountDataPointsFilter", {"maxCount": "2500"}, "base", {}),
    ("ShadowDataPointsFilter", {"eps": "0.2"}, "desc", {}),
    ("CutAtDescriptorThresholdDataPointsFilter",
     {"descName": "densities", "threshold": "3000"}, "desc", {}),
    ("ObservationDirectionDataPointsFilter", {"x": "1", "y": "2"}, "base", {}),
    ("OrientNormalsDataPointsFilter", {}, "desc", {}),
    ("IncidenceAngleDataPointsFilter", {}, "desc", {}),
    ("SphericalityDataPointsFilter", {}, "desc", {}),
    ("VoxelGridDataPointsFilter", {"vSizeX": "0.1", "vSizeY": "0.1", "vSizeZ": "0.1"},
     "desc", {}),
    ("OctreeGridDataPointsFilter", {"maxPointByNode": "8", "samplingMethod": "1"},
     "desc", {}),
    ("OctreeGridDataPointsFilter", {"maxPointByNode": "8", "samplingMethod": "2"},
     "desc", {}),
    ("OctreeGridDataPointsFilter", {"maxPointByNode": "8", "samplingMethod": "3"},
     "desc", {"kept_share": 0.99}),
    ("NormalSpaceDataPointsFilter", {"nbSample": "1000"}, "desc", {}),
    ("CovarianceSamplingDataPointsFilter", {"nbSample": "1000"}, "desc",
     {"kept_share": 0.97}),
    ("ElipsoidsDataPointsFilter", {"keepEigenValues": "1", "keepShapes": "1"}, "desc", {}),
    ("ElipsoidsDataPointsFilter", {"samplingMethod": "1", "keepMeans": "1"}, "desc", {}),
    ("GestaltDataPointsFilter", {"ratio": "0.5", "radius": "0.8"}, "base",
     {"eig_share": 0.9}),
]


@pytest.mark.parametrize("name,params,src,tol", FILTER_CASES)
def test_filters_on_card_match_cpu(cuda, name, params, src, tol):
    import filter_checks
    from libpointmatcher_tpu_torch.filters.base import DataPointsFilterRegistrar

    base, desc = _filter_scene(4000, 3)
    cloud = base if src == "base" else desc
    key = prng.fold_in(prng.prng_key(5), 1)
    create = DataPointsFilterRegistrar.create
    card = create(name, params).filter(cloud.to(cuda), key=key)
    assert card.device.type == "cuda"
    cpu = create(name, params).filter(cloud, key=key)
    filter_checks.compare(card, cpu, **tol)


def test_remove_sensor_bias_on_card_matches_cpu(cuda):
    import filter_checks
    from libpointmatcher_tpu_torch.filters import IncidenceAngleDataPointsFilter
    from libpointmatcher_tpu_torch.filters import RemoveSensorBiasDataPointsFilter

    _, desc = _filter_scene(3000, 4)
    desc = IncidenceAngleDataPointsFilter().filter(desc)
    card = RemoveSensorBiasDataPointsFilter().filter(desc.to(cuda))
    cpu = RemoveSensorBiasDataPointsFilter().filter(desc)
    filter_checks.compare(card, cpu)
    assert torch.equal(card.points.cpu(), cpu.points)   # float64 on the host


def test_sensor_chain_queue_equals_batch_on_card(cuda):
    """The sensor's reading chain is served by the queue, which gives the
    batch's iterations, codes and poses (within 1e-5) on the card."""
    from libpointmatcher_tpu_torch.parallel.stream import queue_eligible

    base, _ = _filter_scene(6000, 6)
    world = base.points.numpy()
    seq = pt.ICPSequence(device=cuda)
    seq.load_from_yaml("""
readingDataPointsFilters:
  - BoundingBoxDataPointsFilter:
      removeInside: 1
      xMin: -0.5
      xMax: 0.5
      yMin: -0.5
      yMax: 0.5
      zMin: -0.5
      zMax: 0.5
  - MaxDistDataPointsFilter:
      maxDist: 6
  - MinDistDataPointsFilter:
      minDist: 0.3
  - RandomSamplingDataPointsFilter:
      prob: 0.5
referenceDataPointsFilters:
  - SamplingSurfaceNormalDataPointsFilter
matcher: KDTreeMatcher
outlierFilters:
  - TrimmedDistOutlierFilter
errorMinimizer: PointToPlaneErrorMinimizer
transformationCheckers:
  - CounterTransformationChecker
  - DifferentialTransformationChecker
""")
    seq.set_map(pt.PointCloud.from_numpy(world, device=cuda), seed=0)
    assert queue_eligible(seq)
    rng = np.random.default_rng(7)
    scans, inits = [], []
    for i in range(6):
        rows = world[rng.choice(len(world), 1500, replace=False)] - [0.5, 0.5, 0.3]
        scans.append(pt.PointCloud.from_numpy(rows.astype(np.float32), device=cuda))
        T = np.eye(4, dtype=np.float32)
        T[:3, 3] = [0.5 + 0.02 * i, 0.5 - 0.01 * i, 0.3]
        inits.append(T)
    Tq, iq = register_queue_to_map(seq, scans, T_inits=inits, seed=2, lanes=4)
    Tb, ib = register_batch_to_map(seq, scans, T_inits=inits, seed=2)
    np.testing.assert_array_equal(iq["iterations"], ib["iterations"])
    np.testing.assert_array_equal(iq["codes"], ib["codes"])
    np.testing.assert_allclose(Tq, Tb, atol=1e-5)


# ------------------------------------------------ IO and the cell-grid search
@pytest.mark.parametrize("ext,binary", [("csv", False), ("vtk", False), ("vtk", True),
                                        ("ply", False), ("ply", True),
                                        ("pcd", False), ("pcd", True)])
def test_loaders_onto_card(cuda, tmp_path, ext, binary):
    """A load onto the card holds the arrays a load onto the CPU holds,
    times included where the format carries them (not PLY)."""
    rng = np.random.default_rng(2)
    n = 2000
    cloud = pt.PointCloud.from_numpy(
        rng.standard_normal((n, 3)), {"normals": rng.standard_normal((n, 3))},
        device="cpu", times={"time": 1_700_000_000_000_000_000 + rng.integers(0, 2 ** 40, n)})
    path = str(tmp_path / f"c.{ext}")
    pt.io.save(cloud, path, binary=binary)
    on_card, on_cpu = pt.io.load(path), pt.io.load(path, device="cpu")
    assert on_card.device.type == "cuda"
    for a, b in zip(on_card.to_numpy(with_times=True), on_cpu.to_numpy(with_times=True)):
        if isinstance(a, dict):
            assert list(a) == list(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    assert ("time" in on_card.times) == (ext != "ply")


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("d", [2, 3])
def test_cell_knn_on_card_equals_cpu(cuda, d, k):
    from libpointmatcher_tpu_torch.ops import cellgrid

    rng = np.random.default_rng(d * 10 + k)
    r = rng.uniform(-4, 4, (5000, d)).astype(np.float32)
    r[1::2] = r[::2][: len(r[1::2])]              # exact duplicates: ties
    rm = np.ones(len(r), bool)
    rm[::7] = False
    q = (r[rng.integers(0, len(r), 3000)] + 0.05 * rng.standard_normal((3000, d))
         ).astype(np.float32)
    qm = np.ones(len(q), bool)
    qm[::11] = False
    out = []
    for dev in (cuda, "cpu"):
        g = cellgrid.build_cell_grid(r, rm, 0.35, device=dev)
        t = lambda a: torch.as_tensor(a, device=dev)
        out.append(cellgrid.cell_knn(t(q), t(qm), t(r), g, 0.35, k=k))
    (dc, ic), (dh, ih) = out
    assert torch.equal(dc.cpu(), dh) and torch.equal(ic.cpu(), ih)
    assert torch.isfinite(dh).float().mean() > 0.3


@pytest.mark.parametrize("knn", [1, 3])
def test_var_dist_routes_equal_on_card(cuda, monkeypatch, knn):
    """KDTreeVarDistMatcher's culled route (the cell grid) and its dense
    route (K1, or K5 for knn 3) give equal matches on the card, and the
    culled route the CPU's."""
    from libpointmatcher_tpu_torch.matchers import KDTreeVarDistMatcher

    monkeypatch.setattr(KDTreeVarDistMatcher, "CULL_MIN_MAP", 1024)
    rng = np.random.default_rng(7)
    ref = rng.uniform(-5, 5, (20000, 3)).astype(np.float32)
    rd = (ref[rng.integers(0, len(ref), 6000)] + 0.05 * rng.standard_normal((6000, 3))
          ).astype(np.float32)
    radius = rng.uniform(0.05, 0.4, len(rd)).astype(np.float32)
    res = {}
    for dev in (cuda, "cpu"):
        a = pt.PointCloud.from_numpy(rd, {"maxSearchDist": radius}, device=dev)
        b = pt.PointCloud.from_numpy(ref, device=dev)
        m = KDTreeVarDistMatcher({"knn": str(knn)})
        m.init(b)
        m.prepare_loop(a)
        assert m._vd_grid is not None
        res[str(dev)] = m.find_closests_in(a, b)
        if dev != "cpu":
            dense = KDTreeVarDistMatcher({"knn": str(knn)})
            dense.init(b, rows=512)
            assert dense._ref_host is None
            res["dense"] = dense.find_closests_in(a, b)
    for key in ("dense", "cpu"):
        assert torch.equal(res["cuda"].dists.cpu(), res[key].dists.cpu()), key
        assert torch.equal(res["cuda"].ids.cpu(), res[key].ids.cpu()), key


# ------------------------------------------------------------- applications
APP_CHAIN = "\n".join([
    "readingDataPointsFilters:\n  - RandomSamplingDataPointsFilter",
    "referenceDataPointsFilters:\n  - SamplingSurfaceNormalDataPointsFilter",
    "matcher: KDTreeMatcher",
    "outlierFilters:\n  - TrimmedDistOutlierFilter",
    "errorMinimizer: PointToPlaneErrorMinimizer",
    "transformationCheckers:\n  - CounterTransformationChecker:\n"
    "      maxIterationCount: 10", ""])


def _app_files(tmp_path):
    """A planar scene as ref.csv, a displaced sample of it as data.csv, and
    a list of both with their poses."""
    rng = np.random.default_rng(5)
    k = 1500
    world = np.concatenate([
        np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
        np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
    ]).astype(np.float32)
    shift = np.float32([0.05, -0.03, 0.02])
    for name, pts in (("ref.csv", world[::2]), ("data.csv", world[1::2] + shift)):
        pt.io.save(pt.PointCloud.from_numpy(pts, device="cpu"), str(tmp_path / name))
    head = ", ".join(f"gT{i}{j}" for i in range(4) for j in range(4))
    T = np.eye(4)
    T[:3, 3] = -shift
    (tmp_path / "list.csv").write_text(
        f"reading, {head}\nref.csv, " + ", ".join(map(str, np.eye(4).ravel()))
        + "\ndata.csv, " + ", ".join(map(str, T.ravel())) + "\n")
    (tmp_path / "chain.yaml").write_text(APP_CHAIN)
    return T


def _app_out(main, argv, cwd, monkeypatch):
    import contextlib
    import io as stdio

    cwd.mkdir()
    monkeypatch.chdir(cwd)
    buf = stdio.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return buf.getvalue()


def test_icp_app_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``apps.icp`` with ``--device cuda`` prints the pose ``--device cpu``
    prints (a fixed budget of 10 iterations; the draws are equal on both
    devices), and K1 ran."""
    import re

    from libpointmatcher_tpu_torch.apps import icp as app

    T = _app_files(tmp_path)
    argv = [str(tmp_path / "ref.csv"), str(tmp_path / "data.csv"), "--config",
            str(tmp_path / "chain.yaml")]
    poses = {}
    for dev in ("cpu", "cuda"):
        kc.reset_launch_counts()
        text = _app_out(app.main, argv + ["--device", dev], tmp_path / dev, monkeypatch)
        assert kc.knn1.launches == (10 if dev == "cuda" else 0)
        nums = re.findall(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?",
                          text.split("Final transformation:")[1])
        poses[dev] = np.array([float(v) for v in nums[:16]]).reshape(4, 4)
    np.testing.assert_allclose(poses["cuda"], poses["cpu"], atol=1e-5)
    np.testing.assert_allclose(poses["cuda"], T, atol=1e-2)


def test_compute_overlap_app_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    """``apps.compute_overlap`` on the card (K1) gives the CPU's matrix,
    within one point of each ratio (the clouds are moved by float32
    products that may round differently on the two devices)."""
    from libpointmatcher_tpu_torch.apps import compute_overlap as app

    _app_files(tmp_path)
    mats = {}
    for dev in ("cpu", "cuda"):
        kc.reset_launch_counts()
        _app_out(app.main, [str(tmp_path / "list.csv"), "--noise", "0.1",
                            "--output", "ov.csv", "--device", dev],
                 tmp_path / dev, monkeypatch)
        assert kc.knn1.launches == (2 if dev == "cuda" else 0)
        mats[dev] = np.loadtxt(tmp_path / dev / "ov.csv", delimiter=",")
    np.testing.assert_allclose(mats["cuda"], mats["cpu"], atol=1 / 3000 + 1e-6)
    assert mats["cpu"][0, 1] > 0.5


# ------------------------------------------------------- multi-device layer
def _same_as_single(got, want, label):
    """Every sharded result against its single-device one: bit for bit
    (bytes: −0.0 is not +0.0), but ``register_batch``'s poses within 1e-5;
    the route counter is the run's own, the padded tables have none."""
    own = ("special_rows", "special_want", "sweep_rt3p", "sweep_ctp")
    for key, v in got.items():
        if key in own or key.endswith("survivor_steps"):
            continue
        if key == "pairs_T":
            np.testing.assert_allclose(v, want[key], rtol=0, atol=1e-5,
                                       err_msg=label)
        else:
            assert v.shape == want[key].shape and v.tobytes() == want[key].tobytes(), \
                f"{label}: {key}"
    assert got["special_rows"].tobytes() == got["special_want"].tobytes(), label


def test_sharded_ops_nccl_world_one_equal_single(cuda, tmp_path):
    """One NCCL rank in this process: every sharded op and driver equals
    the single-device one on the card bit for bit."""
    from datetime import timedelta

    import torch.distributed as dist
    import torch_sharding_worker as w

    from libpointmatcher_tpu_torch.parallel import sharding

    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'store'}",
                            rank=0, world_size=1, timeout=timedelta(seconds=120))
    try:
        got = w.card_cases(sharding.make_mesh(1, device="cuda"),
                           sharding.make_mesh(1, axis_name="pairs",
                                              device="cuda"))
    finally:
        dist.destroy_process_group()
    _same_as_single(got, w.card_single("cuda"), "NCCL world 1")


def test_sharded_ops_gloo_world_two_on_card(cuda, tmp_path):
    """Two gloo ranks on the one card (collectives staged through host
    memory): the same results as the single-device ops on the card."""
    import torch_sharding_worker as w

    w.spawn_ranks(w.card_suite, 2, (2, str(tmp_path / "store"), str(tmp_path),
                                    120.0), timeout_s=300.0)
    got = dict(np.load(tmp_path / "card_2.npz"))
    _same_as_single(got, w.card_single("cuda"), "gloo world 2")


# ------------------------------------------------------- the PMTPU switches
def _switch_sequence(world):
    """A default-chain sequence on the card (its draws from the seeds)."""
    seq = pt.ICPSequence(device="cuda")
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world, device="cuda"))
    return seq


@pytest.mark.parametrize("driver", ["sequence", "batch", "queue"])
def test_mxu_switch_on_card(cuda, monkeypatch, driver):
    """``PMTPU_KNN_IMPL=mxu`` on a dense map: K9 once an iteration (a lane
    iteration for the queue), K1 never, and the poses of the ε = 10 route
    (K9 by ε) bit for bit, on one map (two card ``set_map``s of one cloud
    may part in the last bits, Queue 3 #26)."""
    world, scans, _, _ = _serving_scene(11, scans=4)

    def run(seq):
        kc.reset_launch_counts()
        clouds = [pt.PointCloud.from_numpy(s, device="cuda") for s in scans]
        if driver == "sequence":
            T = [seq.compute(c, seed=i).cpu().numpy() for i, c in enumerate(clouds[:2])]
            return np.stack(T), None
        if driver == "batch":
            return register_batch_to_map(seq, clouds)
        steps = [0]
        step = seq._step

        def counted(*a, **k):
            steps[0] += 1
            return step(*a, **k)

        seq._step = counted
        out = register_queue_to_map(seq, clouds, lanes=2)
        del seq._step
        return out[0], steps[0]

    seq = _switch_sequence(world)
    seq.matcher.epsilon = dispatch.MXU_EPSILON_FLOOR
    want, _ = run(seq)
    seq.matcher.epsilon = 0.0
    monkeypatch.setenv("PMTPU_KNN_IMPL", "mxu")
    if driver == "sequence":
        iters = 0
        kc.reset_launch_counts()
        for i, s in enumerate(scans[:2]):
            T = seq.compute(pt.PointCloud.from_numpy(s, device="cuda"), seed=i)
            assert np.array_equal(T.cpu().numpy(), want[i])
            iters += seq.last_iteration_count
        n = iters
    else:
        T, extra = run(seq)
        assert np.array_equal(T, want)
        n = extra if driver == "queue" else int(extra["iterations"].max())
    assert (kc.knn1.launches, kc.knn1_mxu.launches) == (0, n) and n > 0


def test_chol_solve_on_card_matches_cpu(cuda, monkeypatch):
    """``PMTPU_SOLVE=chol`` set on [8, 6, 6] normal equations: the port
    does not read it (ROADMAP Queue 3 #52), so the card's eigensolve equals
    its own without the switch bit for bit, and the CPU's within 1e-5
    relative (two ``eigh`` implementations)."""
    rng = np.random.default_rng(3)
    F = rng.normal(size=(8, 200, 6)).astype(np.float32)
    A = torch.from_numpy(np.einsum("bni,bnj->bij", F, F).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(8, 6)).astype(np.float32))
    from libpointmatcher_tpu_torch.minimizers import solve_possibly_underdetermined
    want = solve_possibly_underdetermined(A.to(cuda), b.to(cuda)).cpu()
    monkeypatch.setenv("PMTPU_SOLVE", "chol")
    cpu = solve_possibly_underdetermined(A, b)
    card = solve_possibly_underdetermined(A.to(cuda), b.to(cuda)).cpu()
    assert torch.equal(card, want)
    torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-5 * float(cpu.abs().max()))


def test_bisect_select_on_card(cuda, monkeypatch):
    """``PMTPU_SELECT=bisect`` set: the port does not read it (Queue 3
    #53), so the card's select equals its own without the switch bit for
    bit, and the CPU's, ties, ±inf and NaN included (−0 and +0 taken as
    equal, #50)."""
    from libpointmatcher_tpu_torch.utils.masked import masked_quantile

    rng = np.random.default_rng(4)
    v = rng.choice(np.float32([0.0, -0.0, 1.5, -1.5, np.inf, -np.inf, np.nan]),
                   size=(8, 20992)).astype(np.float32)
    v = np.where(rng.random(v.shape) < 0.5, rng.normal(size=v.shape), v)
    t = torch.from_numpy(v.astype(np.float32))
    for q in (0.0, 0.5, 0.75, 1.0):
        sort = masked_quantile(t.to(cuda), q, batch_dims=1).cpu()
        monkeypatch.setenv("PMTPU_SELECT", "bisect")
        got = masked_quantile(t.to(cuda), q, batch_dims=1).cpu()
        cpu = masked_quantile(t, q, batch_dims=1)
        monkeypatch.delenv("PMTPU_SELECT")
        assert got.numpy().tobytes() == sort.numpy().tobytes()
        assert np.array_equal(got.numpy(), cpu.numpy())


def test_stack_numpy_on_card(cuda, monkeypatch):
    """Scans handed in as host clouds are stacked on the host and copied
    once: the card's batch bit for bit equal to the one with each scan
    moved on its own and to the one given card clouds, and unmoved by
    ``PMTPU_STACK_NUMPY=0`` (unread, Queue 3 #49)."""
    from libpointmatcher_tpu_torch.parallel import batch

    world, scans, _, _ = _serving_scene(12, scans=4)
    seq = _switch_sequence(world)
    clouds = [pt.PointCloud.from_numpy(s, device="cpu") for s in scans]
    out = [register_batch_to_map(seq, clouds),
           register_batch_to_map(seq, [c.to(cuda) for c in clouds])]
    monkeypatch.setenv("PMTPU_STACK_NUMPY", "0")
    out.append(register_batch_to_map(seq, clouds))
    monkeypatch.setattr(batch, "_upload",
                        lambda rs, dev: [rd.to(dev) for rd in rs])
    out.append(register_batch_to_map(seq, clouds))
    (T0, i0), *rest = out
    for T, info in rest:
        assert np.array_equal(T0, T)
        assert all(np.array_equal(i0[k], info[k]) for k in i0)


_CACHE_PROBE = """
import subprocess, sys
from libpointmatcher_tpu_torch.ops import knn_cuda
if sys.argv[1] == "load":
    def refuse(*a, **k):
        raise AssertionError("nvcc ran")
    subprocess.run = refuse
knn_cuda.LIBRARY.load()
print(knn_cuda.LIBRARY.path(), bool(knn_cuda.LIBRARY.build_log))
"""


def test_cache_dir_builds_and_reloads_kernels(cuda, tmp_path):
    """``PMTPU_CACHE_DIR``: a process builds ``csrc/knn.cu`` into a fresh
    directory, a second one loads it from there with no nvcc run."""
    import os
    import subprocess

    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PMTPU_CACHE_DIR=str(tmp_path / "libs"),
               PYTHONPATH=str(repo))
    out = []
    for mode in ("build", "load"):
        proc = subprocess.run([sys.executable, "-c", _CACHE_PROBE, mode],
                              cwd=repo, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr
        out.append(proc.stdout.split())
    (path, built), (path2, built2) = out
    assert Path(path).parent == tmp_path / "libs" and path2 == path
    assert (built, built2) == ("True", "False")


@pytest.mark.parametrize("num", [9000, 40])
def test_segment_sums_on_card(cuda, num):
    """``filters/sampling.py::segment_sum`` on the card: segments of at most
    ``ORDERED_MAX_ROWS`` rows add in row order and equal the CPU bit for bit;
    longer ones (``num`` 40: ~500 rows each) take ``index_add_``'s atomic
    order, within 1e-5 of their magnitude."""
    from libpointmatcher_tpu_torch.filters import sampling

    rng = np.random.default_rng(num)
    values = torch.from_numpy((rng.normal(size=(20000, 3)) * 10 + 5).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, num, 20000))
    cpu = sampling.segment_sum(values, seg, num)
    card = sampling.segment_sum(values.to(cuda), seg.to(cuda), num).cpu()
    if int(torch.bincount(seg).max()) <= sampling.ORDERED_MAX_ROWS:
        assert torch.equal(card, cpu)
    else:
        torch.testing.assert_close(card, cpu, rtol=1e-5, atol=1e-5 * float(cpu.abs().max()))


@pytest.mark.parametrize("method", ["0", "1"])
def test_elipsoids_densities_on_card_equal_cpu(cuda, method):
    """Elipsoids' densities, count/((4/3)π·r³) about each box's mean, which
    magnify a mean's last bits, on the card within 1e-6 of the CPU's."""
    rng = np.random.default_rng(5)
    pts = _room(rng, 40000) + 0.003 * rng.standard_normal((40000, 3)).astype(np.float32)
    from libpointmatcher_tpu_torch.filters import ElipsoidsDataPointsFilter

    params = {"samplingMethod": method, "keepDensities": "1"}
    key = prng.fold_in(prng.prng_key(23), 1)
    out = {}
    for dev in ("cpu", "cuda"):
        c = ElipsoidsDataPointsFilter(params).filter(
            pt.PointCloud.from_numpy(pts, device=dev), key=key)
        out[dev] = c.to_numpy()[1]["densities"]
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-6)
