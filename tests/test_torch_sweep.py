"""The port's survivor sweep (libpointmatcher_tpu_torch.ops.sweep,
ops.sweep_cuda, ops.morton and the stateful KDTreeMatcher) against the JAX
package's ops/knn_sweep2.py and ops/knn_skip.py, whose Pallas kernels run in
interpret mode on the CPU as tests/test_knn_sweep2.py runs them.

Tolerances: Morton orders, tables and survival flags are compared exactly.
The bounds agree within 2 ulp (both round the same operations in the same
order; the JAX interpreter may contract a multiply-add). Distances of the
exact sweep agree within rtol 1e-6, atol 1e-7, and ids wherever the
neighbour is unique by more than that: the Pallas sweep breaks ties by
lane, the port by lowest index (ROADMAP Queue 3).

The same kernels on the card are tested in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu.ops.knn_skip as ks
import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.cloud import PointCloud
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.ops import morton, sweep
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(k2.pl, "pallas_call", patched)


def _cloudlike(n=900, m=1400, seed=0, scale=1.0):
    """A dense core and a sparse periphery, as a scan against a map."""
    rng = np.random.default_rng(seed)
    core = rng.normal(size=(n * 3 // 4, 3)) * 0.7
    peri = rng.uniform(-8, 8, size=(n - len(core), 3))
    q = (np.concatenate([core, peri]) * scale).astype(np.float32)
    rcore = rng.normal(size=(m * 3 // 4, 3)) * 0.7 + 0.05
    rperi = rng.uniform(-8, 8, size=(m - len(rcore), 3))
    r = (np.concatenate([rcore, rperi]) * scale).astype(np.float32)
    qm = rng.random(n) < 0.8
    rm = rng.random(m) < 0.95
    return q, qm, r, rm


def _sorted(q, qm, r, rm):
    """Morton-sorted queries and map (the JAX host order), and the tables."""
    ro, _ = ks.morton_argsort(r, rm)
    qo, _ = ks.morton_argsort(q, qm)
    rs, rsm = r[ro], rm[ro]
    return (q[qo], qm[qo], rs, rsm, k2.chunked_ref_table(rs, rsm),
            k2.chunk_summaries(rs, rsm))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _unique(qs, qsm, rs, rsm, tol):
    """Valid queries whose nearest neighbour is closer than the second by
    more than ``tol``, with the exact float32 d² of both."""
    d, _ = knn_brute_force(*_t(qs, qsm, rs, rsm), k=2)
    d = d.numpy()
    with np.errstate(invalid="ignore"):
        return qsm & np.isfinite(d[:, 0]) & (d[:, 1] - d[:, 0] > tol)


@pytest.mark.parametrize("case", ["masked", "all_masked", "flat", "two_dim"])
def test_morton_orders_match_jax(case):
    rng = np.random.default_rng(1)
    d = 2 if case == "two_dim" else 3
    pts = rng.normal(size=(3, 500, d)).astype(np.float32)
    mask = rng.random((3, 500)) < 0.7
    if case == "all_masked":
        mask[1] = False
    if case == "flat":
        pts[..., -1] = 0.25                     # zero span on one axis
        pts[2, :40] = pts[2, 40]                # equal codes: stable ties
    want = ks.morton_argsort_batch(pts, mask)
    np.testing.assert_array_equal(morton.morton_argsort_batch(pts, mask), want)
    for i in range(3):
        order, inv = morton.morton_argsort(pts[i], mask[i])
        np.testing.assert_array_equal(order, want[i])
        np.testing.assert_array_equal(order[inv], np.arange(500))
        dev = morton.morton_argsort_device(*_t(pts[i], mask[i])).numpy()
        np.testing.assert_array_equal(dev, want[i])
        np.testing.assert_array_equal(
            dev, np.asarray(ks.morton_argsort_device(jnp.asarray(pts[i]),
                                                     jnp.asarray(mask[i]))))


@pytest.mark.parametrize("case", ["masked", "empty_chunks", "ragged", "two_dim"])
def test_tables_match_jax(case):
    q, qm, r, rm = _cloudlike(seed=2)
    n = {"ragged": 1001}.get(case, 1400)
    r, rm = r[:n], rm[:n].copy()
    if case == "empty_chunks":
        rm[256:512] = False                     # chunks 2 and 3 hold no point
    if case == "two_dim":
        r = r[:, :2].copy()
    rs, rsm = _sorted(q, qm, r, rm)[2:4]
    ct = sweep.chunk_summaries(rs, rsm)
    np.testing.assert_array_equal(ct, k2.chunk_summaries(rs, rsm))
    np.testing.assert_array_equal(sweep.chunked_ref_table(rs, rsm),
                                  k2.chunked_ref_table(rs, rsm))
    if case == "empty_chunks":
        # the Morton sort puts the masked rows last: trailing empty chunks
        empty = ct[6] == 0
        assert empty.sum() > ct.shape[1] - 1400 // 128
        assert np.all(ct[:6, empty] == np.float32(sweep.FAR))


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("warm", [False, True])
def test_k2_plain_matches_pallas(k, warm):
    qs, qsm, rs, rsm, rt3, ct = _sorted(*_cloudlike(seed=3))
    ub_t = np.full(len(qs), np.inf, np.float32)
    if warm:        # a transported bound: a random real point's distance
        pick = rs[np.random.default_rng(4).integers(0, len(rs), len(qs))]
        ub_t = (np.sqrt(((qs - pick) ** 2).sum(1)) * sweep.UP).astype(np.float32)
    qp = sweep.query_table(*_t(qs, qsm, ub_t))
    ub, surv = sc.survivors_and_bounds(qp, torch.from_numpy(ct), k)
    ubj, survj = k2.survivors_and_bounds(jnp.asarray(qp.numpy()),
                                         jnp.asarray(ct), tile_q=256, k=k)
    ubj, survj = np.asarray(ubj), np.asarray(survj)
    np.testing.assert_array_equal(surv.numpy(), survj)
    # the serving path cuts the padding chunks: the same bounds and flags
    ubc, survc = sc.survivors_and_bounds(qp, torch.from_numpy(ct), k,
                                         nch=rt3.shape[0])
    assert rt3.shape[0] < ct.shape[1]
    assert torch.equal(ubc, ub) and torch.equal(survc, surv)
    ub = ub.numpy()
    assert np.all(np.abs(ub - ubj) <= 2 * np.spacing(np.abs(ubj)))
    # every valid query's true k nearest rows lie in surviving chunks
    d2 = ((qs[:, None].astype(np.float64) - rs[None].astype(np.float64)) ** 2
          ).sum(-1)
    d2[:, ~rsm] = np.inf
    near = np.argsort(d2, axis=1)[:, :k]
    for qi in np.flatnonzero(qsm):
        assert surv.numpy()[qi // 256, near[qi] // 128].all(), qi


@pytest.mark.parametrize("stream", [False, True])
def test_k3_k4_plain_match_pallas(stream):
    qs, qsm, rs, rsm, rt3, ct = _sorted(*_cloudlike(seed=5, m=2000))
    qp = sweep.query_table(*_t(qs, qsm, np.full(len(qs), np.inf, np.float32)))
    _, surv = k2.survivors_and_bounds(jnp.asarray(qp.numpy()), jnp.asarray(ct))
    surv = np.asarray(surv).reshape(-1, 4, surv.shape[1]).max(axis=1)
    jfn = k2.nn1_survivor_sweep_stream if stream else k2.nn1_survivor_sweep
    dj, ij = map(np.asarray, jfn(jnp.asarray(qp.numpy()), jnp.asarray(rt3),
                                 jnp.asarray(surv), tile_q=1024))
    fn = sc.nn1_survivor_sweep_stream if stream else sc.nn1_survivor_sweep
    dt, it = (x.numpy() for x in fn(qp, *_t(rt3, surv)))
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    n = len(qs)
    uniq = _unique(qs, qsm, rs, rsm, RTOL * np.abs(dj[:n][qsm]).max() + ATOL)
    np.testing.assert_array_equal(it[:n][uniq], ij[:n][uniq])
    # padding tiles keep no chunk: (+inf, 0)
    assert np.all(np.isinf(dt[-1024:])) and np.all(it[-1024:] == 0)


@pytest.mark.parametrize("seed,scale", [(0, 1.0), (7, 50.0)])
def test_nn1_sorted_v2_matches_jax_and_brute_force(seed, scale, detail_telemetry):
    qs, qsm, rs, rsm, rt3, ct = _sorted(*_cloudlike(seed=seed, scale=scale))
    tq, tqm, trs, trsm, trt3, tct = _t(qs, qsm, rs, rsm, rt3, ct)
    db, ib = (x.numpy()[:, 0] for x in knn_brute_force(tq, tqm, trs, trsm, k=1))
    tol = RTOL * np.abs(db[qsm]).max() + ATOL
    uniq = _unique(qs, qsm, rs, rsm, tol)
    ub = np.full(len(qs), np.inf, np.float32)
    for it in range(2):                        # cold, then transported
        with telemetry.call("nn1_sorted_v2"):
            d, i = sweep.nn1_sorted_v2(tq, tqm, torch.from_numpy(ub), trt3, tct)
        frac = detail_telemetry("survivor_share")[-1]
        dj, ij, fj = k2.nn1_sorted_v2(*map(jnp.asarray, (qs, qsm, ub, rt3, ct)))
        d, i = d.numpy(), i.numpy()
        np.testing.assert_array_equal(d, db)
        np.testing.assert_array_equal(i, ib)
        np.testing.assert_allclose(d, np.asarray(dj), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(i[uniq], np.asarray(ij)[uniq])
        assert np.all(i[~qsm] == -1) and np.all(np.isinf(d[~qsm]))
        # the same chunks in the same tiles: JAX divides by its own count
        assert float(frac) == pytest.approx(float(fj))
        if it == 0:
            frac0 = float(frac)
            ub = np.where(qsm, np.sqrt(d) * sweep.UP, np.inf).astype(np.float32)
    assert float(frac) <= frac0 < 0.9


@pytest.mark.parametrize("stream", [False, True])
def test_stateful_matcher_matches_dense_on_sorted_map(monkeypatch, stream,
                                                      detail_telemetry):
    """Two scans in one batch, a cold and a warm iteration: the survivor
    route gives the dense route's matches on the sorted map."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    if stream:
        monkeypatch.setattr(sweep, "SKIP_MAX_MPAD", 512)
    q, qm, r, rm = _cloudlike(seed=9, m=2000)
    q2, qm2 = _cloudlike(seed=10)[:2]
    mat = KDTreeMatcher()
    ref = PointCloud(*_t(r, rm))
    assert mat.serving_loop_aux(ref)
    assert mat._skip_stream == stream
    ref_sorted = mat.serving_reference(ref)
    assert ref_sorted is not ref
    rows = []
    for pts, mask in ((q, qm), (q2, qm2)):
        o = morton.morton_argsort_device(*_t(pts, mask))
        rows.append((torch.from_numpy(pts)[o], torch.from_numpy(mask)[o]))
    reading = PointCloud(torch.stack([p for p, _ in rows]),
                         torch.stack([m for _, m in rows]))
    aux = mat.serving_aux()
    state = mat.loop_state_init(reading, aux)
    for shift in (0.0, 0.03):
        moved = reading.replace(points=reading.points + shift)
        with telemetry.call("find_closests_in_stateful"):
            got, state = mat.find_closests_in_stateful(moved, ref_sorted, aux,
                                                       state)
        want = mat.find_closests_in(moved, ref_sorted)
        assert torch.equal(got.dists, want.dists)
        assert torch.equal(got.ids, want.ids)
    shares = [r["counters"]["survivor_share"] for r in telemetry.snapshot()]
    assert len(shares) == 2 and all(len(s) == 1 for s in shares)
    assert np.shape(shares[1][0]) == (2,)
