"""The knn 2..4 survivor route of the port: K6 (``nnk_survivor_sweep``),
``ops.sweep.nnk_sorted_v2`` and the stateful KDTreeMatcher at knn = 3,
against the JAX package's ops/knn_sweep2.py, whose Pallas kernels run in
interpret mode on the CPU, and against the dense top-k.

Tolerances. The port's d² is ((pen + dx²) + dy²) + dz², each step rounded,
as in K5 and in K6 on the card. The interpret-mode Pallas kernel runs
through XLA's CPU compiler, which contracts each ``d2 + diff * diff`` into
a fused multiply-add, so its d² differs from the port's by up to 2 ulp
(one for each of the two contracted additions). ``test_k6_plain_matches_pallas``
shows the cause: the same d² formed with each step fused equals the
Pallas d² bit for bit, and the unfused d² differs in some slots;
ids agree in every finite slot, ties included (the maps hold exact
duplicate rows): both keep the lower sorted-map index first among equal
distances. Against the port's own dense top-k on the sorted map the route
agrees bit for bit. K2's flags at k = 3 and 4 are compared exactly, its
bounds within 2 ulp, as in tests/test_torch_sweep.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_sweep import _cloudlike, _sorted, _t
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.cloud import PointCloud
from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
from libpointmatcher_tpu_torch.ops import morton, sweep
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(k2.pl, "pallas_call", patched)


def _tied(seed, m=1400, sparse=False):
    """Sorted queries and map, a hundred map rows duplicated exactly (ties).
    With ``sparse`` the map keeps 10 · 128 + 2 valid rows: the Morton sort
    puts masked rows last, so its last valid chunk holds 2 valid rows and
    may not bind the bound of a k > 2 search."""
    q, qm, r, rm = _cloudlike(seed=seed, m=m)
    r[1:200:2] = r[0:200:2]
    if sparse:
        rm = np.zeros(m, bool)
        rm[np.random.default_rng(seed).choice(m, 10 * 128 + 2,
                                              replace=False)] = True
    return _sorted(q, qm, r, rm)


def _warm_bound(qs, rs, rsm, k):
    """A transported bound on the k-th distance: the k-th of k random real
    points, inflated."""
    rng = np.random.default_rng(4)
    valid = rs[rsm]
    pick = valid[rng.integers(0, len(valid), (len(qs), k))]
    d = np.sqrt(((qs[:, None] - pick) ** 2).sum(-1)).max(axis=1)
    return (d * sweep.UP).astype(np.float32)


def _fma_d2(qp, rt3, ids):
    """d² of each query to each of its ids, formed as XLA's CPU compiler
    forms it in the interpret-mode kernel: ``d2 + diff * diff`` as a fused
    multiply-add, rounded once. In float64 diff² is exact and the sum
    rounds once more to float32."""
    q = qp[:, :3].numpy()[:, None, :]
    safe = np.maximum(ids, 0)
    blk = rt3[safe // 128, :, safe % 128]            # [n, k, 8]
    d2 = blk[..., 3].astype(np.float32)
    for c in range(3):
        diff = (q[..., c] - blk[..., c]).astype(np.float64)
        d2 = (d2.astype(np.float64) + diff * diff).astype(np.float32)
    return d2


def _assert_ulp(dt, dj):
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(np.isfinite(dt), fin)
    assert np.all(np.abs(dt[fin] - dj[fin]) <= 2 * np.spacing(np.abs(dj[fin])))


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_plain_matches_pallas(k, warm):
    qs, qsm, rs, rsm, rt3, ct = _tied(seed=5)
    ub_t = (_warm_bound(qs, rs, rsm, k) if warm
            else np.full(len(qs), np.inf, np.float32))
    qp = sweep.query_table(*_t(qs, qsm, ub_t))
    _, surv = k2.survivors_and_bounds(jnp.asarray(qp.numpy()),
                                      jnp.asarray(ct), k=k)
    surv = np.asarray(surv).reshape(-1, 4, surv.shape[1]).max(axis=1)
    dj, ij = map(np.asarray, k2.nnk_survivor_sweep(
        jnp.asarray(qp.numpy()), jnp.asarray(rt3), jnp.asarray(surv),
        tile_q=1024, k=k))
    dt, it = (x.numpy() for x in sc.nnk_survivor_sweep(qp, *_t(rt3, surv), k))
    assert dt.shape == it.shape == (qp.shape[0], k)
    _assert_ulp(dt, dj)
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(it[fin], ij[fin])
    # the 2 ulp are the FMA contraction: fused, the d² is Pallas's bit for bit
    np.testing.assert_array_equal(_fma_d2(qp, rt3, ij)[fin], dj[fin])
    assert np.any(dt[fin] != dj[fin])
    # empty slots and tiles with no survivor: (+inf, -1)
    assert np.all(it[~fin] == -1)
    assert np.all(np.isinf(dt[-1024:])) and np.all(it[-1024:] == -1)
    if warm:
        assert surv.sum() < surv.size / 2


@pytest.mark.parametrize("k", [3, 4])
def test_k2_plain_matches_pallas_on_sparse_chunks(k):
    qs, qsm, rs, rsm, rt3, ct = _tied(seed=6, sparse=True)
    few = (ct[6] > 0) & (ct[6] < k)
    assert few.any()
    for ub_t in (np.full(len(qs), np.inf, np.float32),
                 _warm_bound(qs, rs, rsm, k)):
        qp = sweep.query_table(*_t(qs, qsm, ub_t))
        ub, surv = sc.survivors_and_bounds(qp, torch.from_numpy(ct), k,
                                           nch=rt3.shape[0])
        ubj, survj = map(np.asarray, k2.survivors_and_bounds(
            jnp.asarray(qp.numpy()), jnp.asarray(ct), tile_q=256, k=k))
        np.testing.assert_array_equal(surv.numpy(), survj)
        assert np.all(np.abs(ub.numpy() - ubj) <= 2 * np.spacing(np.abs(ubj)))


@pytest.mark.parametrize("k", [2, 3, 4])
def test_nnk_sorted_v2_matches_jax_and_brute_force(k, detail_telemetry):
    qs, qsm, rs, rsm, rt3, ct = _tied(seed=7, sparse=True)
    tq, tqm, trs, trsm, trt3, tct = _t(qs, qsm, rs, rsm, rt3, ct)
    db, ib = (x.numpy() for x in knn_brute_force(tq, tqm, trs, trsm, k=k))
    ub = np.full(len(qs), np.inf, np.float32)
    for it in range(2):                        # cold, then transported
        with telemetry.call("nnk_sorted_v2"):
            d, i = sweep.nnk_sorted_v2(tq, tqm, torch.from_numpy(ub), trt3,
                                       tct, k)
        frac = detail_telemetry("survivor_share")[-1]
        dj, ij, fj = k2.nnk_sorted_v2(*map(jnp.asarray, (qs, qsm, ub, rt3, ct)),
                                      k=k)
        d, i, dj, ij = d.numpy(), i.numpy(), np.asarray(dj), np.asarray(ij)
        np.testing.assert_array_equal(d, db)
        np.testing.assert_array_equal(i, ib)
        _assert_ulp(d, dj)
        np.testing.assert_array_equal(i, ij)
        assert np.all(i[~qsm] == -1) and np.all(np.isinf(d[~qsm]))
        assert float(frac) == pytest.approx(float(fj))
        if it == 0:
            frac0 = float(frac)
            ub = np.where(qsm, np.sqrt(d[:, -1]) * sweep.UP,
                          np.inf).astype(np.float32)
    assert float(frac) <= frac0


def test_stateful_matcher_knn3_matches_dense_on_sorted_map(monkeypatch,
                                                          detail_telemetry):
    """Two scans in one batch, a cold and a warm iteration: the top-k
    survivor route gives the dense route's matches on the sorted map, and
    carries the third distance as its bound."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "1")
    q, qm, r, rm = _cloudlike(seed=9, m=2000)
    q2, qm2 = _cloudlike(seed=10)[:2]
    mat = KDTreeMatcher({"knn": "3"})
    ref = PointCloud(*_t(r, rm))
    assert mat.serving_loop_aux(ref) and not mat._skip_stream
    ref_sorted = mat.serving_reference(ref)
    rows = []
    for pts, mask in ((q, qm), (q2, qm2)):
        o = morton.morton_argsort_device(*_t(pts, mask))
        rows.append((torch.from_numpy(pts)[o], torch.from_numpy(mask)[o]))
    reading = PointCloud(torch.stack([p for p, _ in rows]),
                         torch.stack([m for _, m in rows]))
    aux = mat.serving_aux()
    state = mat.loop_state_init(reading, aux)
    assert bool(torch.isinf(state[1]).all())
    for shift in (0.0, 0.03):
        moved = reading.replace(points=reading.points + shift)
        with telemetry.call("find_closests_in_stateful"):
            got, state = mat.find_closests_in_stateful(moved, ref_sorted, aux,
                                                       state)
        want = mat.find_closests_in(moved, ref_sorted)
        assert got.dists.shape == (2, q.shape[0], 3)
        assert torch.equal(got.dists, want.dists)
        assert torch.equal(got.ids, want.ids)
        assert torch.equal(state[1], got.dists[..., -1])
    shares = [r["counters"]["survivor_share"] for r in telemetry.snapshot()]
    assert len(shares) == 2 and all(np.shape(s) == (1, 2) for s in shares)


@pytest.mark.parametrize("case", ["auto", "knn5", "streaming"])
def test_knn_routes_that_stay_dense(monkeypatch, case):
    """knn > 1 takes the top-k sweep only under PMTPU_SERVE_SKIP=1, only up
    to knn 4, and only on a resident map, as in the JAX package."""
    monkeypatch.setenv("PMTPU_SERVE_SKIP", "auto" if case == "auto" else "1")
    monkeypatch.setattr(KDTreeMatcher, "SKIP_AUTO_MIN_MAP", 512)
    if case == "streaming":
        monkeypatch.setattr(sweep, "SKIP_MAX_MPAD", 512)
    r, rm = _cloudlike(seed=11, m=2000)[2:]
    ref = PointCloud(*_t(r, rm))
    mat = KDTreeMatcher({"knn": "5" if case == "knn5" else "2"})
    assert not mat.serving_loop_aux(ref)
    mat = KDTreeMatcher({"knn": "1"})
    assert mat.serving_loop_aux(ref)
    with pytest.raises(ValueError, match="2..4"):
        sc.nnk_survivor_sweep_plain(torch.zeros((1024, 8)), torch.zeros(
            (1, 8, 128)), torch.zeros((1, 128), dtype=torch.int32), 5)
