"""K2 and K6 on the card's schedules, on the CPU.

K2 (``csrc/sweep.cu::survivors_bounds``) prunes (warp, chunk) pairs with a
warp-uniform prefilter, skips the square root where dc2 > U² and visits the
chunks from the one nearest each warp; ``torch_survivor_emulation.
emulate_k2`` is that schedule in torch. K6 (``survivor_sweep_k`` +
``survivor_merge_k``) sweeps each query's own 256-query tile in segments
and merges their k-slot lists; ``emulate_k6`` is that schedule. Both
emulations are held to the plain versions bit for bit, on inputs that
include warps made wholly of padding, queries and boxes placed exactly on
the prefilter's boundary, and ties across a segment boundary. The route at
K2's own flags is held to the 1024-query fold, to the JAX package's
``nnk_sorted_v2`` at ``sweep_tile_q=256`` and 1024 (Pallas in interpret
mode, as tests/test_knn_sweep2.py runs it) and to the brute force.

Tolerances: the port's plain versions and the emulations round the same
operations in the same order, so they agree bit for bit; so do the two flag
granularities on the valid queries and the route against the brute force.
Against Pallas: d² within RTOL/ATOL of tests/test_torch_sweep.py (the
interpreter contracts multiply-adds), ids where the neighbour is unique by
more than that. The kernels themselves are held to the plain versions on
the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_sweep import ATOL, RTOL, _cloudlike, _sorted, _t
import torch_survivor_emulation as em
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.ops import sweep
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

SLACK = 2.0 ** -20      # a prefilter that skips this much too early


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(k2.pl, "pallas_call", patched)


def _inputs(seed, warm, k=1, n=3000, m=5000, ties=False):
    """Sorted queries and map, the map's tables and the query table, cold
    or with a transported bound on the k-th distance (moved by 1 cm). n is
    not a multiple of 2048, so the table ends in warps of padding; about a
    fifth of the queries are masked, and the Morton order puts them last."""
    q, qm, r, rm = _cloudlike(n=n, m=m, seed=seed)
    if ties:
        r[1:400:2] = r[0:400:2]
    qs, qsm, rs, rsm, rt3, ct = _sorted(q, qm, r, rm)
    ub = np.full(len(qs), np.inf, np.float32)
    if warm:
        d, _ = knn_brute_force(*_t(qs, qsm, rs, rsm), k=k)
        ub = np.where(qsm, (np.sqrt(d.numpy()[:, -1]) + 0.01) * sweep.UP,
                      np.inf).astype(np.float32)
    qp = sweep.query_table(*_t(qs, qsm, ub))
    return qs, qsm, rs, rsm, torch.from_numpy(rt3), torch.from_numpy(ct), qp


def _fold(surv):
    return surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("warm", [False, True])
def test_k2_schedule_equals_plain(warm, k):
    """The prefilter, the square-root skip and the ring order from the
    nearest chunk give the plain version's bounds and flags bit for bit,
    cold and warm, on every row (padding warps included) and every column
    (the padding columns' zeros included); the prefilter prunes."""
    *_, rt3, ct, qp = _inputs(21, warm, k)
    nch = rt3.shape[0]
    ubp, sp = sc.survivors_and_bounds_plain(qp, ct, k, nch=nch)
    ube, se, counts = em.emulate_k2(qp, ct, k, nch=nch)
    assert torch.equal(ube, ubp) and torch.equal(se, sp)
    pad_warps = (qp[:, 3] != 0).reshape(-1, 32).all(dim=1)
    assert int(pad_warps.sum()) >= 30
    assert counts["pairs"] == qp.shape[0] // 32 * nch
    assert counts["pass1"] < counts["pairs"]
    assert counts["pass2"] <= counts["pass2_box"] < counts["pairs"]
    # the whole table, padding columns included, gives the same
    ubf, sf, _ = em.emulate_k2(qp, ct, k)
    assert torch.equal(ubf, ubp) and torch.equal(sf, sp)


def test_k2_padding_warps_pruned_in_pass_2():
    """Warps made wholly of padding (penalty 1e15) enter pass 2's box test
    as the per-query formula treats them: their lhs is at least the
    penalty, so they flag nothing and the prefilter passes none of their
    pairs."""
    *_, rt3, ct, qp = _inputs(22, True)
    nch = rt3.shape[0]
    pad = torch.zeros_like(qp)
    pad[:, 3] = sweep.FAR
    pad[:, 4] = float("inf")
    both = torch.cat([qp, pad[:1024]])       # four tiles of padding at the end
    ubp, sp = sc.survivors_and_bounds_plain(both, ct, nch=nch)
    ube, se, counts = em.emulate_k2(both, ct, nch=nch)
    assert torch.equal(ube, ubp) and torch.equal(se, sp)
    assert not bool(sp[-4:].any())
    _, _, c0 = em.emulate_k2(qp, ct, nch=nch)
    assert counts["pass2_box"] == c0["pass2_box"]


def test_k2_prefilter_exact_on_its_margin():
    """Queries and boxes placed exactly on the prefilter's boundary: a warp
    whose queries all sit at one point (its box is that point, so the box's
    bound equals each query's) with its bound one ulp above a chunk's
    candidate, and a tile at a point outside the map whose U²·UP equals the
    flag test's lhs of its nearest chunk. The exact prefilter gives the
    plain version's bits; one that skips 2^-20 early does not (pass 1 keeps
    the ulp, pass 2 loses the flag), so the input does sit on the margin."""
    *_, rt3, ct, qp = _inputs(23, True)
    nch = rt3.shape[0]
    qp, c1, c2 = em.margin_rows(qp, ct, nch, np.random.default_rng(5))
    ubp, sp = sc.survivors_and_bounds_plain(qp, ct, nch=nch)
    assert bool((ubp[:256] < qp[:256, 4]).all())       # the ulp is taken
    assert int(sp[1, c2]) == 1                          # flagged at equality
    ube, se, _ = em.emulate_k2(qp, ct, nch=nch)
    assert torch.equal(ube, ubp) and torch.equal(se, sp)
    ubw, sw, _ = em.emulate_k2(qp, ct, nch=nch, slack=SLACK)
    assert not torch.equal(ubw[:256], ubp[:256])
    assert int(sw[1, c2]) == 0
    # one ulp under equality the chunk no longer survives for that tile
    qp[256:512, 4] = torch.nextafter(qp[256, 4], torch.tensor(-1.0))
    _, below = sc.survivors_and_bounds_plain(qp, ct, nch=nch)
    assert int(below[1, c2]) == 0
    assert torch.equal(em.emulate_k2(qp, ct, nch=nch)[1], below)


def test_k2_square_root_skip_is_exact():
    """fma(-u, u, dc2) > 0 (the sign of dc2 - u², taken exactly) implies
    that the bound candidate (sqrt(dc2) + rad)·UP + add is not under u, so
    fminf keeps u; at and just around equality too."""
    rng = np.random.default_rng(8)
    u = rng.uniform(0, 10, 200_000).astype(np.float32)
    near = (u.astype(np.float64) ** 2).astype(np.float32)
    dc2 = np.concatenate([rng.uniform(0, 100, 200_000).astype(np.float32),
                          near, np.nextafter(near, np.float32(np.inf)),
                          np.nextafter(near, np.float32(0))])
    u = np.tile(u, 4)
    rad = np.float32(0.0)
    skip = (dc2.astype(np.float64) - u.astype(np.float64) ** 2) > 0
    cand = (np.sqrt(dc2) + rad) * np.float32(em.UP)
    assert skip.sum() > 200_000
    assert np.all(cand[skip] >= u[skip])


# ------------------------------------------------------------------ K6
@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_own_tile_equals_fold(k):
    """K6 at K2's own 256-query flags gives the 1024-query fold's result
    (the plain version there) on every valid query, ties included, cold
    and warm: K2 with k bounds each query's k-th neighbour over chunks
    holding k valid rows, so every chunk that holds any of a query's k
    nearest rows survives for its own tile. The own tile sweeps fewer
    pairs."""
    for warm in (False, True):
        *_, rt3, ct, qp = _inputs(24, warm, k, n=2000, m=3000, ties=True)
        _, surv = sc.survivors_and_bounds(qp, ct, k, nch=rt3.shape[0])
        d256, i256 = sc.nnk_survivor_sweep(qp, rt3, surv, k)
        d1024, i1024 = sc.nnk_survivor_sweep_plain(qp, rt3, _fold(surv), k)
        valid = qp[:, 3] == 0
        assert torch.equal(d256[valid], d1024[valid])
        assert torch.equal(i256[valid], i1024[valid])
        assert int(surv.sum()) < 4 * int(_fold(surv).sum())


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_route_matches_jax_and_brute_force(k, detail_telemetry):
    """``nnk_sorted_v2`` (K6 on K2's own flags) against JAX's at
    ``sweep_tile_q=256`` (warm) and at its default 1024 (cold and warm),
    and against the brute force, cold then warm; ``frac`` stays JAX's at
    the 1024-query fold."""
    q, qm, r, rm = _cloudlike(seed=30 + k, m=1400)
    r[1:300:2] = r[0:300:2]
    qs, qsm, rs, rsm, rt3, ct = _sorted(q, qm, r, rm)
    tq, tqm, trs, trsm, trt3, tct = _t(qs, qsm, rs, rsm, rt3, ct)
    db, ib = (x.numpy() for x in knn_brute_force(tq, tqm, trs, trsm, k=k))
    d2 = knn_brute_force(tq, tqm, trs, trsm, k=k + 1)[0].numpy()
    tol = RTOL * np.abs(db[qsm]).max() + ATOL
    with np.errstate(invalid="ignore"):
        gaps = np.diff(np.concatenate([np.full((len(qs), 1), -1.0), d2], 1), axis=1)
    uniq = qsm[:, None] & (gaps[:, :k] > tol) & (gaps[:, 1:] > tol)
    assert uniq.sum() > 500
    ub = np.full(len(qs), np.inf, np.float32)
    for it in range(2):
        with telemetry.call("nnk_sorted_v2"):
            d, i = sweep.nnk_sorted_v2(tq, tqm, torch.from_numpy(ub), trt3,
                                       tct, k)
        frac = detail_telemetry("survivor_share")[-1]
        d, i = d.numpy(), i.numpy()
        np.testing.assert_array_equal(d, db)
        np.testing.assert_array_equal(i, ib)
        args = tuple(map(jnp.asarray, (qs, qsm, ub, rt3, ct)))
        for tile in ((1024,) if it == 0 else (256, 1024)):
            dj, ij, fj = map(np.asarray, k2.nnk_sorted_v2(*args, k=k,
                                                          sweep_tile_q=tile))
            np.testing.assert_allclose(d, dj, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(i[uniq], ij[uniq])
            if tile == 1024:
                assert float(frac) == pytest.approx(float(fj))
        ub = np.where(qsm, np.sqrt(d[:, -1]) * sweep.UP, np.inf).astype(np.float32)


@pytest.mark.parametrize("k", [2, 3, 4])
def test_k6_schedule_equals_plain(k):
    """The segments, the groups of 8 inserted under the k-th distance and
    the merge in segment order give the plain version's stable sort bit for
    bit at K2's own flags, cold and warm."""
    for warm in (False, True):
        *_, rt3, ct, qp = _inputs(25, warm, k, n=900, m=1400, ties=True)
        _, surv = sc.survivors_and_bounds(qp, ct, k, nch=rt3.shape[0])
        dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
        de, ie, groups = em.emulate_k6(qp, rt3, surv, k)
        assert torch.equal(de, dp) and torch.equal(ie, ip)
        assert 0 < groups["inserted"] < groups["swept"]


@pytest.mark.parametrize("k", [2, 4])
def test_k6_merge_keeps_tie_order_across_segments(k):
    """Duplicated map rows across a segment boundary: the last listed chunk
    of segment 0 and the first of segment 1 hold the same points, so every
    query near them ties between the two. The merge in segment order with a
    strict '<' keeps the lower sorted-map index first, as the stable sort."""
    q, qm, r, rm = _cloudlike(n=900, m=2600, seed=26)
    qs, qsm, rs, rsm, rt3, ct = _sorted(q, qm, r, rm)
    rt3 = torch.from_numpy(rt3)
    nch = rt3.shape[0]
    a = 5
    rt3[a + 1] = rt3[a]                      # chunk a + 1 repeats chunk a
    qp = sweep.query_table(*_t(qs, qsm, np.full(len(qs), np.inf, np.float32)))
    # 16 flagged chunks: two a segment, chunks a and a + 1 at list places
    # 1 and 2, so the cut falls between them
    row = torch.zeros(ct.shape[1], dtype=torch.int32)
    row[[0, a, a + 1, *range(a + 2, a + 15)]] = 1
    assert int(row[:nch].sum()) == 16
    surv = row.expand(qp.shape[0] // 256, -1).contiguous()
    dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
    de, ie, _ = em.emulate_k6(qp, rt3, surv, k)
    assert torch.equal(de, dp) and torch.equal(ie, ip)
    # queries whose two best rows are the pair (a·128 + j, (a+1)·128 + j)
    first, second = ip[:, 0].long(), ip[:, 1].long()
    tied = (first // 128 == a) & (second == first + 128) & (dp[:, 0] == dp[:, 1])
    assert int(tied.sum()) > 20
    # the merge in the other order (segment 1 first) would put them the
    # other way round
    seg = [em.emulate_k6(qp, rt3, s, k)[:2] for s in (
        _only(surv, [0, a]), _only(surv, [a + 1, *range(a + 2, a + 15)]))]
    swapped = em._merge_segment(*seg[1], *seg[0])
    assert not torch.equal(swapped[1][tied], ip[tied])


def _only(surv, chunks):
    out = torch.zeros_like(surv)
    out[:, chunks] = 1
    return out


@pytest.mark.parametrize("rows", ["n_pad/512", "n_pad/128", "n_pad/256+1",
                                  "one_dim"])
def test_k6_raises_on_other_flag_rows(rows):
    """K6 reads 256 or 1024 queries a flag row from the row count (on the
    card the kernel takes only the 256, tests/test_torch_cuda.py); any
    other shape raises, in the wrapper and in the plain version."""
    *_, rt3, ct, qp = _inputs(27, False, 2, n=900, m=1400)
    n_pad, nch_pad = qp.shape[0], ct.shape[1]
    bad = {"n_pad/512": torch.zeros((n_pad // 512, nch_pad), dtype=torch.int32),
           "n_pad/128": torch.zeros((n_pad // 128, nch_pad), dtype=torch.int32),
           "n_pad/256+1": torch.zeros((n_pad // 256 + 1, nch_pad),
                                      dtype=torch.int32),
           "one_dim": torch.zeros(n_pad // 256, dtype=torch.int32)}[rows]
    for fn in (sc.nnk_survivor_sweep, sc.nnk_survivor_sweep_plain):
        with pytest.raises(ValueError, match="surv"):
            fn(qp, rt3, bad, 2)
