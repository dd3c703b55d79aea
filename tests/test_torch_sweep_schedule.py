"""The sweep schedule of K3 and K4 on the card's terms, on the CPU: each
query sweeps the chunks flagged for its own 256-query tile (K2's flags as
K2 writes them). Held against the 1024-query fold (the TPU's schedule),
against the JAX package's ops/knn_sweep2.py at ``tile_q=256`` (Pallas in
interpret mode, as tests/test_knn_sweep2.py runs it) and against the brute
force.

Tolerances: the port's plain sweep at either granularity gives the same d²
and ids bit for bit on the valid queries (each is the exact lowest-index
minimum over a superset of the true neighbour's chunk). Against
Pallas: d² within RTOL/ATOL of tests/test_torch_sweep.py (the interpreter
contracts multiply-adds), ids where the neighbour is unique by more than
that (the Pallas sweep breaks ties by lane). The same kernels on the card
are held to the plain version in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_sweep import ATOL, RTOL, _cloudlike, _sorted, _t, _unique
from torch_telemetry_fixture import detail_telemetry  # noqa: F401

import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu_torch import telemetry
from libpointmatcher_tpu_torch.ops import sweep
from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(k2.pl, "pallas_call", patched)


def _tied(seed, n=900, m=1400):
    """_cloudlike with every third map row a copy of the one before it,
    so that many queries have two nearest rows at the same distance."""
    q, qm, r, rm = _cloudlike(n=n, m=m, seed=seed)
    r[1::3] = r[0::3][: len(r[1::3])]
    return q, qm, r, rm


def _step_inputs(seed, warm, ties=True):
    """Sorted queries and map, their tables, the query table and K2's flags
    per 256 queries, cold or with a transported bound."""
    qs, qsm, rs, rsm, rt3, ct = _sorted(*(_tied(seed) if ties
                                          else _cloudlike(seed=seed)))
    ub = np.full(len(qs), np.inf, np.float32)
    if warm:                    # the exact distance, moved by 1 cm
        d, _ = knn_brute_force(*_t(qs, qsm, rs, rsm), k=1)
        ub = np.where(qsm, (np.sqrt(d.numpy()[:, 0]) + 0.01) * sweep.UP,
                      np.inf).astype(np.float32)
    qp = sweep.query_table(*_t(qs, qsm, ub))
    _, surv = sc.survivors_and_bounds(qp, torch.from_numpy(ct),
                                      nch=rt3.shape[0])
    return qs, qsm, rs, rsm, torch.from_numpy(rt3), ct, qp, surv


def _fold(surv):
    return surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)


@pytest.mark.parametrize("seed", [11, 12, 16, 17])
@pytest.mark.parametrize("warm", [False, True])
def test_plain_256_equals_1024_fold(seed, warm):
    """Each valid query's own tile's survivors give the fold's result bit
    for bit, ties included: the fold only adds chunks that cannot hold a
    valid query's minimum. Invalid rows, which the step masks, see other
    chunks: (+inf, 0) in a 256-query tile with no survivor."""
    qs, qsm, rs, rsm, rt3, ct, qp, surv = _step_inputs(seed, warm)
    d256, i256 = sc.survivor_sweep_plain(qp, rt3, surv)
    d1024, i1024 = sc.survivor_sweep_plain(qp, rt3, _fold(surv))
    valid = qp[:, 3] == 0
    assert torch.equal(d256[valid], d1024[valid])
    assert torch.equal(i256[valid], i1024[valid])
    empty = (surv.sum(dim=1) == 0).repeat_interleave(256)
    assert bool(empty.any()) and not bool((empty & valid).any())
    assert bool(torch.isinf(d256[empty]).all()) and not bool(i256[empty].any())
    # the fold sweeps more: every 256-tile's list is within its 1024-tile's
    assert int(surv.sum()) < 4 * int(_fold(surv).sum())
    # and both are the exact minimum with the lowest index among ties
    n = len(qs)
    db, ib = knn_brute_force(*_t(qs, qsm, rs, rsm), k=1)
    v = torch.from_numpy(qsm)
    assert torch.equal(d256[:n][v], db[:, 0][v])
    assert torch.equal(i256[:n][v], ib[:, 0][v])


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_sweep_256_matches_pallas(stream, warm):
    """The wrappers (the plain version on the CPU) at K2's own flags against
    the Pallas sweeps at ``tile_q=256``."""
    qs, qsm, rs, rsm, rt3, ct, qp, surv = _step_inputs(13, warm, ties=False)
    jfn = k2.nn1_survivor_sweep_stream if stream else k2.nn1_survivor_sweep
    dj, ij = map(np.asarray, jfn(jnp.asarray(qp.numpy()), jnp.asarray(rt3.numpy()),
                                 jnp.asarray(surv.numpy()), tile_q=256))
    fn = sc.nn1_survivor_sweep_stream if stream else sc.nn1_survivor_sweep
    dt, it = (x.numpy() for x in fn(qp, rt3, surv))
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    n = len(qs)
    uniq = _unique(qs, qsm, rs, rsm, RTOL * np.abs(dj[:n][qsm]).max() + ATOL)
    assert uniq.sum() > 500
    np.testing.assert_array_equal(it[:n][uniq], ij[:n][uniq])
    # the padding tiles hold no survivor: (+inf, 0)
    empty = (surv.sum(dim=1) == 0).repeat_interleave(256).numpy()
    assert empty[-256:].all()
    assert np.all(np.isinf(dt[empty])) and np.all(it[empty] == 0)


@pytest.mark.parametrize("seed,scale,stream", [(0, 1.0, False), (7, 50.0, True),
                                               (3, 1.0, True), (9, 50.0, False)])
def test_nn1_sorted_v2_matches_jax_256_and_brute_force(seed, scale, stream,
                                                       detail_telemetry):
    """The step at K2's own tile against JAX's ``sweep_tile_q=256`` and the
    brute force, cold then warm; its ``frac`` is still JAX's at the default
    fold (``sweep_tile_q=1024``)."""
    qs, qsm, rs, rsm, rt3, ct = _sorted(*_cloudlike(seed=seed, scale=scale))
    tq, tqm, trs, trsm, trt3, tct = _t(qs, qsm, rs, rsm, rt3, ct)
    db, ib = (x.numpy()[:, 0] for x in knn_brute_force(tq, tqm, trs, trsm, k=1))
    uniq = _unique(qs, qsm, rs, rsm, RTOL * np.abs(db[qsm]).max() + ATOL)
    ub = np.full(len(qs), np.inf, np.float32)
    for it in range(2):
        with telemetry.call("nn1_sorted_v2"):
            d, i = sweep.nn1_sorted_v2(tq, tqm, torch.from_numpy(ub), trt3,
                                       tct, stream=stream)
        frac = detail_telemetry("survivor_share")[-1]
        args = tuple(map(jnp.asarray, (qs, qsm, ub, rt3, ct)))
        dj, ij, _ = k2.nn1_sorted_v2(*args, sweep_tile_q=256, stream=stream)
        _, _, fj = k2.nn1_sorted_v2(*args, stream=stream)
        d, i = d.numpy(), i.numpy()
        np.testing.assert_array_equal(d, db)
        np.testing.assert_array_equal(i, ib)
        np.testing.assert_allclose(d, np.asarray(dj), rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(i[uniq], np.asarray(ij)[uniq])
        assert float(frac) == pytest.approx(float(fj))
        ub = np.where(qsm, np.sqrt(d) * sweep.UP, np.inf).astype(np.float32)


@pytest.mark.parametrize("fold", [False, True])
def test_flag_tile_reads_either_granularity(fold):
    """``flag_tile`` reads 256 or 1024 queries a row from the flags' row
    count, and the wrappers at either give every valid query its exact
    nearest row, the lowest index among ties, cold and warm."""
    for warm in (False, True):
        qs, qsm, rs, rsm, rt3, _, qp, surv = _step_inputs(14, warm)
        if fold:
            surv = _fold(surv)
        assert sc.flag_tile(qp, surv) == (sc.SWEEP_TILE if fold
                                          else sc.BOUND_TILE)
        db, ib = knn_brute_force(*_t(qs, qsm, rs, rsm), k=1)
        v, n = torch.from_numpy(qsm), len(qs)
        for fn in (sc.nn1_survivor_sweep, sc.nn1_survivor_sweep_stream):
            d, i = fn(qp, rt3, surv)
            assert torch.equal(d[:n][v], db[:, 0][v])
            assert torch.equal(i[:n][v], ib[:, 0][v])


@pytest.mark.parametrize("rows", ["n_pad/512", "n_pad/128", "n_pad/256+1",
                                  "one_dim"])
def test_wrappers_raise_on_other_flag_rows(rows):
    """Flags at either granularity are read from their row count; any other
    shape raises, in both wrappers and in the plain version."""
    *_, rt3, _, qp, surv = _step_inputs(15, False)
    n_pad, nch_pad = qp.shape[0], surv.shape[1]
    bad = {"n_pad/512": torch.zeros((n_pad // 512, nch_pad), dtype=torch.int32),
           "n_pad/128": torch.zeros((n_pad // 128, nch_pad), dtype=torch.int32),
           "n_pad/256+1": torch.zeros((n_pad // 256 + 1, nch_pad),
                                      dtype=torch.int32),
           "one_dim": torch.zeros(n_pad // 256, dtype=torch.int32)}[rows]
    for fn in (sc.nn1_survivor_sweep, sc.nn1_survivor_sweep_stream,
               sc.survivor_sweep_plain):
        with pytest.raises(ValueError, match="surv"):
            fn(qp, rt3, bad)
