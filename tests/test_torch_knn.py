"""The port's dense k-NN (libpointmatcher_tpu_torch.ops) against the JAX
package's Pallas kernels, run in interpret mode on the CPU as
tests/test_knn_pallas.py runs them.

Tolerances: the plain K1 and K5 versions use the same difference form as the
Pallas kernels, so distances agree within rtol 1e-6, atol 1e-7 (the two
frameworks may round the padded lanes' zero terms differently, nothing
more). Ids must agree wherever the neighbour is unique by more than that
tolerance: the Pallas K1 breaks ties by lane, the port by lowest index.
K9 is the expansion form q² + r² − 2q·r, whose rounding error is absolute,
so its bound is 2^-20·(q² + r²) per pair.

The same kernels on the card are tested in tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import libpointmatcher_tpu.ops.knn_pallas as kp
from libpointmatcher_tpu.ops.dispatch import knn_search as jax_knn_search
from libpointmatcher_tpu_torch.ops import dispatch
from libpointmatcher_tpu_torch.ops import knn_cuda as kc

RTOL, ATOL = 1e-6, 1e-7


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(kp.pl, "pallas_call", patched)


def _data(n=300, m=700, seed=0, case="masked"):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 3)).astype(np.float32)
    r = rng.normal(size=(m, 3)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[5:9] = False
    rm[::3] = False
    if case == "all_ref_masked":
        rm[:] = False
    return q, qm, r, rm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _oracle(q, qm, r, rm, k):
    """numpy float32 difference form in the kernels' order; stable sort so
    the lowest index wins ties."""
    pen = np.where(rm, np.float32(0), np.float32(np.inf)).astype(np.float32)
    d2 = pen[None, :].copy()
    for c in range(q.shape[1]):
        diff = q[:, c, None] - r[None, :, c]
        d2 = d2 + diff * diff
    order = np.argsort(d2, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(d2, order, axis=1)
    if d.shape[1] < k:
        pad = k - d.shape[1]
        d = np.pad(d, ((0, 0), (0, pad)), constant_values=np.inf)
        order = np.pad(order, ((0, 0), (0, pad)), constant_values=-1)
    ids = np.where(np.isfinite(d) & qm[:, None], order, -1)
    d = np.where(qm[:, None], d, np.inf)
    return d.astype(np.float32), ids.astype(np.int32)


def _unique_slots(q, qm, r, rm, k, tol):
    """[N, k] mask of slots whose distance is apart from its neighbours in
    the sorted list by more than ``tol``."""
    d, _ = _oracle(q, qm, r, rm, min(k + 1, max(len(r), 1)))
    d = np.pad(d, ((0, 0), (1, 1)), constant_values=np.inf)[:, : k + 2]
    with np.errstate(invalid="ignore"):
        lo = d[:, 1:k + 1] - d[:, 0:k]
        hi = d[:, 2:k + 2] - d[:, 1:k + 1]
    lo[:, 0] = np.inf
    return np.isfinite(d[:, 1:k + 1]) & (lo > tol) & (hi > tol)


@pytest.mark.parametrize("case", ["masked", "all_ref_masked"])
def test_k1_plain_matches_pallas(case):
    q, qm, r, rm = _data(case=case)
    dj, ij = map(np.asarray, kp.knn1_pallas(q, qm, r, rm))
    dt, it = (x.numpy() for x in kc.knn1(*_t(q, qm, r, rm)))
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    tol = RTOL * np.abs(dj[np.isfinite(dj)]).max(initial=0) + ATOL
    uniq = _unique_slots(q, qm, r, rm, 1, tol)[:, 0]
    np.testing.assert_array_equal(it[uniq], ij[uniq])
    np.testing.assert_array_equal(it == -1, ij == -1)
    assert np.all(it[5:9] == -1) and np.all(np.isinf(dt[5:9]))
    if case == "all_ref_masked":
        assert np.all(it == -1) and np.all(np.isinf(dt))


@pytest.mark.parametrize("case", ["masked", "all_ref_masked"])
def test_k9_plain_matches_pallas(case):
    q, qm, r, rm = _data(seed=1, case=case)
    dj, ij = map(np.asarray, kp.knn1_pallas_mxu(q, qm, r, rm))
    dt, it = (x.numpy() for x in kc.knn1_mxu(*_t(q, qm, r, rm)))
    fin = np.isfinite(dj)
    np.testing.assert_array_equal(fin, np.isfinite(dt))
    r2max = float((r[rm] ** 2).sum(1).max(initial=0.0))
    tol = 2.0 ** -20 * ((q ** 2).sum(1) + r2max)
    assert np.all(np.abs(dt[fin] - dj[fin]) <= tol[fin])
    uniq = _unique_slots(q, qm, r, rm, 1, 2 * tol.max())[:, 0]
    np.testing.assert_array_equal(it[uniq], ij[uniq])
    np.testing.assert_array_equal(it == -1, ij == -1)


@pytest.mark.parametrize("k", [2, 7, 32])
def test_k5_plain_matches_pallas(k):
    q, qm, r, rm = _data(seed=3)
    dj, ij = map(np.asarray, kp.knnk_pallas(q, qm, r, rm, k, tile_q=128,
                                             tile_m=512))
    dt, it = (x.numpy() for x in kc.knnk(*_t(q, qm, r, rm), k))
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=ATOL)
    tol = RTOL * np.abs(dj[np.isfinite(dj)]).max() + ATOL
    uniq = _unique_slots(q, qm, r, rm, k, tol)
    np.testing.assert_array_equal(it[uniq], ij[uniq])
    assert np.all(np.diff(dt[np.isfinite(dt[:, 0])], axis=1) >= 0)
    assert np.all(it[5:9] == -1)


@pytest.mark.parametrize("n,m,k", [(0, 5, 1), (5, 0, 1), (1, 1, 1), (1, 1, 3),
                                   (37, 4099, 1), (37, 4099, 7), (20, 6, 8)])
def test_plain_edge_shapes_match_oracle(n, m, k):
    """N or M of 0 or 1, M not a multiple of the tile, k above the number
    of valid references: bit-equal to the numpy oracle."""
    rng = np.random.default_rng(n * 31 + m)
    q = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    r = rng.uniform(-3, 3, (m, 3)).astype(np.float32)
    r[1::2] = r[::2][: len(r[1::2])]          # exact duplicates: ties
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    rm[::5] = False
    d_o, i_o = _oracle(q, qm, r, rm, k)
    fn = (lambda *a: [x[:, None] for x in kc.knn1(*a)]) if k == 1 else (
        lambda *a: kc.knnk(*a, k))
    dt, it = (x.numpy() for x in fn(*_t(q, qm, r, rm)))
    np.testing.assert_array_equal(dt, d_o)
    np.testing.assert_array_equal(it, i_o)


def test_tile_boundaries_keep_lowest_index():
    """Equal distances in different tiles: the lowest reference id wins."""
    r = np.zeros((9000, 3), np.float32)
    q = np.ones((3, 3), np.float32)
    qm, rm = np.ones(3, bool), np.ones(9000, bool)
    rm[:5] = False
    d, i = kc.knn1(*_t(q, qm, r, rm))
    assert np.all(i.numpy() == 5) and np.all(d.numpy() == 3.0)
    d, i = kc.knnk(*_t(q, qm, r, rm), 4)
    np.testing.assert_array_equal(i.numpy(), np.tile([5, 6, 7, 8], (3, 1)))


@pytest.mark.parametrize("k,eps,route", [
    (1, 0.0, "knn1"),
    (1, 1e-5, "knn1"),
    (1, dispatch.MXU_EPSILON_FLOOR, "knn1_mxu"),
    (5, 0.0, "knnk"),
    (32, 0.0, "knnk"),
    (33, 0.0, "knn_brute_force"),
])
def test_knn_search_routing(monkeypatch, k, eps, route):
    """Routes by k and ε as dispatch.py does, and agrees with the JAX
    package's knn_search (the plain sweep on the CPU)."""
    q, qm, r, rm = _data(n=64, m=200, seed=5)
    called = []
    for name in ("knn1", "knn1_mxu", "knnk", "knn_brute_force"):
        fn = getattr(dispatch, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            called.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(dispatch, name, spy)
    dt, it = (x.numpy() for x in dispatch.knn_search(*_t(q, qm, r, rm), k=k,
                                                     epsilon=eps))
    assert called == [route]
    dj, ij = map(np.asarray, jax_knn_search(q, qm, r, rm, k=k, epsilon=eps))
    assert dt.shape == dj.shape == (64, k)
    r2max = float((r[rm] ** 2).sum(1).max())
    atol = 2.0 ** -19 * (3 * 4.0 ** 2 + r2max) if route == "knn1_mxu" else ATOL
    np.testing.assert_allclose(dt, dj, rtol=RTOL, atol=atol)


def test_wrappers_check_inputs():
    q, qm, r, rm = _t(*_data(n=8, m=9))
    with pytest.raises(ValueError):
        kc.knn1(q.double(), qm, r, rm)
    with pytest.raises(ValueError):
        kc.knn1(q, qm.float(), r, rm)
    with pytest.raises(ValueError):
        kc.knnk(q, qm, r, rm, 33)
