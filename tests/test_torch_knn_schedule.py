"""The schedule of the dense kernels K1 and K5 on the card's terms, on the
CPU: tools_torch/dense_micro.py's ``emulate`` (the chunks as
``knn_cuda._split`` cuts them, ``x + pen`` staging, groups of 8 rows, K1's
group argmin with its recomputed best group, K5's k-slot insertion in group
order, the chunk merge in chunk order) against the port's plain version
``knn_brute_force``, and the same inputs through the JAX package's Pallas
K1 and K5 in interpret mode (as tests/test_torch_knn.py runs them).

Tolerances: the emulation equals ``knn_brute_force`` bit for bit, d² and
ids, ties included (the same rounded operations, the lowest index first).
Against Pallas: d² within tests/test_torch_knn.py's RTOL/ATOL, ids where
the neighbour is unique beyond it. The kernels themselves are held to the
plain version on the card in tests/test_torch_cuda.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from test_torch_knn import ATOL, RTOL, _unique_slots

import libpointmatcher_tpu.ops.knn_pallas as kp
from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
import dense_micro  # noqa: E402

SMS = 132          # an H100's SMs: three 1024-row chunks at m ~ 2100
G = kc.GROUP_ROWS


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(kp.pl, "pallas_call", patched)


def _case(name, seed=0):
    """Queries and references of one schedule case (numpy)."""
    rng = np.random.default_rng(seed)
    n, m, dim = 300, 2100, 3
    if name == "odd_m":
        m = 2053                             # not a multiple of 4 or of G
    if name == "2d":
        dim = 2
    q = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    r = rng.uniform(-3, 3, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::11] = False
    qm[256:] = False                         # the second block's queries: all masked
    qm[270] = True                           # but one
    if name == "dup":
        r[1:1024:4] = r[0:1024:4]            # ties within a group
        r[8 + 16:1024:16] = r[16:1024 - 8:16]  # ties across groups
        r[1024:1400] = r[0:376]              # ties across chunks
        r[2048:2100] = r[1024:1076]
    if name in ("masked_edges", "odd_m", "2d"):
        for j in range(0, m, G):             # the rows at each group's edges
            rm[j] = j % 3 != 0
            rm[min(m - 1, j + G - 1)] = j % 5 != 0
        rm[1023:1026] = False                # around the chunk edge
    if name == "masked_chunk":
        rm[1024:2048] = False                # the whole second chunk
    return q, qm, r, rm


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _assert_bits(q, qm, r, rm, k):
    d, i, taken, units = dense_micro.emulate(q, qm, r, rm, k, sms=SMS)
    db, ib = knn_brute_force(q, qm, r, rm, k=k)
    assert torch.equal(d, db) and torch.equal(i, ib)
    assert 0 <= taken <= units and (units == 0) == (k == 1)


@pytest.mark.parametrize("n,m,pairs,kk", [
    (300, 2100, 1, 0), (18654, 50147, 1, 0), (167936, 12565, 1, 0),
    (4 * 21000, 21000, 4, 0), (50000, 50000, 1, 10), (18654, 50147, 1, 32),
    (0, 7, 1, 0), (7, 0, 1, 5), (1, 1, 1, 2), (255, 1025, 3, 17)])
@pytest.mark.parametrize("aim", [4, 16])
def test_split_contract(n, m, pairs, kk, aim):
    """Chunks are whole numbers of ``TILE_ROWS``, cover the reference
    (splits × chunk ≥ m) and none is empty; K1 takes 256 queries a block,
    K5 128."""
    splits, chunk = kc._split(n, m, SMS, pairs, kk, aim)
    assert splits >= 1 and chunk % kc.TILE_ROWS == 0 and chunk > 0
    assert splits * chunk >= m and (splits - 1) * chunk < max(m, 1)
    assert kc.block_queries(kk) == (128 if kk else 256)
    qblocks = max(1, -(-n // kc.block_queries(kk))) * pairs
    if splits > 1:          # split only while the blocks stay under the aim
        assert qblocks * (splits - 1) < aim * SMS


def test_knnk_lists():
    """A list of k slots (at least 2), one kernel instance each."""
    assert [kc.knnk_list(k) for k in range(1, 33)] == [2] + list(range(2, 33))
    assert set(kc.knnk_list(k) for k in range(1, 33)) == set(kc.KNNK_LISTS)


@pytest.mark.parametrize("k", [1, 2, 5, 10, 16, 17, 32])
def test_schedule_ties(k):
    """Duplicated rows: ties within a group, across groups and across
    chunks all resolve to the lowest index, as the brute force's."""
    _assert_bits(*_t(*_case("dup")), k)


@pytest.mark.parametrize("name,k", [
    *((c, k) for c in ("masked_edges", "masked_chunk", "odd_m", "2d")
      for k in (1, 5)), ("masked_chunk", 17), ("odd_m", 32)])
def test_schedule_masks_and_shapes(name, k):
    """Masked rows at group and chunk edges, an all-masked chunk, m not a
    multiple of 4 or of a group, 2-D; a block of masked queries."""
    _assert_bits(*_t(*_case(name)), k)


@pytest.mark.parametrize("k", [1, 10])
def test_schedule_pair_axis(k):
    """Three pairs in one launch, the chunks cut for three pairs: each pair
    equals its own brute force (the pairs' masks differ)."""
    cases = [_case(c, seed=s) for s, c in enumerate(("dup", "masked_edges",
                                                    "masked_chunk"))]
    q, qm, r, rm = (torch.stack(x) for x in zip(*(_t(*c) for c in cases)))
    _assert_bits(q, qm, r, rm, k)


@pytest.mark.parametrize("m", [1, 3, 4, 5, G - 1, G + 1])
def test_schedule_small_references(m):
    """A reference shorter than a group or a float4: the padded rows
    never win."""
    q, qm, r, rm = _case("dup")
    r, rm = r[:m].copy(), rm[:m].copy()
    rm[m // 2] = False
    for k in (1, 3):
        _assert_bits(*_t(q, qm, r, rm), k)


@pytest.mark.parametrize("k", [1, 5, 17])
def test_schedule_matches_pallas(k):
    """The same inputs through the Pallas K1/K5 in interpret mode."""
    q, qm, r, rm = _case("masked_edges", seed=3)
    if k == 1:
        dj, ij = (np.asarray(x)[:, None] for x in kp.knn1_pallas(q, qm, r, rm))
    else:
        dj, ij = map(np.asarray, kp.knnk_pallas(q, qm, r, rm, k, tile_q=128,
                                                 tile_m=512))
    d, i, _, _ = dense_micro.emulate(*_t(q, qm, r, rm), k, sms=SMS)
    d, i = d.numpy(), i.numpy()
    np.testing.assert_allclose(d, dj, rtol=RTOL, atol=ATOL)
    tol = RTOL * np.abs(dj[np.isfinite(dj)]).max() + ATOL
    uniq = _unique_slots(q, qm, r, rm, k, tol)
    assert uniq.sum() > 200 * k
    np.testing.assert_array_equal(i[uniq], ij[uniq])
    np.testing.assert_array_equal(i == -1, ij == -1)


@pytest.mark.parametrize("order", ["nearest_first", "farthest_first"])
def test_insertion_units(order):
    """K5 takes the insertion branch only for groups holding a row under
    its k-th distance: rows nearest first fill the list in the first group
    and no later group is taken; farthest first, every group is."""
    m = 200
    r = np.zeros((m, 3), np.float32)
    r[:, 0] = np.arange(1, m + 1, dtype=np.float32)
    if order == "farthest_first":
        r = r[::-1].copy()
    q = np.zeros((40, 3), np.float32)
    qm, rm = np.ones(40, bool), np.ones(m, bool)
    d, i, taken, units = dense_micro.emulate(*_t(q, qm, r, rm), 5, sms=SMS)
    db, ib = knn_brute_force(*_t(q, qm, r, rm), k=5)
    assert torch.equal(d, db) and torch.equal(i, ib)
    groups = m // G
    assert units == 2 * groups           # the 40 queries fill 2 warps
    assert taken == (2 if order == "nearest_first" else units)


def test_dense_micro_time_runs_on_the_cpu(tmp_path):
    """tools_torch/dense_micro.py's ``time`` at a tiny recorded shape with
    the plain versions: each search is checked against the brute force and
    reported, K5 with its insertion share."""
    q, qm, r, rm = _t(*_case("dup"))
    path = tmp_path / "in.pt"
    torch.save({"K1 tiny": {"kernel": "K1", "k": 1, "q": q, "qm": qm, "r": r,
                            "rm": rm},
                "K5 tiny k=5": {"kernel": "K5", "k": 5, "q": q[:64],
                                "qm": qm[:64], "r": r[:700], "rm": rm[:700]}},
               path)
    rep = dense_micro.time_kernels(str(path), dense_micro.ROOT, reps=1,
                                   rounds=2, shares=True, device="cpu")
    assert list(rep["inputs"]) == ["K1 tiny", "K5 tiny k=5"]
    k1, k5 = rep["inputs"].values()
    assert k1["valid_pairs"] == int(qm.sum()) * int(rm.sum())
    assert all(len(v) == 2 and min(v) > 0 for v in k1["ms"].values())
    assert "insertion_share" not in k1 and 0 < k5["insertion_share"] <= 1
