"""The schedule of the dense kernels K1, K5 and K9 on the card's terms, on
the CPU: tools_torch/dense_micro.py's ``emulate`` (the chunks as
``knn_cuda._split`` cuts them, ``x + pen`` staging, groups of 8 rows, K1's
group argmin with its recomputed best group, K5's k-slot insertion in group
order, the chunk merge in chunk order) against the port's plain version
``knn_brute_force``, and the same inputs through the JAX package's Pallas
K1 and K5 in interpret mode (as tests/test_torch_knn.py runs them).

K9: ``emulate_k9`` (the chunks as ``knn_cuda.k9_split`` cuts them for 132
SMs, or for fewer to get chunks of several stages; blocks of 512 queries
whose warps each take a contiguous run, a block or a warp of masked
queries not sweeping; groups of 16 rows folded with fminf, (best, best
group) with a strict '<'; the chunks merged unclamped in order; the
winning group recomputed; the clamp) against ``knn1_mxu_plain``: ties
within a group, across groups and across chunks, two chunks whose minima
are both negative (the later, more negative one wins, then the clamp),
an all-masked chunk, masked queries and a whole block of them, n and m off
every multiple, a reference under one chunk, 2-D and 3-D, a pair axis;
the split rule's contract; and the Pallas K9 in interpret mode.

Tolerances: the emulations equal their plain versions bit for bit, d² and
ids, ties included (the same rounded operations, the lowest index first;
K9's emulation in ``knn1_mxu_plain``'s rounded arithmetic, the kernel's
fused products aside, since the schedule is under test). Against Pallas:
K1 and K5 d² within tests/test_torch_knn.py's RTOL/ATOL, K9 within
2^-20·(q² + r²max) as that file states, ids where the neighbour is unique
beyond it. The kernels themselves are held to the plain versions (K9 also
to ``dense_micro.k9_reference``, its fused arithmetic bit for bit) on the
card in tests/test_torch_cuda.py.
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
import knn_micro  # noqa: E402

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


# ------------------------------------------------------------------- K9
K9G = kc.K9_GROUP_ROWS


def _k9_case(name, sms, seed=0):
    """Queries and references of one K9 case (numpy): 1300 queries (two
    whole blocks of 512 and a partial one) against 2100 rows, every 11th
    query masked, the second block's all and a warp's run of the third's;
    at ``sms`` SMs the chunks are single groups (132) or several stages
    (1)."""
    rng = np.random.default_rng(seed)
    n, m, dim = 1300, 2100, 3
    if name == "odd":
        n, m = 1037, 2053                    # off every multiple of 4, 16, 512
    if name == "2d":
        dim = 2
    q = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    r = rng.uniform(-3, 3, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::11] = False
    qm[512:1024] = False                     # a whole block
    qm[1024 + 128:1024 + 256] = False        # a warp's run
    c = kc.k9_split(n, m, sms)[1]
    if name in ("dup", "2d"):
        r[1::4] = r[0::4][:len(r[1::4])]     # ties within a group
        r[K9G + 3::2 * K9G] = r[3:m - K9G:2 * K9G][:len(r[K9G + 3::2 * K9G])]
        w = min(40, c)
        r[c:c + w] = r[c - w:c]              # ties across a chunk boundary
    if name in ("masked_chunk", "odd"):
        rm[c:2 * c] = False                  # the whole second chunk
        rm[c - 1] = rm[2 * c] = False        # and the rows around it
    if name == "negative":                   # two chunks' minima below 0
        hi = c * -(-1000 // c)
        tq, less, more = knn_micro.negative_twins(rng, 40)
        q[:40], qm[:40] = tq, True
        r[:40], r[hi:hi + 40] = less, more
    return q, qm, r, rm


def _assert_k9_bits(q, qm, r, rm, sms):
    d, i = dense_micro.emulate_k9(q, qm, r, rm, sms=sms)
    dp, ip = kc.knn1_mxu_plain(q, qm, r, rm)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    dw, iw = kc.knn1_mxu(q, qm, r, rm)      # the wrapper on CPU tensors
    assert torch.equal(dw, dp) and torch.equal(iw, ip)
    assert bool((i[~qm] == -1).all()) and bool(torch.isinf(d[~qm]).all())
    return i


@pytest.mark.parametrize("sms", [SMS, 1])
@pytest.mark.parametrize("name", ["dup", "masked_chunk", "odd", "2d", "negative"])
def test_k9_schedule_equals_plain(name, sms):
    """Ties within a group, across groups and across a chunk boundary
    resolve to the lowest index; both chunks' minima negative: the later,
    more negative one wins and is clamped to 0 after the merge; an
    all-masked chunk, masked queries, a warp's run and a whole block of
    them; n and m off every multiple; 2-D; chunks of one group (132 SMs)
    and of several stages (one SM)."""
    q, qm, r, rm = _k9_case(name, sms)
    splits, chunk = kc.k9_split(len(q), len(r), sms)
    assert splits >= 4 and chunk % K9G == 0 and len(r) % chunk
    assert (chunk == K9G) == (sms == SMS) and (chunk > 512) == (sms == 1)
    i = _assert_k9_bits(*_t(q, qm, r, rm), sms)
    if name == "negative":                   # a clamp per chunk would pick 0..39
        hi = chunk * -(-1000 // chunk)
        assert torch.equal(i[:40], torch.arange(hi, hi + 40, dtype=torch.int32))
    if name == "dup":                        # ties met: the copies never win
        assert not bool(torch.isin(i, torch.arange(1, len(r), 4)).any())


@pytest.mark.parametrize("m", [1, 5, K9G + 1, 300])
def test_k9_schedule_short_references(m):
    """A reference under one chunk (one split at one SM), under a group and
    under a float4: the padded rows never win."""
    q, qm, r, rm = _k9_case("dup", 1)
    r, rm = r[:m].copy(), rm[:m].copy()
    rm[m // 2] = m == 1
    assert kc.k9_split(len(q), m, 1)[0] == 1
    _assert_k9_bits(*_t(q, qm, r, rm), 1)


def test_k9_schedule_pair_axis():
    """Three pairs in one launch, the chunks cut for three pairs (one with
    every query masked, one with every reference masked): each pair equals
    its own plain version."""
    cases = [_k9_case(c, SMS, seed=s) for s, c in enumerate(("dup", "masked_chunk",
                                                             "negative"))]
    q, qm, r, rm = (torch.stack(x) for x in zip(*(_t(*c) for c in cases)))
    qm[1] = False
    rm[2] = False
    d, i = dense_micro.emulate_k9(q, qm, r, rm, sms=SMS)
    assert kc.k9_split(q.shape[1], r.shape[1], SMS, 3) != kc.k9_split(
        q.shape[1], r.shape[1], SMS)
    for b in range(3):
        dp, ip = kc.knn1_mxu_plain(q[b], qm[b], r[b], rm[b])
        assert torch.equal(d[b], dp) and torch.equal(i[b], ip)
    assert bool((i[1:] == -1).all())


@pytest.mark.parametrize("n,m,pairs", [
    (0, 7, 1), (7, 0, 1), (1, 1, 1), (600, 3, 1), (1300, 2100, 1),
    (20480, 12459, 1), (18795, 49950, 1), (167936, 12462, 1), (18806, 12662, 4),
    (167936, 12565, 1), (300000, 5000, 1), (10 ** 7, 50000, 1)])
def test_k9_split_contract(n, m, pairs):
    """K9's chunks: whole groups of 16 rows covering the reference, none
    empty; at the recorded shapes (tools_torch/dense_micro.py's: the
    sequence's 18 795 × 49 950, the dense batch's 167 936 × 12 462,
    ``register_batch``'s 4 pairs of 18 806 × 12 662) and the tool's 20 480 ×
    12 459 its (query block, chunk) units fill at least 93% of their whole
    waves of 4 blocks on each of 132 SMs; one split where the query blocks
    alone fill its waves; the emulation handles the degenerate shapes."""
    for sms in (1, SMS):
        splits, chunk = kc.k9_split(n, m, sms, pairs)
        assert splits >= 1 and chunk % K9G == 0 and chunk > 0
        assert splits * chunk >= m and (splits - 1) * chunk < max(m, 1)
        units = max(1, -(-n // kc.K9_BLOCK_QUERIES)) * pairs
        slots = kc.K9_BLOCKS_PER_SM * sms
        if units >= kc.K9_MAX_WAVES * slots:
            assert splits == 1
    units = max(1, -(-n // kc.K9_BLOCK_QUERIES)) * pairs * kc.k9_split(
        n, m, SMS, pairs)[0]
    slots = kc.K9_BLOCKS_PER_SM * SMS
    if n >= 18000 and m >= 12000 and n < 10 ** 6:
        assert units / (slots * -(-units // slots)) >= 0.93
    if n * m <= 10 ** 4:
        rng = np.random.default_rng(n + m)
        q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        _assert_k9_bits(*_t(q, np.ones(n, bool), r, np.ones(m, bool)), SMS)


@pytest.mark.parametrize("dim", [3, 2])
def test_k9_schedule_matches_pallas(dim):
    """The same inputs through the Pallas K9 in interpret mode: d² within
    2^-20·(q² + r²max), ids where the neighbour is unique beyond twice
    that, the misses equal."""
    rng = np.random.default_rng(dim + 11)
    n, m = 700, 3000
    q = rng.uniform(-10, 10, (n, dim)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    rm[::17] = False
    d, i = (x.numpy() for x in dense_micro.emulate_k9(*_t(q, qm, r, rm)))
    dj, ij = (np.asarray(x).reshape(-1) for x in kp.knn1_pallas_mxu(q, qm, r, rm))
    fin = np.isfinite(d)
    np.testing.assert_array_equal(fin, np.isfinite(dj))
    tol = 2.0 ** -20 * ((q.astype(np.float64) ** 2).sum(1)
                        + (r[rm].astype(np.float64) ** 2).sum(1).max())
    assert (np.abs(d[fin].astype(np.float64) - dj[fin]) <= tol[fin]).all()
    d64 = ((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    ds = np.sort(np.where(rm[None], d64, np.inf), axis=1)
    unique = fin & ((ds[:, 1] - ds[:, 0]) > 2 * tol)
    assert unique.mean() > 0.8
    np.testing.assert_array_equal(i[unique], ij[unique])
    np.testing.assert_array_equal(i == -1, ij == -1)


def test_k9_reference_within_bound_of_plain():
    """``dense_micro.k9_reference`` (K9's fused arithmetic, which the card
    tests hold the kernel to bit for bit) lies within 2^-20·(q² + r²max) of
    ``knn1_mxu_plain`` and agrees on the misses."""
    q, qm, r, rm = _k9_case("masked_chunk", SMS, seed=5)
    dr, ir = dense_micro.k9_reference(q, qm, r, rm, tile=512)
    dp, ip = (x.numpy() for x in kc.knn1_mxu_plain(*_t(q, qm, r, rm)))
    fin = np.isfinite(dp)
    np.testing.assert_array_equal(fin, np.isfinite(dr))
    tol = 2.0 ** -20 * ((q.astype(np.float64) ** 2).sum(1)
                        + (r[rm].astype(np.float64) ** 2).sum(1).max())
    assert (np.abs(dr[fin].astype(np.float64) - dp[fin]) <= tol[fin]).all()
    np.testing.assert_array_equal(ir == -1, ip == -1)
    assert (ir[fin] == ip[fin]).mean() > 0.99


def test_dense_micro_k9_runs_on_the_cpu(tmp_path):
    """tools_torch/dense_micro.py's ``time`` runs K9 beside K1 at a K1
    input (plain versions), and ``--k9-bits`` writes K9's outputs on the
    first run and holds a second run to them."""
    q, qm, r, rm = _t(*_k9_case("dup", SMS))
    path, bits = tmp_path / "in.pt", str(tmp_path / "k9.pt")
    torch.save({"K1 tiny": {"kernel": "K1", "k": 1, "q": q, "qm": qm, "r": r,
                            "rm": rm}}, path)
    for run in range(2):
        rep = dense_micro.time_kernels(str(path), dense_micro.ROOT, reps=1,
                                       rounds=1, device="cpu", k9_bits=bits)
        k1 = rep["inputs"]["K1 tiny"]
        assert len(k1["K9 ms"]) == 1 and k1["K9 eps_excess"] < 10
        assert k1["K9 splits, chunk"] == list(kc.k9_split(len(q), len(r), 132))
        assert ("K9 written to" in rep) == (run == 0)
    assert rep["K9 equal to " + bits] == {"K1 tiny": True}
