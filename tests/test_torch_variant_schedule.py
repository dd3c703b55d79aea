"""The schedules of T1, T2 and T3 (the chunked, transposed and
matrix-product 1-NN lowerings) and T4 and T5 (K7's min-only ablations) on
the card's terms, on the CPU.

T1: tools_torch/knn_micro.py's ``emulate_t1`` (the reference cut into
chunks by ``knn_variants_cuda.t1_split`` for 132 SMs, blocks of 512
queries whose warps each take a contiguous run, ``x + pen`` staging, two
(min, id) accumulators a query over the rows j ≡ a (mod 2), each updated
with a strict '<', merged once a chunk in (d², id) order, the chunks merged
in order with a strict '<') against the plain version (``knn_brute_force``):
ties within a step, across accumulators (the lower index in either),
across groups and across chunks, an all-masked chunk, masked queries and a
block of them, n and m off every multiple, a reference under one chunk,
chunks of several stages, 2-D and 3-D; the split contract; and the JAX
tool's Pallas T1 in interpret mode.

T2: tools_torch/knn_micro.py's ``emulate_t2`` (the reference cut into
chunks by ``knn_variants_cuda.t2_split`` for an H100's 132 SMs, blocks of
512 queries, ``x + pen``
staging, groups of 8 rows folded with fminf, the best group's first row
equal to its minimum, the chunks merged in order with a strict '<')
against the plain version (``knn_brute_force``, what the wrapper runs on
CPU tensors): ties within a group, across groups and across chunks, an
all-masked chunk, masked queries and a block of them, n and m off every
multiple, a reference under one chunk, 2-D and 3-D; and, at small sizes,
against the JAX tool's Pallas T2 (tools/knn_variants.py) in interpret mode.

T3: tools_torch/knn_micro.py's ``emulate_t3`` (the reference cut into
chunks by ``knn_variants_cuda.t3_split``, blocks of 64 queries, each
row's 16 threads taking 8 columns of every 128-column tile as one group
folded with fmin, the best group's first column equal to its minimum, the
threads' (d², id) reduced lexicographically once a chunk, the chunks
merged unclamped in order with a strict '<', then the clamp at 0) against
``knn1_mxu3_plain``: ties within a group, across groups, across the
threads of a row and across chunks, two chunks whose minima are both
negative (the more negative, in the later chunk, wins), an all-masked
chunk, masked queries and a block of them, n and m off every multiple, a
reference under one chunk, 2-D and 3-D, coordinates below 1e-19; and, at a
small size, against the JAX tool's Pallas T3 in interpret mode.

T4: tools_torch/tile_kernel_micro.py's ``emulate_t4`` (tiles in blocks of
``T4_THREADS // t4_team(TQ)``, stages of ``4 * team`` columns, each four
columns copied with those past M zero-filled and folded, whole groups of
8) against ``tile_min_plain``: stage and block boundaries, M % 4 != 0,
M under one stage, TQ under a warp and over one slice, 2-D.

T5: ``emulate_t5`` (one tile a block, ``tile_cuda.t5_shape``'s teams
sweeping contiguous runs of whole groups, the zero-filled and folded tail,
the slices' minima folded) against ``tile_min_plain``: M under the
block's slices × 8 (empty slices), M % 4 != 0, TQ under a warp and over
one block's slice, 2-D.

Tolerances: the emulations equal the plain versions bit for bit, d² and
ids (the same rounded operations; the lowest index first). Against the
interpret-mode Pallas T1 and T2 (XLA's CPU compiler contracts ``d2 + diff *
diff`` into fused multiply-adds): d² within 2 ulp, as
tests/test_torch_knn_variants.py states, and ids where the neighbour is
unique beyond that; against the Pallas T3: d² within 2^-20·(q² + r²max),
as that file states, and ids where the neighbour is unique beyond it.
The kernels themselves are held to the plain versions on the card in
tests/test_torch_cuda.py.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from libpointmatcher_tpu_torch.ops import knn_cuda as kc
from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
from libpointmatcher_tpu_torch.ops import tile_cuda as tc
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools_torch"))
import knn_micro  # noqa: E402
import tile_kernel_micro  # noqa: E402

SMS = 132          # an H100's SMs
G = kc.GROUP_ROWS
STAGE = kv.T2_CHUNK_ROWS


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, ROOT / path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jkv = _load("jax_knn_variants_t2", "tools/knn_variants.py")


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jkv.pl, "pallas_call", patched)


def _case(name, seed=0):
    """Queries and references of one T2 case (numpy): 1100 queries (two
    whole blocks and a partial one) against 2100 rows (five chunks of 512,
    the last 52), every 11th query masked and the second block's queries
    all but one."""
    rng = np.random.default_rng(seed)
    n, m, dim = 1100, 2100, 3
    if name == "odd":
        n, m = 1037, 2053                    # off every multiple of 4, G, a block
    if name == "2d":
        dim = 2
    q = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    r = rng.uniform(-3, 3, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::11] = False
    qm[512:1024] = False                     # the second block: all masked
    qm[700] = True                           # but one
    c = kv.t2_split(n, m, SMS)[1]
    if name in ("dup", "2d"):
        r[1:c:4] = r[0:c:4]                  # ties within a group
        r[G + 16:c:16] = r[16:c - G:16]      # ties across groups
        r[c:c + 200] = r[c - 200:c]          # ties across a chunk boundary
        r[3 * c:3 * c + 50] = r[2 * c:2 * c + 50]
    if name in ("masked_chunk", "odd"):
        rm[c:2 * c] = False                  # the whole second chunk
        rm[c - 1] = rm[2 * c] = False        # and the rows around it
    return q, qm, r, rm


def _t(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _assert_t2_bits(q, qm, r, rm, sms=SMS):
    d, i = knn_micro.emulate_t2(q, qm, r, rm, sms=sms)
    db, ib = knn_brute_force(q, qm, r, rm, k=1)
    assert torch.equal(d, db[:, 0]) and torch.equal(i, ib[:, 0])
    # the wrapper on CPU tensors runs the plain version
    dw, iw = kv.knn1_transposed(q, qm, r, rm)
    assert torch.equal(dw, db[:, 0]) and torch.equal(iw, ib[:, 0])
    assert bool((i[~qm] == -1).all()) and bool(torch.isinf(d[~qm]).all())


@pytest.mark.parametrize("name", ["dup", "masked_chunk", "odd", "2d"])
def test_t2_schedule_equals_plain(name):
    """Ties within a group, across groups and across a chunk boundary
    resolve to the lowest index; an all-masked chunk, masked queries and a
    block of them; n and m off every multiple; 2-D."""
    q, qm, r, rm = _case(name)
    splits, chunk = kv.t2_split(len(q), len(r), SMS)
    assert splits >= 4 and chunk == STAGE and len(r) % chunk   # the last partial
    _assert_t2_bits(*_t(q, qm, r, rm))


@pytest.mark.parametrize("m", [1, 5, G + 1, 300])
def test_t2_schedule_short_references(m):
    """A reference under one chunk (one split), under a group and under a
    float4: the padded rows never win."""
    q, qm, r, rm = _case("dup")
    r, rm = r[:m].copy(), rm[:m].copy()
    rm[m // 2] = m == 1
    assert kv.t2_split(len(q), m, SMS)[0] == 1
    _assert_t2_bits(*_t(q, qm, r, rm))


def test_t2_schedule_multi_stage_chunks():
    """Chunks of several 512-row stages (the split cut for one SM: 6 chunks
    of 1536 rows), the last partial, ties across a chunk boundary."""
    q, qm, r, rm = _case("dup")
    r = np.concatenate([r] * 5)[:9000]
    rm = np.concatenate([rm] * 5)[:9000]
    splits, chunk = kv.t2_split(len(q), len(r), 1)
    assert (splits, chunk) == (6, 3 * STAGE) and len(r) % chunk
    r[chunk:chunk + 300] = r[chunk - 300:chunk]
    _assert_t2_bits(*_t(q, qm, r, rm), sms=1)


@pytest.mark.parametrize("n,m", [(0, 7), (7, 0), (1, 1), (600, 3), (20480, 12459),
                                 (18820, 49950), (300000, 5000)])
def test_t2_split_contract(n, m):
    """T2's chunks (K1's rule at T2's block and stage): whole 512-row
    stages covering the reference, none empty, split only while the blocks
    of 512 queries stay under 16 an SM; the emulation handles the
    degenerate shapes."""
    for sms in (1, SMS):
        splits, chunk = kv.t2_split(n, m, sms)
        assert splits >= 1 and chunk % STAGE == 0 and chunk > 0
        assert splits * chunk >= m and (splits - 1) * chunk < max(m, 1)
        qblocks = max(1, -(-n // kv.T2_BLOCK_QUERIES))
        if splits > 1:
            assert qblocks * (splits - 1) < kv.T2_BLOCKS_PER_SM * sms
    if n * m <= 10 ** 4:
        rng = np.random.default_rng(n + m)
        q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        _assert_t2_bits(*_t(q, np.ones(n, bool), r, np.ones(m, bool)))


@pytest.mark.parametrize("dim", [3, 2])
def test_t2_schedule_matches_pallas(dim, interpret_mode):
    """The same inputs through the JAX tool's Pallas T2 in interpret mode:
    d² within 2 ulp, ids where the neighbour is unique beyond that."""
    rng = np.random.default_rng(dim)
    n, m = 700, 3000
    q = rng.uniform(-10, 10, (n, dim)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    rm[::17] = False
    d, i = (x.numpy() for x in knn_micro.emulate_t2(*_t(q, qm, r, rm)))
    dj, ij = (np.asarray(x) for x in jkv.knn1_transposed(
        *(jnp.asarray(a) for a in (q, qm, r, rm))))
    fin = np.isfinite(d)
    np.testing.assert_array_equal(fin, np.isfinite(dj))
    tol = np.where(fin, 2 * np.spacing(np.abs(dj).astype(np.float32)), 0.0)
    assert (np.abs(d[fin].astype(np.float64) - dj[fin]) <= tol[fin]).all()
    d64 = ((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    ds = np.sort(np.where(rm[None], d64, np.inf), axis=1)
    unique = fin & ((ds[:, 1] - ds[:, 0]) > 2 * tol)
    assert unique.mean() > 0.8
    np.testing.assert_array_equal(i[unique], ij[unique])
    np.testing.assert_array_equal(i == -1, ij == -1)


def _assert_t1_bits(q, qm, r, rm, sms=SMS):
    d, i = knn_micro.emulate_t1(q, qm, r, rm, sms=sms)
    db, ib = knn_brute_force(q, qm, r, rm, k=1)
    assert torch.equal(d, db[:, 0]) and torch.equal(i, ib[:, 0])
    # the wrapper on CPU tensors runs the plain version
    dw, iw = kv.knn1_chunked(q, qm, r, rm)
    assert torch.equal(dw, db[:, 0]) and torch.equal(iw, ib[:, 0])
    assert bool((i[~qm] == -1).all()) and bool(torch.isinf(d[~qm]).all())
    return i


@pytest.mark.parametrize("name", ["dup", "accumulators", "masked_chunk", "odd",
                                  "2d"])
def test_t1_schedule_equals_plain(name):
    """Ties within a step, across the accumulators (rows 8k + 1 and 8k + 2,
    the lower index odd; rows 4k and 4k + 1, the lower even), across
    groups and across a chunk boundary resolve to the lowest index; an
    all-masked chunk, masked queries and a block of them; n and m off
    every multiple; 2-D."""
    q, qm, r, rm = _case("dup" if name == "accumulators" else name)
    splits, chunk = kv.t1_split(len(q), len(r), SMS)
    assert splits >= 4 and chunk == kv.T1_CHUNK_ROWS and len(r) % chunk
    if name == "accumulators":
        r[2::8] = r[1::8][:len(r[2::8])]
    i = _assert_t1_bits(*_t(q, qm, r, rm))
    if name == "accumulators":               # the higher of two equal rows never wins
        assert not bool(torch.isin(i, torch.arange(2, len(r), 8)).any())
        assert bool(torch.isin(i, torch.arange(1, len(r), 8)).any())


@pytest.mark.parametrize("m", [1, 5, G + 1, 300])
def test_t1_schedule_short_references(m):
    """A reference under one chunk (one split), under a step and under a
    float4: the padded rows never win."""
    q, qm, r, rm = _case("dup")
    r, rm = r[:m].copy(), rm[:m].copy()
    rm[m // 2] = m == 1
    assert kv.t1_split(len(q), m, SMS)[0] == 1
    _assert_t1_bits(*_t(q, qm, r, rm))


def test_t1_schedule_multi_stage_chunks():
    """Chunks of several 512-row stages (the split cut for one SM: 6 chunks
    of 1536 rows), the last partial, ties across a chunk boundary."""
    q, qm, r, rm = _case("dup")
    r = np.concatenate([r] * 5)[:9000]
    rm = np.concatenate([rm] * 5)[:9000]
    splits, chunk = kv.t1_split(len(q), len(r), 1)
    assert (splits, chunk) == (6, 3 * kv.T1_CHUNK_ROWS) and len(r) % chunk
    r[chunk:chunk + 300] = r[chunk - 300:chunk]
    _assert_t1_bits(*_t(q, qm, r, rm), sms=1)


@pytest.mark.parametrize("n,m", [(0, 7), (7, 0), (1, 1), (600, 3), (20480, 12459),
                                 (18820, 49950), (300000, 5000)])
def test_t1_split_contract(n, m):
    """T1's chunks (K1's rule at T1's block and stage): whole 512-row
    stages covering the reference, none empty, split only while the blocks
    of 512 queries stay under 16 an SM, more than one split at the tools'
    shapes; the emulation handles the degenerate shapes."""
    assert kv.T1_BLOCK_QUERIES == 512 and kv.T1_CHUNK_ROWS % G == 0
    for sms in (1, SMS):
        splits, chunk = kv.t1_split(n, m, sms)
        assert splits >= 1 and chunk % kv.T1_CHUNK_ROWS == 0 and chunk > 0
        assert splits * chunk >= m and (splits - 1) * chunk < max(m, 1)
        qblocks = max(1, -(-n // kv.T1_BLOCK_QUERIES))
        if splits > 1:
            assert qblocks * (splits - 1) < kv.T1_BLOCKS_PER_SM * sms
    if (n, m) in ((20480, 12459), (18820, 49950)):
        assert kv.t1_split(n, m, SMS)[0] > 1
    if n * m <= 10 ** 4:
        rng = np.random.default_rng(n + m)
        q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        _assert_t1_bits(*_t(q, np.ones(n, bool), r, np.ones(m, bool)))


@pytest.mark.parametrize("dim", [3, 2])
def test_t1_schedule_matches_pallas(dim, interpret_mode):
    """The same inputs through the JAX tool's Pallas T1 in interpret mode:
    d² within 2 ulp, ids where the neighbour is unique beyond that."""
    rng = np.random.default_rng(dim + 3)
    n, m = 700, 3000
    q = rng.uniform(-10, 10, (n, dim)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    rm[::17] = False
    d, i = (x.numpy() for x in knn_micro.emulate_t1(*_t(q, qm, r, rm)))
    dj, ij = (np.asarray(x) for x in jkv.knn1_chunked(
        *(jnp.asarray(a) for a in (q, qm, r, rm))))
    fin = np.isfinite(d)
    np.testing.assert_array_equal(fin, np.isfinite(dj))
    tol = np.where(fin, 2 * np.spacing(np.abs(dj).astype(np.float32)), 0.0)
    assert (np.abs(d[fin].astype(np.float64) - dj[fin]) <= tol[fin]).all()
    d64 = ((q[:, None].astype(np.float64) - r[None].astype(np.float64)) ** 2).sum(-1)
    ds = np.sort(np.where(rm[None], d64, np.inf), axis=1)
    unique = fin & ((ds[:, 1] - ds[:, 0]) > 2 * tol)
    assert unique.mean() > 0.8
    np.testing.assert_array_equal(i[unique], ij[unique])
    np.testing.assert_array_equal(i == -1, ij == -1)


def _tile_case(T, tq, m, dim, seed=0):
    """Tiles with ties (every fourth candidate a copy of the one before)
    and a padded tail (pen +inf), as tests/test_torch_cuda.py's."""
    rng = np.random.default_rng(seed)
    q = np.zeros((T, tq, 8), np.float32)
    q[..., :dim] = rng.uniform(-2, 2, (T, tq, dim))
    cand = np.zeros((T, 8, m), np.float32)
    cand[:, :3] = rng.uniform(-2, 2, (T, 3, m))     # row 2 ignored in 2-D
    cand[:, :dim, 1::4] = cand[:, :dim, 0::4][..., :cand[:, :, 1::4].shape[2]]
    cand[:, 7] = np.arange(m, dtype=np.float32)
    for t, pad in enumerate(rng.integers(0, max(1, m // 3), T)):
        cand[t, tc.PEN_ROW, m - pad:] = np.inf
    return torch.from_numpy(q), torch.from_numpy(cand)


@pytest.mark.parametrize("T,tq,m,dim", [
    (37, 64, 1024, 3),      # 16 tiles a block, the last block partial
    (5, 256, 600, 3),       # 4 tiles a block, a partial last stage
    (11, 24, 1001, 3),      # M % 4 != 0: the 4-byte copies' zero fill
    (6, 20, 30, 2),         # M under one stage, TQ under a warp, 2-D
    (3, 1100, 130, 3),      # a tile in two slices of 1024 queries
    (17, 5, 4, 3)])         # one group, mostly padding
def test_t4_schedule_equals_plain(T, tq, m, dim):
    """T4's split of work (blocks of tiles, stages of 4·team columns, the
    zero-filled and folded tail, whole groups) gives ``tile_min_plain``'s
    minimum bit for bit; on CPU tensors the wrapper runs the plain version."""
    q, cand = _tile_case(T, tq, m, dim, seed=T + tq + m)
    dp = tc.tile_min_plain(q, cand, dim)
    assert torch.equal(tile_kernel_micro.emulate_t4(q, cand, dim), dp)
    assert torch.equal(tc.tile_min_only(q, cand, dim), dp)


def test_t4_shape_rule():
    """Threads a tile: the fewest of 8..256 whose four queries each cover
    TQ (the tool's 256: 64, four tiles a block; K7's 64: 16, sixteen), and
    the wrapper takes any M (K7's per-tile form a multiple of 128)."""
    assert [tc.t4_team(t) for t in (1, 32, 33, 64, 256, 512, 700, 1100)] == \
        [8, 8, 16, 16, 64, 128, 256, 256]
    assert tc.T4_COLS == 4 * tc.T4_THREADS            # four columns a thread
    q, cand = _tile_case(2, 8, 13, 3)
    with pytest.raises(ValueError, match="multiple of 128"):
        tc.tile_sweep(q, cand, 3)
    assert tc.tile_min_only(q, cand, 3).shape == (2, 8)


def _t3_case(name, seed=0):
    """Queries and references of one T3 case (numpy): 1100 queries (17
    whole blocks of 64 and a partial one) against 2100 rows (nine chunks of
    256, the last 52), every 11th query masked, the sixth block's all and
    the fifth's all but one."""
    rng = np.random.default_rng(seed)
    n, m, dim = 1100, 2100, 3
    if name == "odd":
        n, m = 1037, 2053                    # off every multiple of 4, 8, 128
    if name == "2d":
        dim = 2
    q = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    r = rng.uniform(-3, 3, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::11] = False
    qm[256:384] = False                      # two blocks of 64: all masked
    qm[300] = True                           # but one in the first
    c = kv.t3_split(n, m, SMS)[1]
    if name in ("dup", "2d"):
        r[1:c:8] = r[0:c:8]                  # ties within a thread's group
        r[4:c:8] = r[0:c:8]                  # across the threads of a row
        r[128 + 16:128 + 32] = r[16:32]      # across groups (tiles)
        r[c:c + 100] = r[c - 100:c]          # across a chunk boundary
        r[3 * c:3 * c + 50] = r[2 * c:2 * c + 50]
    if name in ("masked_chunk", "odd"):
        rm[c:2 * c] = False                  # the whole second chunk
        rm[c - 1] = rm[2 * c] = False        # and the rows around it
    if name == "negative":                   # both chunks' minima below 0
        tq, less, more = knn_micro.negative_twins(rng, 40)
        q[:40], qm[:40] = tq, True
        r[10:50], r[c + 10:c + 50] = less, more
    if name == "tiny":                       # subnormal products
        q, r = q * np.float32(1e-20), r * np.float32(1e-20)
    return q, qm, r, rm


def _assert_t3_bits(q, qm, r, rm, sms=SMS):
    d, i = knn_micro.emulate_t3(q, qm, r, rm, sms=sms)
    dp, ip = kv.knn1_mxu3_plain(q, qm, r, rm)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    # the wrapper on CPU tensors runs the plain version
    dw, iw = kv.knn1_mxu(q, qm, r, rm)
    assert torch.equal(dw, dp) and torch.equal(iw, ip)
    assert bool((i[~qm] == -1).all()) and bool(torch.isinf(d[~qm]).all())
    return i


@pytest.mark.parametrize("name", ["dup", "masked_chunk", "odd", "2d", "negative",
                                  "tiny"])
def test_t3_schedule_equals_plain(name):
    """Ties within a group, across groups, across the threads of a row and
    across a chunk boundary resolve to the lowest index; both chunks'
    minima negative: the more negative wins, clamped to 0 after the merge;
    an all-masked chunk, masked queries and a block of them; n and m off
    every multiple; 2-D; coordinates below 1e-19."""
    q, qm, r, rm = _t3_case(name)
    splits, chunk = kv.t3_split(len(q), len(r), SMS)
    assert splits >= 4 and chunk == kv.T3_CHUNK_COLS and len(r) % chunk
    i = _assert_t3_bits(*_t(q, qm, r, rm))
    if name == "negative":                   # a clamp per chunk would pick 10..49
        assert torch.equal(i[:40], torch.arange(chunk + 10, chunk + 50,
                                                dtype=torch.int32))
    if name == "dup":                        # ties met: the copies never win
        assert not bool(torch.isin(i, torch.arange(1, chunk, 8)).any())


@pytest.mark.parametrize("m", [1, 5, G + 1, 200])
def test_t3_schedule_short_references(m):
    """A reference under one chunk (one split), under a group and under a
    float4: the padded columns never win."""
    q, qm, r, rm = _t3_case("dup")
    r, rm = r[:m].copy(), rm[:m].copy()
    rm[m // 2] = m == 1
    assert kv.t3_split(len(q), m, SMS)[0] == 1
    _assert_t3_bits(*_t(q, qm, r, rm))


def test_t3_schedule_multi_stage_chunks():
    """Chunks of several 256-column stages (the split cut for eight SMs: 4
    chunks of 1792 columns), the last partial, ties across a chunk
    boundary, a chunk's minimum below 0."""
    q, qm, r, rm = _t3_case("negative")
    r = np.concatenate([r] * 4)[:7000]
    rm = np.concatenate([rm] * 4)[:7000]
    splits, chunk = kv.t3_split(len(q), len(r), 8)
    assert (splits, chunk) == (4, 7 * kv.T3_CHUNK_COLS) and len(r) % chunk
    r[chunk:chunk + 300] = r[chunk - 300:chunk]
    _assert_t3_bits(*_t(q, qm, r, rm), sms=8)


@pytest.mark.parametrize("dim", [3, 2])
def test_t3_schedule_matches_pallas(dim, interpret_mode):
    """The same inputs through the JAX tool's Pallas T3 in interpret mode:
    d² within 2^-20·(q² + r²max), ids where the neighbour is unique beyond
    that."""
    rng = np.random.default_rng(dim + 7)
    n, m = 700, 3000
    q = rng.uniform(-10, 10, (n, dim)).astype(np.float32)
    r = rng.uniform(-10, 10, (m, dim)).astype(np.float32)
    qm = np.ones(n, bool)
    qm[int(n * 0.93):] = False
    rm = np.ones(m, bool)
    rm[::17] = False
    d, i = (x.numpy() for x in knn_micro.emulate_t3(*_t(q, qm, r, rm)))
    dj, ij = (np.asarray(x) for x in jkv.knn1_mxu(
        *(jnp.asarray(a) for a in (q, qm, r, rm))))
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


@pytest.mark.parametrize("n,m", [(0, 7), (7, 0), (1, 1), (600, 3), (20480, 12459),
                                 (18820, 49950), (300000, 5000)])
def test_t3_split_contract(n, m):
    """T3's chunks (K1's rule at T3's block and stage): whole 256-column
    stages covering the reference, none empty, split only while the blocks
    of 64 queries stay under 8 an SM, more than one split at the tools'
    shapes; the emulation handles the degenerate shapes."""
    for sms in (1, SMS):
        splits, chunk = kv.t3_split(n, m, sms)
        assert splits >= 1 and chunk % kv.T3_CHUNK_COLS == 0 and chunk > 0
        assert splits * chunk >= m and (splits - 1) * chunk < max(m, 1)
        qblocks = max(1, -(-n // kv.T3_BLOCK_QUERIES))
        if splits > 1:
            assert qblocks * (splits - 1) < kv.T3_BLOCKS_PER_SM * sms
    if (n, m) in ((20480, 12459), (18820, 49950)):
        assert kv.t3_split(n, m, SMS)[0] > 1
    if n * m <= 10 ** 4:
        rng = np.random.default_rng(n + m)
        q = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
        r = rng.uniform(-1, 1, (m, 3)).astype(np.float32)
        _assert_t3_bits(*_t(q, np.ones(n, bool), r, np.ones(m, bool)))


@pytest.mark.parametrize("T,tq,m,dim", [
    (7, 64, 1024, 3),       # K7's shape: 16 threads a team, 16 slices of 64
    (5, 256, 600, 3),       # the tool's TQ: 4 slices, the last short
    (11, 24, 1001, 3),      # M % 4 != 0: the 4-byte copies' zero fill
    (6, 20, 30, 2),         # M under 32 slices x 8: empty slices, 2-D
    (3, 1100, 130, 3),      # a tile in two slices of 1024 queries, one team
    (17, 5, 4, 3)])         # one group, mostly padding
def test_t5_schedule_equals_plain(T, tq, m, dim):
    """T5's split of work (one tile a block, teams sweeping runs of whole
    groups, the zero-filled and folded tail, empty slices, the slices'
    minima folded) gives ``tile_min_plain``'s minimum bit for bit; on CPU
    tensors the wrapper runs the plain version."""
    q, cand = _tile_case(T, tq, m, dim, seed=T + tq + m + 1)
    dp = tc.tile_min_plain(q, cand, dim)
    assert torch.equal(tile_kernel_micro.emulate_t5(q, cand, dim), dp)
    assert torch.equal(tc.tile_min_one(q, cand, dim), dp)


def test_t5_shape_rule():
    """Teams: T4's threads a tile capped at 256, slices the rest of 256
    threads (the tool's TQ 256: 64 x 4; K7's 64: 16 x 16), each a run of
    whole groups; the list and the scratch fit in 232 448 bytes up to
    ``MIN_ONE_MAX`` columns, which the wrapper enforces."""
    shapes = [tc.t5_shape(tq, m) for tq, m in
              ((256, 4096), (64, 1024), (20, 30), (1100, 130), (5, 4), (33, 1001))]
    assert shapes == [(64, 4, 1024), (16, 16, 64), (8, 32, 8), (256, 1, 136),
                      (8, 32, 8), (16, 16, 64)]
    for tq, m in ((256, 4096), (20, 30), (33, 1001)):
        team, slices, span = tc.t5_shape(tq, m)
        assert team * slices == tc.T5_THREADS and span % 8 == 0
        assert slices * (span - 8) < m <= slices * span
    mp = -(-tc.MIN_ONE_MAX // 8) * 8
    assert 4 * (3 * mp + 4 * tc.T5_THREADS) <= 232448
    assert 4 * (3 * (mp + 8) + 4 * tc.T5_THREADS) > 232448
    q, cand = _tile_case(1, 8, tc.MIN_ONE_MAX + 1, 3)
    with pytest.raises(ValueError, match="at most"):
        tc.tile_min_one(q, cand, 3)
