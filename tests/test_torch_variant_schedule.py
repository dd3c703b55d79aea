"""The schedules of T2 (the transposed 1-NN lowering) and T4 (K7's min-only
ablation) on the card's terms, on the CPU.

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

T4: tools_torch/tile_kernel_micro.py's ``emulate_t4`` (tiles in blocks of
``T4_THREADS // t4_team(TQ)``, stages of ``4 * team`` columns, each four
columns copied with those past M zero-filled and folded, whole groups of
8) against ``tile_min_plain``: stage and block boundaries, M % 4 != 0,
M under one stage, TQ under a warp and over one slice, 2-D.

Tolerances: the emulations equal the plain versions bit for bit, d² and
ids (the same rounded operations; the lowest index first). Against the
interpret-mode Pallas T2 (XLA's CPU compiler contracts ``d2 + diff *
diff`` into fused multiply-adds): d² within 2 ulp, as
tests/test_torch_knn_variants.py states, and ids where the neighbour is
unique beyond that. The kernels themselves are held to the plain versions
on the card in tests/test_torch_cuda.py.
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
