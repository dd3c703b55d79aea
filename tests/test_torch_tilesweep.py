"""The tile sweep of the port (``ops/tilesweep.py``, ``ops/tile_cuda.py``,
``ops/knn_self.py``) against the JAX package's ``ops/tilesweep.py`` and
``ops/knn_self.py`` on the CPU.

Held equal: the host tables (sub-blocks, units, tile assignments) array for
array, the gathered candidate tables, and every step function's ids.

Tolerances. The port forms d² = ((pen + dx²) + dy²) + dz², each step
rounded, as K7 and K8 do on the card. The JAX package's Pallas kernels run
here in interpret mode and its fallbacks through XLA's CPU compiler, which
may contract ``d2 + diff * diff`` into fused multiply-adds, so d² is held
within 2 ulp of theirs (one per contracted addition), ROADMAP Queue 3's last
paragraph. Ids are held exactly against the XLA fallbacks, ties included
(the references hold exact duplicate rows; both keep the lowest candidate
position), and against the Pallas kernels where the neighbour is unique:
the Pallas 1-NN kernel keeps a per-lane minimum, so among equal distances
its winner depends on the position mod 128 (ROADMAP Queue 3 #12).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import libpointmatcher_tpu.ops.tilesweep as jts
from libpointmatcher_tpu.ops.knn_self import knn_self_culled as jax_knn_self

from libpointmatcher_tpu_torch.ops import knn_self, tile_cuda
from libpointmatcher_tpu_torch.ops.dispatch import apply_max_dist
from libpointmatcher_tpu_torch.ops import tilesweep as ts
from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

ULP2 = 2.0 ** -22        # 2 ulp of float32, relative


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(jts.pl, "pallas_call", patched)


def _cloud(rng, n, d, spread=3.0, dup=True):
    """Uniform points, every fourth row a copy of the one before (ties)."""
    p = rng.uniform(-spread, spread, (n, d)).astype(np.float32)
    if dup:
        p[1::4] = p[::4][: len(p[1::4])]
    return p


def _case(name):
    """(query, qmask, ref, rmask, cell, tile_q, block_cap) of a named case."""
    rng = np.random.default_rng(CASES.index(name))
    d = 2 if name == "2d" else 3
    r = _cloud(rng, 900, d)
    q = rng.uniform(-3, 3, (700, d)).astype(np.float32)
    qm = np.ones(len(q), bool)
    rm = np.ones(len(r), bool)
    cell, tq, cap = 0.8, 64, 1024
    if name == "masked":
        qm[::7] = False
        rm[::5] = False
    elif name == "empty_ref":
        rm[:] = False
    elif name == "outside":
        q[::3] += 10.0                       # cells outside the grid
    elif name == "split":
        cell, tq, cap = 1.5, 128, 128        # unions above the cap: vtiles
    return q, qm, r, rm, cell, tq, cap


CASES = ["3d", "2d", "masked", "empty_ref", "outside", "split"]


def _assert_d2(a, b):
    a, b = np.asarray(a), np.asarray(b)
    fin = np.isfinite(b)
    assert np.array_equal(np.isfinite(a), fin)
    np.testing.assert_allclose(a[fin], b[fin], rtol=ULP2, atol=0)


@pytest.mark.parametrize("name", CASES)
def test_host_tables_equal_jax(name):
    q, qm, r, rm, cell, tq, cap = _case(name)
    sj = jts.build_sub_blocks(r, rm, cell)
    sp = ts.build_sub_blocks(r, rm, cell)
    for field in ("pts", "ids", "units", "ulins", "start", "nsub", "pcount",
                  "origin"):
        np.testing.assert_array_equal(getattr(sp, field),
                                      np.asarray(getattr(sj, field)), field)
    assert sp.dims == sj.dims and sp.cell_size == sj.cell_size
    aj = jts.assign_tiles(q, qm, sj, tile_q=tq, block_cap=cap, to_device=False)
    ap = ts.assign_tiles(q, qm, sp, tile_q=tq, block_cap=cap)
    for field in ("q_rows", "blocks", "parent", "vrows"):
        np.testing.assert_array_equal(getattr(ap, field), getattr(aj, field),
                                      field)
        assert getattr(ap, field).dtype == np.int32
    assert ap.touched == aj.touched
    if name == "split":
        assert ap.vrows.shape[0] > 1         # a merge depth above 1
    np.testing.assert_array_equal(ap.vtile_q_rows(), aj.vtile_q_rows())


def test_pad_blocks_to_is_rounded_to_even():
    """An odd ``pad_blocks_to`` would make M = 64·B an odd multiple of 64,
    which the kernels refuse; the port rounds it up, the JAX package takes
    it as given (ROADMAP Queue 3 #14)."""
    q, qm, r, rm, cell, tq, cap = _case("3d")
    sp = ts.build_sub_blocks(r, rm, cell)
    sj = jts.build_sub_blocks(r, rm, cell)
    for pad in (17, 33):
        ap = ts.assign_tiles(q, qm, sp, tile_q=tq, pad_blocks_to=pad)
        assert ap.blocks.shape[1] == pad + 1
        assert jts.assign_tiles(q, qm, sj, tile_q=tq, pad_blocks_to=pad,
                                to_device=False).blocks.shape[1] == pad
        aj = jts.assign_tiles(q, qm, sj, tile_q=tq, pad_blocks_to=pad + 1,
                              to_device=False)
        np.testing.assert_array_equal(ap.blocks, aj.blocks)
    empty = ts.assign_tiles(q, np.zeros_like(qm), sp, pad_blocks_to=21)
    assert empty.blocks.shape[1] == 22


@pytest.mark.parametrize("name", ["3d", "2d", "split"])
def test_gather_candidates_equal_jax(name):
    q, qm, r, rm, cell, tq, cap = _case(name)
    sj = jts.build_sub_blocks(r, rm, cell)
    aj = jts.assign_tiles(q, qm, sj, tile_q=tq, block_cap=cap, to_device=False)
    cj = jts.gather_candidates(sj, jnp.asarray(aj.blocks))
    sp = ts.build_sub_blocks(r, rm, cell)
    cp = ts.gather_candidates(torch.from_numpy(sp.units),
                              torch.from_numpy(aj.blocks)).numpy()
    np.testing.assert_array_equal(cp, np.asarray(cj[0]))
    # JAX's separate pen and cid are rows 6 and 7 of the table
    np.testing.assert_array_equal(cp[:, 6:7], np.asarray(cj[1]))
    np.testing.assert_array_equal(cp[:, 7:8].astype(np.int32), np.asarray(cj[2]))
    # a stacked [B, T, B'] assignment gathers scan by scan
    both = torch.from_numpy(np.stack([aj.blocks, aj.blocks[::-1].copy()]))
    cb = ts.gather_candidates(torch.from_numpy(sp.units), both)
    np.testing.assert_array_equal(cb[0].numpy(), np.asarray(cj[0]))
    assert cb.shape[:2] == (2, aj.blocks.shape[0])


def _kernel_inputs(name):
    """Queries per virtual tile and candidate tables of a case, as the
    engine hands them to the sweep."""
    q, qm, r, rm, cell, tq, cap = _case(name)
    sj = jts.build_sub_blocks(r, rm, cell)
    aj = jts.assign_tiles(q, qm, sj, tile_q=tq, block_cap=cap, to_device=False)
    cand_t, pen, cid = jts.gather_candidates(sj, jnp.asarray(aj.blocks))
    rows = aj.vtile_q_rows()
    qt = np.zeros(rows.shape + (8,), np.float32)
    qt[..., :q.shape[1]] = q[np.maximum(rows, 0)]
    return qt, np.array(cand_t), pen, cid, q.shape[1]


def _unique(d_sorted):
    """Slots whose distance differs from both neighbours in the sorted list
    by more than 4 ulp: the neighbour at that rank is unique."""
    d = np.asarray(d_sorted, np.float64)
    gap = 8 * ULP2 * np.abs(d) + 1e-30
    lo = np.concatenate([np.full_like(d[..., :1, :], -np.inf), d[..., :-1, :]], -2)
    hi = np.concatenate([d[..., 1:, :], np.full_like(d[..., :1, :], np.inf)], -2)
    with np.errstate(invalid="ignore"):
        return np.isfinite(d) & (d - lo > gap) & (hi - d > gap)


@pytest.mark.parametrize("name", ["3d", "2d", "masked", "split"])
def test_k7_plain_matches_pallas_and_xla(name, interpret_mode):
    qt, cand_t, pen, cid, d = _kernel_inputs(name)
    dp, ip = tile_cuda.tile_sweep(torch.from_numpy(qt), torch.from_numpy(cand_t), d)
    dp, ip = dp.numpy(), ip.numpy()
    args = (jnp.asarray(qt), jnp.asarray(cand_t), pen, cid)
    dx, ix = (np.asarray(x) for x in jts._tile_sweep_xla(*args, dim=d))
    _assert_d2(dp, dx)
    ix = np.where(np.isfinite(dx), ix, -1)
    np.testing.assert_array_equal(ip, ix)             # ties included
    dpal, ipal = (np.asarray(x) for x in jts._tile_sweep_pallas(*args, dim=d))
    _assert_d2(dp, dpal)
    dk, _ = tile_cuda.tile_sweep_k(torch.from_numpy(qt),
                                   torch.from_numpy(cand_t), d, 2)
    unique = _unique(dk.numpy())[:, 0, :]
    assert unique.sum() > 300
    np.testing.assert_array_equal(ip[unique], ipal[unique])
    # the duplicated rows make ties: the lowest position wins them
    assert (~unique & np.isfinite(dp)).any()


@pytest.mark.parametrize("k", [2, 10, 32])
@pytest.mark.parametrize("name", ["3d", "split"])
def test_k8_plain_matches_pallas_and_xla(name, k, interpret_mode):
    qt, cand_t, pen, cid, d = _kernel_inputs(name)
    dp, ip = (x.numpy() for x in tile_cuda.tile_sweep_k(
        torch.from_numpy(qt), torch.from_numpy(cand_t), d, k))
    assert dp.shape == (qt.shape[0], k, qt.shape[1])
    args = (jnp.asarray(qt), jnp.asarray(cand_t), pen, cid)
    dx, ix = (np.asarray(x) for x in jts._tile_sweep_xla_k(*args, dim=d, k=k))
    _assert_d2(dp, dx)
    np.testing.assert_array_equal(ip, np.where(np.isfinite(dx), ix, -1))
    dpal, ipal = (np.asarray(x) for x in
                  jts._tile_sweep_pallas_k(*args, dim=d, k=k))
    _assert_d2(dp, dpal)
    np.testing.assert_array_equal(ip, ipal)           # ties: lowest position
    # the 1-NN kernel's plain version is the first column
    d1, i1 = tile_cuda.tile_sweep(torch.from_numpy(qt), torch.from_numpy(cand_t), d)
    np.testing.assert_array_equal(d1.numpy(), dp[:, 0])
    np.testing.assert_array_equal(i1.numpy(), ip[:, 0])


@pytest.mark.parametrize("name", ["3d", "2d", "masked", "split"])
def test_tile_min_plain_matches_pallas(name, interpret_mode):
    """T4 and T5 (the min-only ablations of the JAX tool
    tools/tile_kernel_micro.py, whose closures are K7's body without the
    argmin): their plain version is the minimum of the interpret-mode K7's
    d² within 2 ulp, and K7's own plain d² bit for bit; on CPU tensors both
    wrappers run it."""
    qt, cand_t, pen, cid, d = _kernel_inputs(name)
    q, c = torch.from_numpy(qt), torch.from_numpy(cand_t)
    dm = tile_cuda.tile_min_plain(q, c, d)
    dpal, _ = jts._tile_sweep_pallas(jnp.asarray(qt), jnp.asarray(cand_t), pen,
                                     cid, dim=d)
    _assert_d2(dm.numpy(), np.asarray(dpal))
    d7, _ = tile_cuda.tile_sweep_plain(q, c, d)
    assert torch.equal(dm, d7)
    assert torch.equal(tile_cuda.tile_min_only(q, c, d), dm)
    assert torch.equal(tile_cuda.tile_min_one(q, c, d), dm)
    with pytest.raises(ValueError, match="T5 takes at most"):
        tile_cuda.tile_min_one(q[:1], torch.zeros(1, 8, tile_cuda.MIN_ONE_MAX + 1), d)


def test_tile_kernel_micro_runs_on_the_cpu():
    """tools_torch/tile_kernel_micro.py at a small shape with the plain
    versions: it checks T4 and T5 against K7 and reports every kernel."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools_torch"))
    import tile_kernel_micro

    rep = tile_kernel_micro.run(tiles=9, tq=32, m=256, reps=1, device="cpu")
    assert list(rep["kernels"]) == ["K1 control", "K7 tile_sweep",
                                    "T4 tile_min_only", "T5 tile_min_one"]
    assert rep["cells"] == 9 * 32 * 256
    assert all(r["ms"] > 0 for r in rep["kernels"].values())


def _step_inputs(name):
    q, qm, r, rm, cell, tq, cap = _case(name)
    sj = jts.build_sub_blocks(r, rm, cell)
    aj = jts.assign_tiles(q, qm, sj, tile_q=tq, block_cap=cap, to_device=False)
    cj = jts.gather_candidates(sj, jnp.asarray(aj.blocks))
    ct = torch.from_numpy(np.array(cj[0]))
    return q, qm, r, rm, aj, cj, ct, torch.from_numpy


@pytest.mark.parametrize("name", ["3d", "masked", "outside", "split"])
def test_tile_nn1_from_candidates_matches_jax(name):
    """The gather/scatter form, the tile-ordered form (with a batch axis)
    and ``tile_nn1`` (gathering on the way) against JAX's."""
    q, qm, r, rm, aj, cj, ct, t = _step_inputs(name)
    md = 0.5
    dj, ij = (np.asarray(x) for x in jts.tile_nn1_from_candidates(
        jnp.asarray(q), jnp.asarray(qm), aj.q_rows, *cj, md,
        parent=aj.parent, vrows=aj.vrows))
    dp, ip = ts.tile_nn1_from_candidates(t(q), t(qm), t(aj.q_rows), ct, md,
                                         t(aj.parent), t(aj.vrows))
    _assert_d2(dp.numpy(), dj)
    np.testing.assert_array_equal(ip.numpy(), ij)
    # exact within the radius: the dense search agrees
    db, ib = knn_brute_force(t(q), t(qm), t(r), t(rm), k=1)
    inside = db[:, 0] <= float(np.float32(md) ** 2)
    assert torch.equal(torch.isfinite(dp), inside)
    assert torch.equal(dp[inside], db[inside, 0])
    # tile order: the reading permuted once, two scans stacked
    rows = aj.q_rows.reshape(-1)
    tq_pts = q[np.maximum(rows, 0)]
    tq_mask = (rows >= 0) & qm[np.maximum(rows, 0)]
    P = torch.stack([t(tq_pts)] * 2)
    M = torch.stack([t(tq_mask)] * 2)
    cb = torch.stack([ct] * 2)
    do, io = ts.tile_nn1_from_candidates(P, M, None, cb, md,
                                         torch.stack([t(aj.parent)] * 2),
                                         torch.stack([t(aj.vrows)] * 2))
    dj2, ij2 = (np.asarray(x) for x in jts.tile_nn1_from_candidates(
        jnp.asarray(tq_pts), jnp.asarray(tq_mask), None, *cj, md,
        parent=aj.parent, vrows=aj.vrows))
    for b in range(2):
        _assert_d2(do[b].numpy(), dj2)
        np.testing.assert_array_equal(io[b].numpy(), ij2)
    live = rows >= 0
    np.testing.assert_array_equal(io[0].numpy()[live], ip.numpy()[rows[live]])
    # tile_nn1 gathers the tables itself; JAX's takes per-virtual-tile rows
    units = ts.build_sub_blocks(r, rm, _case(name)[4]).units
    dv, iv = ts.tile_nn1(t(q), t(qm), aj, t(units), md)
    sj = jts.build_sub_blocks(r, rm, _case(name)[4])
    dvj, ivj = (np.asarray(x) for x in jts.tile_nn1(
        jnp.asarray(q), jnp.asarray(qm), aj.vtile_q_rows(), aj.blocks,
        sj.units, md))
    np.testing.assert_array_equal(iv.numpy(), ij)
    np.testing.assert_array_equal(ivj, ij)
    _assert_d2(dv.numpy(), dvj)


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("name", ["3d", "split"])
def test_tile_knnk_from_candidates_matches_jax(name, k):
    q, qm, r, rm, aj, cj, ct, t = _step_inputs(name)
    md = 0.7
    dj, ij = (np.asarray(x) for x in jts.tile_knnk_from_candidates(
        jnp.asarray(q), jnp.asarray(qm), aj.q_rows, *cj, md,
        parent=aj.parent, vrows=aj.vrows, k=k))
    dp, ip = ts.tile_knnk_from_candidates(t(q), t(qm), t(aj.q_rows), ct, md,
                                          t(aj.parent), t(aj.vrows), k)
    _assert_d2(dp.numpy(), dj)
    np.testing.assert_array_equal(ip.numpy(), ij)
    db, ib = knn_brute_force(t(q), t(qm), t(r), t(rm), k=k)
    inside = db <= float(np.float32(md) ** 2)
    assert torch.equal(torch.isfinite(dp), inside)
    assert torch.equal(dp[inside], db[inside])


def test_merge_helpers_match_jax():
    rng = np.random.default_rng(3)
    md = rng.uniform(0, 1, (4, 50)).astype(np.float32)
    dj_ = md.copy()
    dj_[:, ::3] = md[:, ::3]                            # exact ties
    dj_[:, 1::3] = np.inf
    mi = rng.integers(-1, 100, (4, 50)).astype(np.int32)
    ij_ = rng.integers(-1, 100, (4, 50)).astype(np.int32)
    a = jts._combine_min(*(jnp.asarray(x) for x in (md, mi, dj_, ij_)))
    b = ts._combine_min(*(torch.from_numpy(x) for x in (md, mi, dj_, ij_)))
    for x, y in zip(b, a):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    k = 5
    ad = np.sort(rng.uniform(0, 1, (3, k, 40)).astype(np.float32), axis=1)
    bd = np.sort(rng.uniform(0, 1, (3, k, 40)).astype(np.float32), axis=1)
    bd[:, 2:] = np.inf
    ai = rng.integers(0, 99, ad.shape).astype(np.int32)
    bi = rng.integers(0, 99, bd.shape).astype(np.int32)
    a = jts._merge_sorted_k(*(jnp.asarray(x) for x in (ad, ai, bd, bi)))
    b = ts._merge_sorted_k(*(torch.from_numpy(x) for x in (ad, ai, bd, bi)))
    for x, y in zip(b, a):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("k,max_dist,seed", [
    (1, np.inf, 0), (5, np.inf, 1), (5, 0.4, 2), (10, np.inf, 3),
])
def test_knn_self_culled_matches_jax_and_dense(k, max_dist, seed):
    """A dense core and far sparse outliers, whose k-th neighbour lies far
    beyond the density-derived edge: the dense fallback serves them."""
    rng = np.random.default_rng(seed)
    core = rng.normal(size=(3000, 3)).astype(np.float32)
    sparse = (rng.normal(size=(20, 3)) * 50).astype(np.float32)
    pts = np.concatenate([core, sparse])
    mask = np.ones(len(pts), bool)
    mask[::17] = False
    tp, tm = torch.from_numpy(pts), torch.from_numpy(mask)
    dp, ip = knn_self.knn_self_culled(tp, tm, k=k, max_dist=max_dist)
    dj, ij = (np.asarray(x) for x in jax_knn_self(
        jnp.asarray(pts), jnp.asarray(mask), k=k, max_dist=max_dist))
    _assert_d2(dp.numpy(), dj)
    np.testing.assert_array_equal(ip.numpy(), ij)
    dd, di = apply_max_dist(*knn_brute_force(tp, tm, tp, tm, k=k), max_dist)
    assert torch.equal(dp, dd) and torch.equal(ip, di)
