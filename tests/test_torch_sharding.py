"""The port's multi-device layer (``parallel.sharding``, ``ops.cellblocks``,
the drivers' mesh arguments, the sharded pose graph) on a gloo group of 4
ranks on the CPU, against the port's single-device ops and the JAX
package's.

One group is spawned for the module (``tests/torch_sharding_worker.py``,
a ``file://`` store under pytest's tmp path, one thread a rank, every
collective under a 120 s timeout and the whole run under 300 s). Its ranks
run every sharded case on seeded numpy inputs and save the results, and
then the single-device results they are held to. The JAX side runs here,
while the ranks work, on conftest's 8 virtual devices with
``make_mesh(4)``, its survivor sweep in interpret mode.

Held bit for bit to the port's single-device ops: ``sharded_knn`` (k 1
and 3), ``sharded_block_nn1``, ``sharded_tile_nn1``,
``sharded_nn1_sorted_v2`` (cold and with a transported bound; also to
brute force) and ``register_batch_to_map(mesh=)`` at 2 and 4 ranks
(poses, iterations, codes) on the dense route (knn 1 and 3), on a map
where the single-device batch takes the survivor route, and on the tile
route. Within 1e-5: ``register_batch(mesh=)`` and the sharded pose graph.
Against the JAX package: distances within 1e-5 relative (1e-6 for the
cell blocks) with ids compared where the neighbour is unique, the serving
(dense route, knn 1 and 3, and the survivor-sized map) and pair drivers
within the parity tolerances of tests/test_torch_batch.py and
tests/test_torch_pairs.py, the pose graph within 1e-5. The tile route's
sharded batch equals the port's single-device one, which
tests/test_torch_blockgrid.py holds to the JAX package.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_sharding_worker as w
from jax.experimental import pallas as pl

import libpointmatcher_tpu as pm
import libpointmatcher_tpu.ops.knn_sweep2 as k2
from libpointmatcher_tpu.matchers import KDTreeMatcher as JKDTree
from libpointmatcher_tpu.ops import cellblocks as jcb
from libpointmatcher_tpu.ops import tilesweep as jts
from libpointmatcher_tpu.parallel import posegraph as jpg
from libpointmatcher_tpu.parallel import register_batch as jax_register_batch
from libpointmatcher_tpu.parallel import register_batch_to_map as jax_serve
from libpointmatcher_tpu.parallel import sharding as js

from libpointmatcher_tpu_torch.ops import cellblocks
from libpointmatcher_tpu_torch.parallel import sharding

WORLD = 4
#: the serving cases held to the JAX package here; the tile route's port is
#: held to it by tests/test_torch_blockgrid.py, and equals its sharded form
JAX_SERVE_CASES = ("dense1", "dense3", "big")
RANK_TIMEOUT_S = 120.0
GROUP_TIMEOUT_S = 300.0


def _jax_side():
    """Every JAX result the tests compare with, by case."""
    out = {}
    mesh = js.make_mesh(4)
    q, qm, r, rm = w.knn_inputs()
    for k in (1, 3):
        out[f"knn{k}"] = js.sharded_knn(q, qm, r, rm, k=k, mesh=mesh)
    q, qm, r, rm = w.tile_inputs()
    sub = jts.build_sub_blocks(r, rm, cell_size=0.5)
    ta = jts.assign_tiles(q, qm, sub, tile_q=64)
    out["tile"] = js.sharded_tile_nn1(q, qm, ta.vtile_q_rows(), ta.blocks,
                                      sub.units, 0.5, mesh)
    q, qm, r, rm = w.cloudlike()
    _, _, rt3, ct = w.sweep_tables(r, rm)
    with pytest.MonkeyPatch.context() as mp:
        orig = pl.pallas_call
        mp.setattr(k2.pl, "pallas_call",
                   lambda *a, **k: orig(*a, **{**k, "interpret": True}))
        ub = np.full(len(q), np.inf, np.float32)
        out["sweep_cold"] = k2.nn1_sorted_v2(
            jnp.asarray(q), jnp.asarray(qm), jnp.asarray(ub),
            jnp.asarray(rt3), jnp.asarray(ct))[:2]
        cold = np.asarray(out["sweep_cold"][0])
        q2 = w.warm_queries(q)
        out["sweep_warm"] = k2.nn1_sorted_v2(
            jnp.asarray(q2), jnp.asarray(qm),
            jnp.asarray(w.sweep_bound(q, q2, cold)), jnp.asarray(rt3),
            jnp.asarray(ct))[:2]
    reads, refs, inits = w.pair_inputs()
    icp = pm.ICP()
    icp.set_default()
    out["pairs"] = jax_register_batch(
        icp, [pm.PointCloud.from_numpy(x) for x in reads],
        [pm.PointCloud.from_numpy(x) for x in refs], T_inits=inits,
        seed=w.PAIR_SEED, mesh=js.make_mesh(4, axis_name="pairs"))
    for case in JAX_SERVE_CASES:
        out[f"serve_{case}"] = _jax_serve(case)
    for graph in w.POSE_GRAPHS:
        init, ii, jj, meas, _ = w.pose_graph_inputs(*w.POSE_GRAPHS[graph])
        out[f"pg_{graph}"] = jpg.optimize_pose_graph(
            init, jpg.edges_from_numpy(ii, jj, meas), gn_iters=10, cg_iters=30)
    return out


def _jax_serve(case):
    """The JAX package's batch on a serving case (dense on the CPU)."""
    seq = pm.ICPSequence()
    seq.set_default()
    ref, scans, _, _ = w.serve_inputs()
    cloud = pm.PointCloud.from_numpy(ref)
    if case == "dense3":
        seq.matcher = JKDTree({"knn": "3"})
    elif case == "big":
        pts, normals = w.big_map_inputs()
        seq.reference_filters = []
        cloud = pm.PointCloud.from_numpy(pts, {"normals": normals})
    seq.set_map(cloud, seed=w.MAP_SEED)
    return jax_serve(seq, [pm.PointCloud.from_numpy(s) for s in scans],
                     seed=w.SERVE_SEED)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Every rank's saved results: ``out`` (rank 0's sharded results),
    ``members`` (each member's, by rank), ``ref`` (the single-device
    results), ``errors`` (each rank's error messages); and ``jax``, the
    JAX package's, computed here while the ranks run."""
    out = tmp_path_factory.mktemp("sharding")
    ctx = w.start_ranks(w.cpu_suite, WORLD,
                        (WORLD, str(out / "store"), str(out), RANK_TIMEOUT_S))
    try:
        jax_out = _jax_side()
    finally:
        w.join_ranks(ctx, GROUP_TIMEOUT_S)
    members = [dict(np.load(out / f"out_{r}.npz")) for r in range(WORLD)]
    ref = {}
    for r in range(WORLD):
        ref.update(np.load(out / f"ref_{r}.npz"))
    errors = [json.loads((out / f"errors_{r}.json").read_text())
              for r in range(WORLD)]
    return {"out": members[0], "members": members, "ref": ref,
            "errors": errors, "jax": jax_out}


def _same(got, want, label):
    """Bit for bit: the same dtype, shape and bytes (−0.0 is not +0.0)."""
    assert got.dtype == want.dtype and got.shape == want.shape, label
    np.testing.assert_array_equal(got, want, err_msg=label)
    assert got.tobytes() == want.tobytes(), f"{label}: signed zeros differ"


def _ids_where_unique(d, i, jd, ji, r, q, rtol=1e-5):
    """Distances within ``rtol`` relative; ids equal wherever the next
    distinct candidate distance is farther than the tolerance."""
    d, jd = np.asarray(d), np.asarray(jd)
    assert np.array_equal(np.isfinite(d), np.isfinite(jd))
    f = np.isfinite(d)
    np.testing.assert_allclose(d[f], jd[f], rtol=rtol, atol=1e-7)
    i, ji = np.asarray(i), np.asarray(ji)
    diff = f & (i != ji)
    if diff.any():
        # a differing id must be a tie: both ids at the same distance
        qq = q[np.nonzero(diff)[0]]
        da = np.sum((qq - r[i[diff]]) ** 2, axis=-1)
        db = np.sum((qq - r[ji[diff]]) ** 2, axis=-1)
        np.testing.assert_allclose(da, db, rtol=1e-5, atol=1e-7)


def test_make_mesh_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        sharding.make_mesh(2, device="cpu")


def test_every_member_returns_the_same_result(group):
    out = group["out"]
    for r, mine in enumerate(group["members"]):
        for key, v in mine.items():
            _same(v, out[key], f"rank {r}: {key}")
    # ranks 2 and 3 lie outside the 2-rank meshes and saved none of theirs
    assert not any("_w2_" in k for k in group["members"][2])


def test_gather_rows_keeps_signed_zeros_and_inf(group):
    got, want = group["out"]["special_rows"], group["out"]["special_want"]
    _same(got, want, "rows gathered over 4 ranks")
    assert np.signbit(got).any() and np.isinf(got).any()


@pytest.mark.parametrize("k", [1, 3])
def test_sharded_knn(group, k):
    out, ref = group["out"], group["ref"]
    _same(out[f"knn{k}_d"], ref[f"knn{k}_d"], "d2")
    _same(out[f"knn{k}_i"], ref[f"knn{k}_i"], "ids")
    q, qm, r, rm = w.knn_inputs()
    jd, ji = group["jax"][f"knn{k}"]
    _ids_where_unique(out[f"knn{k}_d"], out[f"knn{k}_i"], jd, ji, r, q)


def test_sharded_plane_route(group):
    """The point-to-plane minimizer's kernel route with the map laid out
    over 4 ranks (each scan's pair rows gathered over the mesh into a table
    of its own): the single-device result bit for bit."""
    out, ref = group["out"], group["ref"]
    keys = [k for k in ref if k.startswith("plane_")]
    assert len(keys) == 6
    for key in keys:
        _same(out[key], ref[key], key)
    assert np.isfinite(out["plane_T"]).all()
    assert not np.array_equal(out["plane_T"][0], np.eye(4, dtype=np.float32))


def test_cellblocks_match_jax():
    q, qm, r, rm = w.block_inputs()
    rb = cellblocks.build_ref_blocks(r, rm, 0.5, device="cpu")
    qb = cellblocks.assign_query_blocks(q, qm, rb)
    jrb = jcb.build_ref_blocks(r, rm, cell_size=0.5)
    jqb = jcb.assign_query_blocks(q, qm, jrb)
    for got, want in ((rb.blocks, jrb.blocks), (rb.block_ids, jrb.block_ids),
                      (qb.rows, jqb.rows), (qb.nb_slots, jqb.nb_slots)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(rb.ulins, jrb.ulins)
    assert (rb.dims, qb.touched) == (jrb.dims, jqb.touched)
    d, i = cellblocks.block_nn1(torch.as_tensor(q), qb, rb.blocks,
                                rb.block_ids, 0.5)
    jd, ji = jcb.block_nn1(q, jqb, jrb.blocks, jrb.block_ids, 0.5)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-7)
    # the empty reference and the query set with no valid row
    empty = cellblocks.build_ref_blocks(r, np.zeros(900, bool), 0.5,
                                        device="cpu")
    jempty = jcb.build_ref_blocks(r, np.zeros(900, bool), 0.5)
    np.testing.assert_array_equal(empty.blocks.numpy(), np.asarray(jempty.blocks))
    none = cellblocks.assign_query_blocks(q, np.zeros(700, bool), rb)
    jnone = jcb.assign_query_blocks(q, np.zeros(700, bool), jrb)
    np.testing.assert_array_equal(none.nb_slots.numpy(), np.asarray(jnone.nb_slots))


def test_sharded_block_nn1(group):
    out, ref = group["out"], group["ref"]
    _same(out["block_d"], ref["block_d"], "d2")
    _same(out["block_i"], ref["block_i"], "ids")


def test_sharded_tile_nn1(group):
    out, ref = group["out"], group["ref"]
    _same(out["tile_d"], ref["tile_d"], "d2")
    _same(out["tile_i"], ref["tile_i"], "ids")
    q, qm, r, rm = w.tile_inputs()
    jd, ji = group["jax"]["tile"]
    _ids_where_unique(out["tile_d"], out["tile_i"], jd, ji, r, q)


def test_pad_sweep_tables_for_mesh(group):
    out, ref = group["out"], group["ref"]
    rt3p, ctp = out["sweep_rt3p"], out["sweep_ctp"]
    rt3, ct = ref["sweep_rt3"], ref["sweep_ct"]
    nch = rt3.shape[0]
    assert rt3p.shape[0] % (128 * WORLD) == 0 and ctp.shape == (8, rt3p.shape[0])
    _same(rt3p[:nch], rt3, "rt3 rows")
    assert np.all(rt3p[nch:, 3] == np.inf) and not rt3p[nch:, :3].any()
    _same(ctp[:, :ct.shape[1]], ct, "ct columns")
    assert np.all(ctp[:6, ct.shape[1]:] == np.float32(1e15))
    assert not ctp[6:, ct.shape[1]:].any()
    jrt3, jct = js.pad_sweep_tables_for_mesh(rt3, ct, WORLD)
    _same(rt3p, np.asarray(jrt3), "rt3 as JAX pads it")
    _same(ctp, np.asarray(jct), "ct as JAX pads it")


@pytest.mark.parametrize("tag", ["cold", "warm"])
def test_sharded_nn1_sorted_v2(group, tag):
    out, ref = group["out"], group["ref"]
    d, i = out[f"sweep_{tag}_d"], out[f"sweep_{tag}_i"]
    _same(d, ref[f"sweep_{tag}_d"], "d2 against nn1_sorted_v2")
    _same(i, ref[f"sweep_{tag}_i"], "ids against nn1_sorted_v2")
    _same(d, ref[f"sweep_{tag}_brute_d"], "d2 against brute force")
    _same(i, ref[f"sweep_{tag}_brute_i"], "ids against brute force")
    q, _, r, rm = w.cloudlike()
    if tag == "warm":
        q = w.warm_queries(q)
    rs = w.sweep_tables(r, rm)[0]
    jd, ji = group["jax"][f"sweep_{tag}"]
    _ids_where_unique(d, i, jd, ji, rs, q)


def test_register_batch_mesh(group):
    out, ref = group["out"], group["ref"]
    for key in ("iterations", "codes"):
        _same(out[f"pairs_{key}"], ref[f"pairs_{key}"], key)
    np.testing.assert_allclose(out["pairs_T"], ref["pairs_T"], rtol=0, atol=1e-5)
    _, refs, _ = w.pair_inputs()
    Tj, ij = group["jax"]["pairs"]
    extent = float(np.linalg.norm(np.ptp(np.concatenate(refs), axis=0)))
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(out[f"pairs_{key}"], ij[key], err_msg=key)
    np.testing.assert_allclose(out["pairs_T"][:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(out["pairs_T"][:, :3, 3], Tj[:, :3, 3],
                               atol=1e-4 * extent)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", w.SERVE_CASES)
def test_register_batch_to_map_mesh(group, case, world):
    out, ref = group["out"], group["ref"]
    got = {k: out[f"serve_{case}_w{world}_{k}"]
           for k in ("T", "iterations", "codes", "point_used_ratio")}
    for key, v in got.items():
        _same(v, ref[f"serve_{case}_{key}"], key)
    # the single-device batch's route: the survivor sweep on the big map
    # only; the sharded one matches densely (or through its tile tables)
    assert (int(ref[f"serve_{case}_survivor_steps"]) > 0) == (case == "big")
    assert int(out[f"serve_{case}_w{world}_survivor_steps"]) == 0
    _, _, poses, extent = w.serve_inputs()
    for T, gT in zip(got["T"], poses):
        np.testing.assert_allclose(T, gT, atol=0.02)
    if case not in JAX_SERVE_CASES:
        return
    Tj, ij = group["jax"][f"serve_{case}"]
    for key in ("iterations", "codes"):
        np.testing.assert_array_equal(got[key], ij[key], err_msg=key)
    np.testing.assert_allclose(got["point_used_ratio"], ij["point_used_ratio"],
                               rtol=1e-5)
    np.testing.assert_allclose(got["T"][:, :3, :3], Tj[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(got["T"][:, :3, 3], Tj[:, :3, 3],
                               atol=1e-4 * extent)


@pytest.mark.parametrize("graph", sorted(w.POSE_GRAPHS))
def test_sharded_pose_graph(group, graph):
    out, ref = group["out"], group["ref"]
    np.testing.assert_allclose(out[f"pg_{graph}_poses"], ref[f"pg_{graph}_poses"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[f"pg_{graph}_residual"],
                               ref[f"pg_{graph}_residual"], rtol=0, atol=1e-5)
    gt = w.pose_graph_inputs(*w.POSE_GRAPHS[graph])[-1]
    jopt, jres = group["jax"][f"pg_{graph}"]
    np.testing.assert_allclose(out[f"pg_{graph}_poses"], np.asarray(jopt),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[f"pg_{graph}_residual"], float(jres),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out[f"pg_{graph}_poses"], gt, atol=1e-3)


@pytest.mark.parametrize("name,rank,message", [
    ("default_device", 0, "device='cpu'"),
    ("pairs_divide", 0, "do not divide the mesh"),
    ("tile_divide", 0, "tile axis 32 must divide the mesh"),
    ("block_divide", 0, "must divide the mesh"),
    ("sweep_unpadded", 0, "pad_sweep_tables_for_mesh"),
    ("axis_name", 0, "mesh axis is 'points'"),
    ("outside_dense1_w2", 2, "outside this mesh of 2"),
    ("outside_tile_w2", 3, "outside this mesh of 2"),
    ("tile_divide", 3, "outside this mesh of 3"),
])
def test_error_paths(group, name, rank, message):
    assert message in group["errors"][rank][name]
