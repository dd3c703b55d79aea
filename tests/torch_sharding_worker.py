"""Ranks of a ``torch.distributed`` group for the port's multi-device
layer: their inputs, the group's start and join, and the CPU tests' cases.

Not collected by pytest (no ``test_`` prefix). It imports no JAX, so
``chip_smoke.py`` and the card tests use it too:

- :func:`start_ranks` starts ``world`` processes with the ``spawn`` method
  and :func:`join_ranks` joins them within a deadline, terminating every
  one that is left;
- :func:`init_rank` joins a ``file://`` store with a timeout on every
  collective;
- :func:`cpu_suite` is the rank of ``tests/test_torch_sharding.py``: on a
  gloo group of 4, every sharded op and driver of the port, rank 0 (and
  every member, for the replication check) saving the results, each rank
  then computing some of the single-device results they are held to;
- :func:`card_cases` and :func:`card_single` are the card tests'
  (``tests/test_torch_cuda.py``), :func:`card_suite` their gloo rank on
  the card;
- the ``*_inputs`` functions make each case's inputs from a seed with
  numpy, the same in every rank and in the test process, which gives them
  to the JAX package.
"""

from __future__ import annotations

import json
import os
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

CPU = "cpu"
MAP_SEED = 5
SERVE_SEED = 3
SCAN_ROWS = (1000, 900, 1100)
#: rows of the survivor-sized map: 512-rounded, at least the matcher's
#: SKIP_AUTO_MIN_MAP (16 384), so a single-device batch takes K2 + K3
BIG_MAP_ROWS = 17_000
PAIRS = 8
PAIR_SEED = 4
TILE_MATCHER = {"maxDist": "0.5", "motionBound": "1.0", "tileQueries": "64",
                "blockCap": "1024"}


# ----------------------------------------------------------- ranks and joins
def init_rank(rank: int, world: int, init_file: str, backend: str = "gloo",
              timeout_s: float = 120.0) -> None:
    """Join the group at ``file://init_file`` (one thread a rank)."""
    torch.set_num_threads(1)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout_s))


def start_ranks(fn, world: int, args=()):
    """Start ``fn(rank, *args)`` in ``world`` spawned processes → the
    context :func:`join_ranks` takes."""
    return torch.multiprocessing.start_processes(
        fn, args=args, nprocs=world, join=False, start_method="spawn")


def join_ranks(ctx, timeout_s: float) -> None:
    """Wait for every rank of ``ctx``; raise if one fails or the deadline
    passes, and leave no process running."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{len(ctx.processes)} ranks did not "
                                   f"finish within {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def spawn_ranks(fn, world: int, args=(), timeout_s: float = 300.0) -> None:
    """:func:`start_ranks`, then :func:`join_ranks`."""
    join_ranks(start_ranks(fn, world, args), timeout_s)


# ------------------------------------------------------------------- inputs
def knn_inputs():
    """256 queries, 1024 reference rows, every 7th masked."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(256, 3)).astype(np.float32)
    r = rng.normal(size=(1024, 3)).astype(np.float32)
    rm = np.ones(1024, bool)
    rm[::7] = False
    return q, np.ones(256, bool), r, rm


def block_inputs():
    """700 queries, 900 reference rows (every 9th masked), cell 0.5."""
    rng = np.random.default_rng(3)
    q = rng.uniform(-4, 4, size=(700, 3)).astype(np.float32)
    r = rng.uniform(-4, 4, size=(900, 3)).astype(np.float32)
    rm = np.ones(900, bool)
    rm[::9] = False
    return q, np.ones(700, bool), r, rm


def tile_inputs():
    """700 queries (every 11th masked), 900 reference rows (every 9th
    masked), cell 0.5, tiles of 64 queries."""
    rng = np.random.default_rng(5)
    q = rng.uniform(-4, 4, size=(700, 3)).astype(np.float32)
    r = rng.uniform(-4, 4, size=(900, 3)).astype(np.float32)
    qm = np.ones(700, bool)
    qm[::11] = False
    rm = np.ones(900, bool)
    rm[::9] = False
    return q, qm, r, rm


def cloudlike(n=800, m=2100, seed=11):
    """A dense core and a sparse periphery, 80% of queries and 95% of
    reference rows valid (the survivor sweep's sharded parity inputs)."""
    rng = np.random.default_rng(seed)
    core = rng.normal(size=(n * 3 // 4, 3)) * 0.7
    peri = rng.uniform(-8, 8, size=(n - len(core), 3))
    q = np.concatenate([core, peri]).astype(np.float32)
    rcore = rng.normal(size=(m * 3 // 4, 3)) * 0.7 + 0.05
    rperi = rng.uniform(-8, 8, size=(m - len(rcore), 3))
    r = np.concatenate([rcore, rperi]).astype(np.float32)
    return q, rng.random(n) < 0.8, r, rng.random(m) < 0.95


def warm_queries(q):
    """The sweep's second iteration: the queries moved by ~3 cm."""
    return q + np.random.default_rng(3).normal(scale=0.03,
                                               size=q.shape).astype(np.float32)


def room(rng, n):
    """Floor, two walls, a table top and a block face: a planar scene."""
    k = n // 5
    return np.concatenate([
        np.c_[rng.uniform(0, 6, k), rng.uniform(0, 4, k), np.zeros(k)],
        np.c_[rng.uniform(0, 6, k), np.zeros(k), rng.uniform(0, 2.5, k)],
        np.c_[np.zeros(k), rng.uniform(0, 4, k), rng.uniform(0, 2.5, k)],
        np.c_[rng.uniform(2, 3, k), rng.uniform(1.5, 2.5, k), np.full(k, 0.8)],
        np.c_[np.full(k, 4.5), rng.uniform(1, 3, k), rng.uniform(0, 1.5, k)]])


def room_normals(n):
    """The unit normals of :func:`room`'s five planes, row for row."""
    k = n // 5
    return np.repeat(np.float32([[0, 0, 1], [0, 1, 0], [1, 0, 0], [0, 0, 1],
                                 [1, 0, 0]]), k, axis=0)


def yaw_pose(ang, t):
    T = np.eye(4)
    T[:3, :3] = [[np.cos(ang), -np.sin(ang), 0], [np.sin(ang), np.cos(ang), 0],
                 [0, 0, 1]]
    T[:3, 3] = t
    return T


def serve_inputs():
    """A ~4000-point map and three scans of 900-1100 points, each displaced
    from the map frame by a known pose (tests/test_torch_batch.py's)."""
    return _serve_scene()[:4]


def _serve_scene():
    """:func:`serve_inputs` and, last, the map rows' plane normals."""
    rng = np.random.default_rng(0)
    world = room(rng, 8000)
    pick = rng.choice(len(world), 4000, replace=False)
    ref = world[pick].astype(np.float32)
    scans, poses = [], []
    for i, n in enumerate(SCAN_ROWS):
        rows = world[rng.choice(len(world), n, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = yaw_pose(0.03 * (i - 1), [0.06, -0.04 + 0.02 * i, 0.02])
        scans.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        poses.append(T)
    extent = float(np.linalg.norm(world.max(0) - world.min(0)))
    return ref, scans, poses, extent, room_normals(8000)[pick]


def big_map_inputs():
    """A room map of ``BIG_MAP_ROWS`` rows and its planes' normals, set
    with no reference filter (the scans of :func:`serve_inputs` register
    against it)."""
    rng = np.random.default_rng(7)
    return room(rng, BIG_MAP_ROWS).astype(np.float32), room_normals(BIG_MAP_ROWS)


def pair_inputs():
    """``PAIRS`` pairs of a room: each reference ~700 rows, each reading
    ~500 rows displaced by a known pose, and a perturbed guess."""
    rng = np.random.default_rng(1)
    world = room(rng, 9000)
    reads, refs, inits = [], [], []
    for i in range(PAIRS):
        refs.append(world[rng.choice(len(world), 650 + 10 * i, replace=False)]
                    .astype(np.float32))
        rows = world[rng.choice(len(world), 480 + 7 * i, replace=False)]
        rows = rows + 0.003 * rng.standard_normal(rows.shape)
        T = yaw_pose(0.01 * (i - 4), [0.04, 0.03 - 0.01 * i, -0.02])
        reads.append(((rows - T[:3, 3]) @ T[:3, :3]).astype(np.float32))
        inits.append((yaw_pose(0.01, [0.02, 0.0, 0.01]) @ T).astype(np.float32))
    return reads, refs, inits


def _rotz(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]], np.float32)


def _rodrigues(w):
    th = float(np.linalg.norm(w))
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    K = K / th
    return (np.eye(3) + np.sin(th) * K
            + (1 - np.cos(th)) * K @ K).astype(np.float32)


def pose_graph_inputs(k: int, closures: int, seed: int):
    """Poses around a circle (``k`` of them), exact odometry i → i+1, the
    closure k−1 → 0 and ``closures`` more closures i → i + k/2, and an
    initial guess of the truth with noise (pose 0 fixed) → ``(init [k, 4,
    4], ii, jj, T_meas [C, 4, 4], truth)``."""
    rng = np.random.default_rng(seed)
    gt = []
    for j in range(k):
        a = 2 * np.pi * j / k
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rotz(a)
        T[:3, 3] = [np.cos(a), np.sin(a), 0.0]
        gt.append(T)
    gt = np.stack(gt)
    ii = list(range(k - 1)) + [k - 1]
    jj = list(range(1, k)) + [0]
    for c in range(closures):
        ii.append(c * k // max(closures, 1) // 2)
        jj.append(ii[-1] + k // 2)
    meas = np.stack([np.linalg.inv(gt[a]) @ gt[b] for a, b in zip(ii, jj)])
    init = gt.copy()
    for j in range(1, k):
        init[j][:3, :3] = init[j][:3, :3] @ _rodrigues(
            rng.normal(scale=0.1, size=3))
        init[j][:3, 3] += rng.normal(scale=0.15, size=3)
    return init, np.asarray(ii), np.asarray(jj), meas.astype(np.float32), gt


POSE_GRAPHS = {"circle": (8, 0, 0), "loops": (64, 8, 1)}


# --------------------------------------------------------- the port's side
def serving_sequence(case: str, device=CPU):
    """The port's sequence of a serving case, its map set: ``dense1`` and
    ``dense3`` (knn 3) on :func:`serve_inputs`' map, ``tile``
    (BlockGridMatcher) on the same map with its planes' normals and no
    reference filter, ``big`` on :func:`big_map_inputs`' likewise. On the card the map is set on the CPU and installed
    (``state.install_map``): the card's ``set_map`` sums segments in atomic
    order (ROADMAP Queue 3 #26), so two of one cloud may differ in the
    last bits, and a sharded run and the single-device run it is held to
    must share one map."""
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.matchers import (BlockGridMatcher,
                                                    KDTreeMatcher)
    from libpointmatcher_tpu_torch.state import install_map

    def sequence(dev):
        seq = pt.ICPSequence(device=dev)
        seq.set_default()
        if case in ("big", "tile"):
            seq.reference_filters = []
        if case == "dense3":
            seq.matcher = KDTreeMatcher({"knn": "3"})
        if case == "tile":
            seq.matcher = BlockGridMatcher(TILE_MATCHER)
        return seq

    seq = sequence(CPU)
    if case == "big":
        pts, normals = big_map_inputs()
        cloud = pt.PointCloud.from_numpy(pts, {"normals": normals}, device=CPU)
    elif case == "tile":
        scene = _serve_scene()
        cloud = pt.PointCloud.from_numpy(scene[0], {"normals": scene[-1]},
                                         device=CPU)
    else:
        cloud = pt.PointCloud.from_numpy(serve_inputs()[0], device=CPU)
    seq.set_map(cloud, seed=MAP_SEED)
    if torch.device(device).type == "cpu":
        return seq
    on_card = sequence(device)
    m = seq.get_prefiltered_internal_map()
    install_map(on_card, m.points.numpy(), m.get_descriptor("normals").numpy(),
                seq.trm_host(), m.mask.numpy())
    return on_card


def serve(seq, mesh=None, device=CPU):
    """The serving cases' batch: :func:`serve_inputs`' three scans from the
    identity (moved into the map's frame for the big map)."""
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch import telemetry
    from libpointmatcher_tpu_torch.parallel import register_batch_to_map

    _, scans, _, _ = serve_inputs()
    clouds = [pt.PointCloud.from_numpy(s, device=device) for s in scans]
    telemetry.set_level("detail")
    try:
        T, info = register_batch_to_map(seq, clouds, seed=SERVE_SEED, mesh=mesh)
        shares = telemetry.snapshot()[-1]["counters"].get("survivor_share", [])
    finally:
        telemetry.set_level("spans")
    return {"T": T, "iterations": info["iterations"], "codes": info["codes"],
            "point_used_ratio": info["point_used_ratio"],
            "survivor_steps": len(shares)}


def pairs_run(mesh=None, device=CPU, count=PAIRS):
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.parallel import register_batch

    reads, refs, inits = pair_inputs()
    icp = pt.ICP(device=device)
    icp.set_default()
    T, info = register_batch(
        icp, [pt.PointCloud.from_numpy(r, device=device) for r in reads[:count]],
        [pt.PointCloud.from_numpy(r, device=device) for r in refs[:count]],
        T_inits=inits[:count], seed=PAIR_SEED, mesh=mesh)
    return {"T": T, "iterations": info["iterations"], "codes": info["codes"]}


def pose_graph_run(name: str, mesh=None, device=CPU):
    from libpointmatcher_tpu_torch.parallel import posegraph

    k, closures, seed = POSE_GRAPHS[name]
    init, ii, jj, meas, _ = pose_graph_inputs(k, closures, seed)
    edges = posegraph.edges_from_numpy(ii, jj, meas, device=device)
    if mesh is not None:
        edges = posegraph.shard_edges(edges, mesh)
    opt, res = posegraph.optimize_pose_graph(init, edges, gn_iters=10,
                                             cg_iters=30, mesh=mesh)
    return {"poses": opt.cpu().numpy(), "residual": float(res)}


def _t(a, device=CPU):
    return torch.as_tensor(np.asarray(a), device=device)


def _np(t):
    return t.cpu().numpy()


PLANE_SEED = 6


def plane_inputs():
    """The point-to-plane minimize's inputs: 3 scans of 400 points, k = 3,
    matched to a 1 000-row map with unit normals; some rows masked, some
    slots at inf distance (id −1) or zero weight."""
    rng = np.random.default_rng(PLANE_SEED)
    r = rng.uniform(-4, 4, size=(1000, 3)).astype(np.float32)
    nrm = rng.normal(size=(1000, 3))
    nrm = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(np.float32)
    ids = rng.integers(0, 1000, size=(3, 400, 3)).astype(np.int32)
    q = (r[ids[..., 0]] + rng.normal(scale=0.02, size=(3, 400, 3))
         ).astype(np.float32)
    qm = rng.random((3, 400)) > 0.05
    d = rng.random((3, 400, 3)).astype(np.float32)
    d[(rng.random(d.shape) < 0.05) | ~qm[..., None]] = np.inf
    ids[~np.isfinite(d)] = -1
    w = rng.random((3, 400, 3)).astype(np.float32)
    w[rng.random(w.shape) < 0.05] = 0.0
    return q, qm, r, nrm, d, ids, w


def plane_route(mesh=None, device=CPU) -> dict:
    """:func:`plane_inputs` through the point-to-plane minimizer's kernel
    route (``PointToPlaneErrorMinimizer._kernel``: the kernel pair on the
    card, its plain version on the CPU), the map laid out over ``mesh``
    (on one device without) → the transforms and statistics."""
    from libpointmatcher_tpu_torch.cloud import PointCloud
    from libpointmatcher_tpu_torch.matchers import Matches
    from libpointmatcher_tpu_torch.minimizers import PointToPlaneErrorMinimizer
    from libpointmatcher_tpu_torch.parallel import sharding

    dev = mesh.device if mesh is not None else device
    q, qm, r, nrm, d, ids, w = (_t(a, dev) for a in plane_inputs())
    ref = PointCloud(r, descriptors={"normals": nrm})
    if mesh is not None:
        ref = sharding.shard_cloud(ref, mesh)
    T, st = PointToPlaneErrorMinimizer()._kernel(PointCloud(q, qm), ref, w,
                                                 Matches(d, ids))
    return {"plane_T": _np(T), "plane_residual": _np(st.residual),
            "plane_used": _np(st.point_used_ratio),
            "plane_weighted": _np(st.weighted_point_used_ratio),
            "plane_rejected_matches": _np(st.nb_rejected_matches),
            "plane_rejected_points": _np(st.nb_rejected_points)}


def sweep_tables(r, rm):
    """The Morton-sorted map's rows and its two survivor-sweep tables."""
    from libpointmatcher_tpu_torch.ops import morton, sweep

    rorder, _ = morton.morton_argsort(r, rm)
    rs, rsm = r[rorder], rm[rorder]
    return rs, rsm, sweep.chunked_ref_table(rs, rsm), sweep.chunk_summaries(rs, rsm)


def sweep_bound(q, q2, d_cold):
    """The transported bound of the warm sweep from the cold one's d²."""
    step = np.linalg.norm(q2 - q, axis=1)
    return ((np.sqrt(np.where(np.isfinite(d_cold), d_cold, np.inf)) + step)
            * np.float32(1 + 4e-7)).astype(np.float32)


def sharded_ops(mesh, out: dict) -> None:
    """Every sharded op of ``parallel.sharding`` on the test inputs, on the
    mesh's device."""
    from libpointmatcher_tpu_torch.ops import cellblocks, tilesweep
    from libpointmatcher_tpu_torch.parallel import sharding

    dev = mesh.device
    t = lambda a: _t(a, dev)
    q, qm, r, rm = knn_inputs()
    for k in (1, 3):
        d, i = sharding.sharded_knn(t(q), t(qm), t(r), t(rm), k, mesh)
        out[f"knn{k}_d"], out[f"knn{k}_i"] = _np(d), _np(i)
    q, qm, r, rm = block_inputs()
    rb = cellblocks.build_ref_blocks(r, rm, 0.5, device=dev)
    qb = cellblocks.assign_query_blocks(q, qm, rb)
    d, i = sharding.sharded_block_nn1(t(q), qb.rows, qb.nb_slots, rb.blocks,
                                      rb.block_ids, 0.5, mesh)
    out["block_d"], out["block_i"] = _np(d), _np(i)
    q, qm, r, rm = tile_inputs()
    sub = tilesweep.build_sub_blocks(r, rm, 0.5)
    ta = tilesweep.assign_tiles(q, qm, sub, tile_q=64)
    d, i = sharding.sharded_tile_nn1(t(q), t(qm), ta, t(sub.units), 0.5, mesh)
    out["tile_d"], out["tile_i"] = _np(d), _np(i)
    q, qm, r, rm = cloudlike()
    _, _, rt3, ct = sweep_tables(r, rm)
    rt3p, ctp = sharding.pad_sweep_tables_for_mesh(rt3, ct, mesh.size)
    out["sweep_rt3p"], out["sweep_ctp"] = rt3p, ctp
    ub = torch.full((len(q),), float("inf"), device=dev)
    d, i = sharding.sharded_nn1_sorted_v2(t(q), t(qm), ub, t(rt3p), t(ctp),
                                          mesh)
    out["sweep_cold_d"], out["sweep_cold_i"] = _np(d), _np(i)
    q2 = warm_queries(q)
    d, i = sharding.sharded_nn1_sorted_v2(
        t(q2), t(qm), t(sweep_bound(q, q2, out["sweep_cold_d"])), t(rt3p),
        t(ctp), mesh)
    out["sweep_warm_d"], out["sweep_warm_i"] = _np(d), _np(i)
    out.update(plane_route(mesh))


def single_ops(out: dict, device=CPU) -> None:
    """The single-device ops the sharded ones are held to, on ``device``."""
    from libpointmatcher_tpu_torch.ops import cellblocks, knn, sweep, tilesweep
    from libpointmatcher_tpu_torch.ops.dispatch import knn_search

    t = lambda a: _t(a, device)
    q, qm, r, rm = knn_inputs()
    for k in (1, 3):
        d, i = knn_search(t(q), t(qm), t(r), t(rm), k=k)
        out[f"knn{k}_d"], out[f"knn{k}_i"] = _np(d), _np(i)
    q, qm, r, rm = block_inputs()
    rb = cellblocks.build_ref_blocks(r, rm, 0.5, device=device)
    qb = cellblocks.assign_query_blocks(q, qm, rb)
    d, i = cellblocks.block_nn1(t(q), qb, rb.blocks, rb.block_ids, 0.5)
    out["block_d"], out["block_i"] = _np(d), _np(i)
    for name, v in (("blocks", rb.blocks), ("block_ids", rb.block_ids),
                    ("qb_rows", qb.rows), ("qb_slots", qb.nb_slots)):
        out[name] = _np(v)
    q, qm, r, rm = tile_inputs()
    sub = tilesweep.build_sub_blocks(r, rm, 0.5)
    ta = tilesweep.assign_tiles(q, qm, sub, tile_q=64)
    d, i = tilesweep.tile_nn1(t(q), t(qm), ta, t(sub.units), 0.5)
    out["tile_d"], out["tile_i"] = _np(d), _np(i)
    q, qm, r, rm = cloudlike()
    rs, rsm, rt3, ct = sweep_tables(r, rm)
    out["sweep_rt3"], out["sweep_ct"] = rt3, ct
    ub = torch.full((len(q),), float("inf"), device=device)
    d, i = sweep.nn1_sorted_v2(t(q), t(qm), ub, t(rt3), t(ct))
    out["sweep_cold_d"], out["sweep_cold_i"] = _np(d), _np(i)
    q2 = warm_queries(q)
    d, i = sweep.nn1_sorted_v2(t(q2), t(qm),
                               t(sweep_bound(q, q2, out["sweep_cold_d"])),
                               t(rt3), t(ct))
    out["sweep_warm_d"], out["sweep_warm_i"] = _np(d), _np(i)
    for tag, qq in (("cold", q), ("warm", q2)):
        d, i = knn.knn_brute_force(t(qq), t(qm), t(rs), t(rsm), k=1)
        out[f"sweep_{tag}_brute_d"] = _np(d[:, 0])
        out[f"sweep_{tag}_brute_i"] = _np(i[:, 0])
    out.update(plane_route(None, device))


def special_rows(mesh, out: dict) -> None:
    """``gather_rows``' sharded case on a table of −0.0, +0.0, ±inf and
    ordinary values: every row gathered from the rank that owns it."""
    from libpointmatcher_tpu_torch.cloud import PointCloud
    from libpointmatcher_tpu_torch.minimizers import gather_rows
    from libpointmatcher_tpu_torch.parallel import sharding

    table = np.float32([[-0.0, 0.0, np.inf], [-np.inf, 1.5, -0.0],
                        [0.0, -0.0, -2.25], [np.inf, -np.inf, 0.0]] * 4)
    ids = np.int64([[0, 5, 3, 2, 15, 4, 4, 9, 1, 6, 12, 7]])
    cloud = sharding.shard_cloud(PointCloud(_t(table, mesh.device)), mesh)
    got = gather_rows(cloud.points, _t(ids, mesh.device), cloud)
    out["special_rows"], out["special_want"] = _np(got), table[ids]


SERVE_CASES = ("dense1", "dense3", "big", "tile")
#: the serving cases of the card tests
CARD_SERVE_CASES = ("dense1", "big", "tile")


def _errors(run) -> str:
    """``run()``'s exception as ``"Type: message"``, or "" if none."""
    try:
        run()
    except (ValueError, RuntimeError) as e:
        return f"{type(e).__name__}: {e}"
    return ""


def cpu_suite(rank: int, world: int, init_file: str, out_dir: str,
              timeout_s: float) -> None:
    """A rank of the CPU tests' group of 4 (gloo): every sharded case, its
    results saved by every member (``out_<rank>.npz``), the error paths
    (``errors_<rank>.json``), then this rank's share of the single-device
    results (``ref_<rank>.npz``)."""
    from libpointmatcher_tpu_torch.ops import tilesweep, cellblocks
    from libpointmatcher_tpu_torch.parallel import sharding

    init_rank(rank, world, init_file, "gloo", timeout_s)
    try:
        out, errors = {}, {}
        errors["default_device"] = _errors(lambda: sharding.make_mesh(2))
        m4 = sharding.make_mesh(4, device=CPU)
        m2 = sharding.make_mesh(2, device=CPU)
        m3 = sharding.make_mesh(3, device=CPU)
        pairs = sharding.make_mesh(4, axis_name="pairs", device=CPU)
        sharded_ops(m4, out)
        for name, case in (("pairs", lambda: pairs_run(pairs)),
                           *((f"pg_{g}", lambda g=g: pose_graph_run(g, m4))
                             for g in POSE_GRAPHS)):
            for key, v in case().items():
                out[f"{name}_{key}"] = np.asarray(v)
        for case in SERVE_CASES:
            seq = serving_sequence(case)
            for w, mesh in ((2, m2), (4, m4)):
                if mesh.member:
                    for key, v in serve(seq, mesh).items():
                        out[f"serve_{case}_w{w}_{key}"] = v
                else:
                    errors[f"outside_{case}_w{w}"] = _errors(
                        lambda: serve(seq, mesh))
        errors["pairs_divide"] = _errors(lambda: pairs_run(pairs, count=6))
        special_rows(m4, out)
        q, qm, r, rm = tile_inputs()
        sub = tilesweep.build_sub_blocks(r, rm, 0.5)
        ta = tilesweep.assign_tiles(q, qm, sub, tile_q=64)
        errors["tile_divide"] = _errors(lambda: sharding.sharded_tile_nn1(
            _t(q), _t(qm), ta, _t(sub.units), 0.5, m3))
        q, qm, r, rm = block_inputs()
        rb = cellblocks.build_ref_blocks(r, rm, 0.5, device=CPU)
        qb = cellblocks.assign_query_blocks(q, qm, rb)
        errors["block_divide"] = _errors(lambda: sharding.sharded_block_nn1(
            _t(q), qb.rows[:-1], qb.nb_slots[:-1], rb.blocks, rb.block_ids,
            0.5, m4))
        q, qm, r, rm = cloudlike()
        _, _, rt3, ct = sweep_tables(r, rm)
        errors["sweep_unpadded"] = _errors(lambda: sharding.sharded_nn1_sorted_v2(
            _t(q), _t(qm), torch.full((len(q),), float("inf")), _t(rt3), _t(ct),
            m4))
        errors["axis_name"] = _errors(lambda: pairs_run(m4))
        np.savez(os.path.join(out_dir, f"out_{rank}.npz"), **out)
        with open(os.path.join(out_dir, f"errors_{rank}.json"), "w") as f:
            json.dump(errors, f)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        dist.destroy_process_group()
    # this rank's share of the single-device results
    ref = {}
    if rank == 0:
        single_ops(ref)
    elif rank == 1:
        ref.update({f"pairs_{k}": np.asarray(v) for k, v in pairs_run().items()})
        for g in POSE_GRAPHS:
            ref.update({f"pg_{g}_{k}": np.asarray(v)
                        for k, v in pose_graph_run(g).items()})
    else:
        for case in SERVE_CASES[rank - 2::2]:
            ref.update({f"serve_{case}_{k}": v
                        for k, v in serve(serving_sequence(case)).items()})
    np.savez(os.path.join(out_dir, f"ref_{rank}.npz"), **ref)


# ------------------------------------------------------------- on the card
def card_cases(mesh, pairs_mesh) -> dict:
    """The card tests' sharded cases on ``mesh`` (and ``pairs_mesh``, its
    pair axis): every sharded op, the sharded gather's special rows, the
    serving cases of ``CARD_SERVE_CASES`` and the pairs."""
    dev = mesh.device
    out = {}
    sharded_ops(mesh, out)
    special_rows(mesh, out)
    for case in CARD_SERVE_CASES:
        out.update({f"serve_{case}_{k}": v for k, v in
                    serve(serving_sequence(case, dev), mesh, dev).items()})
    out.update({f"pairs_{k}": np.asarray(v)
                for k, v in pairs_run(pairs_mesh, dev).items()})
    return out


def card_single(device) -> dict:
    """The single-device results :func:`card_cases` is held to."""
    out = {}
    single_ops(out, device)
    for case in CARD_SERVE_CASES:
        out.update({f"serve_{case}_{k}": v for k, v in
                    serve(serving_sequence(case, device), None, device).items()})
    out.update({f"pairs_{k}": np.asarray(v)
                for k, v in pairs_run(None, device).items()})
    return out


def card_suite(rank: int, world: int, init_file: str, out_dir: str,
               timeout_s: float) -> None:
    """A gloo rank on the card (cuda:0): :func:`card_cases`, rank 0 saving
    them (``card_<world>.npz``)."""
    from libpointmatcher_tpu_torch.parallel import sharding

    torch.cuda.set_device(0)
    init_rank(rank, world, init_file, "gloo", timeout_s)
    try:
        out = card_cases(sharding.make_mesh(world, device="cuda"),
                         sharding.make_mesh(world, axis_name="pairs",
                                            device="cuda"))
        if rank == 0:
            np.savez(os.path.join(out_dir, f"card_{world}.npz"), **out)
    finally:
        dist.destroy_process_group()
