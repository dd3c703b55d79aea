"""K7 and K8, the tile sweeps, timed at recorded main-path inputs: the
A/B of two trees of the port on one card, whole step and kernel.

    python3 tools_torch/tile_micro.py record --out FILE
    python3 tools_torch/tile_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--set-map] [--teams 1,2,4]
        [--device cuda|cpu] [--out JSON]

``record`` keeps the arguments of the matcher's tile step
(``tilesweep.tile_nn1_from_candidates`` or ``tile_knnk_from_candidates``)
at five calls, written to FILE with ``torch.save``, on chip_smoke.py's
terrain configuration (phases 13-16):

- ``K7 batch 1e5``: the 10^5-point map's batch of 8 scans, its second
  lockstep iteration;
- ``K7 queue 1e5``: one lane iteration (the second) of its queue of 24
  scans through 8 lanes;
- ``K7 batch 4e5``: the 4·10^5-point map's batch, its second iteration;
- ``K8 set_map k=10``: ``SurfaceNormal(knn=10)``'s culled self-search in
  ``set_map`` of the 10^5-point map;
- ``K8 batch k=3``: a batch iteration (the second) of the 8 scans on the
  10^5-point map with ``BlockGridMatcher(knn=3)``.

Each call keeps its ``parent`` too (read from ``vrows``), so that a tree
whose step still takes it runs on the same inputs.

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit is timed on the same inputs:
run the trees in turns (parent, change, change, parent), one process each.
For each input the step is first held bit for bit to the parent-form
plain version (``tile_cuda.tile_sweep_parents_plain`` or
``tile_sweep_k_parents_plain``; in a tree without them, the step with its
per-tile sweeps' plain versions), then timed with CUDA events
(``--reps`` calls, ``--rounds`` times): the whole step, and the tree's
kernel alone at the inputs the step handed it. The step's launches are
counted with ``torch.profiler`` (device kernels and memory operations).
Each input also reports the pairs the per-tile kernel sweeps (every
virtual tile × TQ × M), the live pairs after the ``ncols`` prefixes and
the mask (live queries × live columns of their parent), the valid pairs
(live queries × real candidates) that the bound counts, and the virtual
tiles per live parent (mean, 99th percentile, maximum); beside each time
the bound (9 fp32 operations a valid pair at 67 TFLOP/s, or the bytes at
3.35 TB/s) and the issue floor (9 instructions a valid pair, one warp
instruction a clock in each SM partition). ``--set-map`` adds ``set_map``
of the 10^5-point terrain map: its host seconds and its device kernels and
memory operations (``torch.profiler``); ``--teams`` times K7 at each count
of warps a block that share a parent's virtual tiles (``tile_cuda.TEAMS``),
each first held to the plain version. ``--device cpu`` runs the plain
versions, to check the script; its times are the host's clock and no
measure of the card. Prints one JSON object (and writes it to ``--out``).

:func:`emulate` is the kernels' schedule in plain torch (each parent's
virtual tiles in ``vrows`` order over their ``ncols`` prefixes, ``x +
pen`` staging, groups of 8 columns, K7's group argmin with its recomputed
group and its merge by (d², id), K8's k-slot insertion in group order, the
radius and the mask in the epilogue, masked warps skipped), which
tests/test_torch_tile_schedule.py holds to the plain versions bit for bit;
:func:`make_case` builds its test inputs through the port's host tables.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from libpointmatcher_tpu_torch.ops import tile_cuda as tc  # noqa: E402
from libpointmatcher_tpu_torch.ops import tilesweep as ts  # noqa: E402

FP32_FLOPS = 67e12      # H100 SXM, dense fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12
OPS_PER_PAIR = 9
GROUP = 8               # columns a group (csrc/tile.cu kGroup)
STEPS = {"K7": "tile_nn1_from_candidates", "K8": "tile_knnk_from_candidates"}


# ------------------------------------------------------------- emulation
def _fmin_groups(d):
    """fminf over the last axis as the kernels fold a group (NaN ignored)."""
    while d.shape[-1] > 1:
        w = d.shape[-1] // 2
        d = torch.fmin(d[..., :w], d[..., w:])
    return d[..., 0]


def _d2(q, x, y, z):
    """d² in the kernels' order against x + pen: q [..., TQ, 3] and
    columns [..., G] → [..., TQ, G]."""
    dx = q[..., 0, None] - x[..., None, :]
    dy = q[..., 1, None] - y[..., None, :]
    dz = q[..., 2, None] - z[..., None, :]
    return (dx * dx + dy * dy) + dz * dz


def _stable_merge(ld, lc, d, c):
    """Lists [..., k] with columns [..., G] inserted in order with a strict
    '<' (equal distances keep their arrival order), cut to k."""
    k = ld.shape[-1]
    sd, order = torch.sort(torch.cat([ld, d], -1), dim=-1, stable=True)
    return sd[..., :k], torch.gather(torch.cat([lc, c], -1), -1, order)[..., :k]


def _merge_one(ld, lc, d, c):
    """tilesweep._merge_sorted_k's pass for one entry (d, c) [...] into the
    lists [..., k]: the entry goes after the distances at or below it, and
    each run of equal distances above it has its first entry moved to its
    end (the entry carried along the list stays put on ties), cut to k."""
    k = ld.shape[-1]
    pos = torch.arange(k, device=ld.device)
    s0 = (ld <= d[..., None]).sum(-1, keepdim=True)
    start = torch.ones_like(ld, dtype=torch.bool)
    start[..., 1:] = ld[..., 1:] != ld[..., :-1]
    tie = torch.cat([torch.where((pos >= s0) & start, k + 1, pos),
                     torch.full_like(s0, k + 1)], -1)
    vals = torch.cat([ld, d[..., None]], -1)
    codes = torch.cat([lc, c[..., None]], -1)
    o = torch.argsort(tie, dim=-1, stable=True)          # (d², tie) order
    vals, codes = torch.gather(vals, -1, o), torch.gather(codes, -1, o)
    o = torch.argsort(vals, dim=-1, stable=True)
    return (torch.gather(vals, -1, o)[..., :k],
            torch.gather(codes, -1, o)[..., :k])


def _warps(tq: int, k: int):
    """Each query slot's (slice, warp) in the kernels' blocks → [TQ] id:
    K7 two queries a thread, up to 128 threads a block, K8 one, up to 256
    (128 above 24 slots; csrc/tile.cu)."""
    per_thread, cap = (2, 128) if k == 0 else (1, 128 if k > 24 else 256)
    threads = min(cap, -(-(-(-tq // per_thread)) // 32) * 32)
    slot = torch.arange(tq)
    within = slot % (per_thread * threads)
    return (slot // (per_thread * threads)) * threads + (within % threads) // 32


def emulate(points, qmask, q_rows, cand_t, ncols, vrows, max_dist: float,
            k: int = 0):
    """The schedule of K7 (``k`` 0) or K8 in plain torch, the parent
    form's arguments → ``(d2, id, stats)``, the kernels' results in the
    wrappers' shapes, and ``stats``: the (live warp, group) units swept and,
    for K8, how many took the insertion branch."""
    bf, tp, tq, tv, kd, m = tc._parent_shape(points, qmask, q_rows, cand_t,
                                             ncols, vrows)
    dev, inf = points.device, float("inf")
    n, d = points.shape[-2:]
    # each slot's row and coordinates, [Bf, Tp, TQ]
    if q_rows is None:
        rows = torch.arange(bf * n, device=dev).reshape(bf, tp, tq)
    else:
        rows = q_rows.long().reshape(1, tp, tq)
    flat_pts = points.reshape(-1, d)
    q3 = torch.zeros((bf, tp, tq, 3), dtype=torch.float32, device=dev)
    q3[..., :d] = flat_pts[rows.clamp(min=0)]
    live = (rows >= 0) & qmask.reshape(-1)[rows.clamp(min=0)]
    warp = _warps(tq, k).to(dev)
    nw = int(warp.max()) + 1
    wlive = torch.zeros((bf, tp, nw), dtype=torch.long, device=dev).index_add_(
        2, warp, live.long()) > 0                        # any live query
    swept = wlive[..., warp]                             # [Bf, Tp, TQ]
    tabs = cand_t.reshape(bf * tv, tc.DPAD, m)
    nc = (torch.full((bf * tv,), m, device=dev) if ncols is None
          else ncols.reshape(-1).long())
    base = torch.arange(bf, device=dev)[:, None] * tv
    vr = vrows.reshape(bf, kd, tp).long()
    units = taken = 0
    pd = torch.full((bf, tp, tq, max(k, 1)), inf, device=dev)  # the parent's
    pc = torch.full((bf, tp, tq, max(k, 1)), -1, dtype=torch.int64, device=dev)
    for j in range(kd):
        v = base + vr[:, j]                              # [Bf, Tp]
        cols = nc[v]
        t = tabs[v]                                      # [Bf, Tp, 8, M]
        x = t[:, :, 0] + t[:, :, tc.PEN_ROW]
        y = t[:, :, 1]
        z = t[:, :, 2] if d == 3 else torch.zeros_like(y)
        # the virtual tile's (minimum, its group) or its list
        vd = torch.full(pd.shape, inf, device=dev)
        vc = torch.full(pd.shape, -1, dtype=torch.int64, device=dev)
        for g in range(m // GROUP):
            sl = slice(g * GROUP, (g + 1) * GROUP)
            on = (g * GROUP < cols)[..., None] & swept   # [Bf, Tp, TQ]
            if not bool(on.any()):
                continue
            dd = torch.where(on[..., None], _d2(q3, x[..., sl], y[..., sl],
                                                z[..., sl]), inf)
            gmin = _fmin_groups(dd)
            units += int(((g * GROUP < cols)[..., None] & wlive).sum())
            if k == 0:
                take = gmin < vd[..., 0]
                vd[..., 0] = torch.where(take, gmin, vd[..., 0])
                vc[..., 0] = torch.where(take, g * GROUP, vc[..., 0])
                continue
            lim = torch.minimum(vd[..., -1], pd[..., -1])
            hit = gmin < lim
            hw = torch.zeros((bf, tp, nw), dtype=torch.long, device=dev
                             ).index_add_(2, warp, hit.long())
            taken += int((hw > 0).sum())
            if not bool(hit.any()):
                continue
            # the group's columns under both k-th distances, inserted in
            # order with a strict '<': the list's stable merge with them
            dd = torch.where(dd < pd[..., -1, None], dd, inf)
            code = v[..., None, None] * m + g * GROUP + torch.arange(GROUP, device=dev)
            vd, vc = _stable_merge(vd, vc, dd, code.expand(-1, -1, tq, -1))
        if k == 0:
            # the best group recomputed, its first column equal to the
            # minimum, then merged by (d², id)
            vg, vm = vc[..., 0], vd[..., 0]
            gi = vg.clamp(min=0)[..., None] + torch.arange(GROUP, device=dev)
            at = lambda r: torch.gather(r[:, :, None, :].expand(-1, -1, tq, -1),
                                        3, gi)
            dx, dy, dz = (q3[..., c, None] - at(r) for c, r in enumerate((x, y, z)))
            dg = (dx * dx + dy * dy) + dz * dz
            eq = dg == vm[..., None]
            first = torch.argmax(eq.to(torch.int8), dim=-1, keepdim=True)
            cid = torch.gather(at(t[:, :, tc.CID_ROW]), 3, first)[..., 0]
            vi = torch.where((vg >= 0) & eq.any(-1), cid.long(), -1)
            big = 2**31
            key = lambda i: torch.where(i >= 0, i, big)
            tie = torch.minimum(key(pc[..., 0]), key(vi))
            pc[..., 0] = torch.where(vm < pd[..., 0], vi, torch.where(
                vm == pd[..., 0], torch.where(tie == big, -1, tie), pc[..., 0]))
            pd[..., 0] = torch.minimum(pd[..., 0], vm)
        else:
            for e in range(k):                           # merge_one, in slot order
                pd, pc = _merge_one(pd, pc, vd[..., e], vc[..., e])
    r2 = inf if max_dist == inf else tc.radius2(max_dist)
    kept = live[..., None] & (pd <= r2) & torch.isfinite(pd)
    if k == 0:
        ids = pc
    else:                                                # code v·M + column
        ids = tabs[:, tc.CID_ROW].reshape(-1)[pc.clamp(min=0)].long()
    out_d = torch.where(kept, pd, inf)
    out_i = torch.where(kept, ids, -1)
    if k == 0:
        out_d, out_i = out_d[..., 0], out_i[..., 0]
    tail = () if k == 0 else (k,)
    if q_rows is None:
        shape = (*points.shape[:-1], *tail)
        out = out_d.reshape(shape), out_i.reshape(shape).to(torch.int32)
    else:
        od = torch.full((n, *tail), inf, device=dev)
        oi = torch.full((n, *tail), -1, dtype=torch.int32, device=dev)
        ok = rows.reshape(-1) >= 0
        od[rows.reshape(-1)[ok]] = out_d.reshape(-1, *tail)[ok]
        oi[rows.reshape(-1)[ok]] = out_i.reshape(-1, *tail)[ok].to(torch.int32)
        out = od, oi
    return (*out, {"units": units, "taken": taken})


# ------------------------------------------------------------ test cases
def make_case(name: str, dim: int = 3, tq: int = 64, seed: int = 0,
              near: int = 700) -> dict:
    """A registration's tile step through the port's host tables (numpy
    and torch, on the CPU) → dict: the reference (``ref``, ``rmask``,
    ``cell``), the queries (``q``, ``qm``), ``cap``, the sub-blocks
    ``sub``, the assignment's host form ``per`` (``q_rows``, ``blocks``,
    ``parent``, ``vrows``, ``ncols``) and the step's arguments in the
    ``q_rows`` form, ``args`` = (points, qmask, q_rows, cand_t, ncols,
    vrows).

    ``name``: ``"random"``, a uniform reference with exact duplicates
    (ties) and masked rows, ``near`` queries around it (every 7th masked)
    and TQ + 16 far outside it, cut with a small ``blockCap`` so that parents hold up
    to four or more virtual tiles, one has no candidate and the tile axis
    is padded; ``"ties"``, a reference whose six points nearest the query
    (1.5, 1.5, 1.5) lie at d² = 0.5625 exactly in six cells of two virtual
    tiles of one parent: its row id is 5, not the lowest (0) nor the
    first position's (7) (see :data:`TIE_IDS`)."""
    rng = np.random.default_rng(seed)
    if name == "ties":
        ref, q = _tie_cloud(rng)
        rmask = np.ones(len(ref), bool)
        qm = np.ones(len(q), bool)
        cell, cap = 1.0, 128
    else:
        rr = np.random.default_rng(dim)          # one reference per dim
        ref = rr.uniform(-3, 3, (900, dim)).astype(np.float32)
        ref[1::4] = ref[::4][: len(ref[1::4])]
        rmask = np.ones(len(ref), bool)
        rmask[::5] = False
        q = np.concatenate([rng.uniform(-3, 3, (near, dim)),
                            rng.uniform(50, 51, (tq + 16, dim))]).astype(np.float32)
        qm = np.ones(len(q), bool)
        qm[::7] = False
        cell, cap = 1.5, 128
    sub = ts.build_sub_blocks(ref, rmask, cell)
    ta = ts.assign_tiles(q, qm, sub, tile_q=tq, block_cap=cap)
    per = {"q_rows": ta.q_rows, "blocks": ta.blocks, "parent": ta.parent,
           "vrows": ta.vrows,
           "ncols": ts.live_columns(ta.blocks, len(sub.units) - 1)}
    t = torch.from_numpy
    args = (t(q), t(qm), t(ta.q_rows), ts.gather_candidates(t(sub.units),
                                                           t(ta.blocks)),
            t(per["ncols"]), t(ta.vrows))
    return {"ref": ref, "rmask": rmask, "cell": cell, "q": q, "qm": qm,
            "cap": cap, "tq": tq, "sub": sub, "per": per, "args": args}


#: the "ties" case's equidistant points: (offset from the query, row id);
#: the first four lie in the first virtual tile, in this position order,
#: the last two in the second
TIE_IDS = (((0, 0, -1), 7), ((0, -1, 0), 1), ((-1, 0, 0), 8), ((1, 0, 0), 9),
           ((0, 1, 0), 5), ((0, 0, 1), 0))


def _tie_cloud(rng):
    """One reference point at the corner of each cell of [0, 3)^3 farthest
    from (1.5, 1.5, 1.5), and six at 0.75 from it along the axes, in six
    cells, with the row ids of :data:`TIE_IDS`; 40 queries in its cell."""
    q0 = np.full(3, 1.5)
    fill = []
    for c in np.ndindex(3, 3, 3):
        c = np.asarray(c, float)
        corner = np.where(c == 0, 0.0, np.where(c == 2, 2.875, 1.0))
        fill.append(corner)
    ref = np.zeros((len(fill) + len(TIE_IDS), 3))
    ids = {i for _, i in TIE_IDS}
    for (off, i) in TIE_IDS:
        ref[i] = q0 + 0.75 * np.asarray(off, float)
    others = [i for i in range(len(ref)) if i not in ids]
    ref[others] = fill
    q = np.concatenate([q0[None], rng.uniform(1.05, 1.95, (39, 3))])
    return ref.astype(np.float32), q.astype(np.float32)


def tile_order(cases, warp_mask: bool = True):
    """The serving form of one or more cases on one reference: each scan in
    tile order, stacked as ``parallel/batch.py`` stacks them (padded parent
    tiles masked, sentinel virtual tiles in ``vrows``) → (points, qmask,
    None, cand_t, ncols, vrows), and the stacked ``parent``. With
    ``warp_mask`` the slots 32..63 and TQ/2 + 32 .. TQ/2 + 63 of every
    third parent are masked too: a warp of K8, and at TQ = 256 one of K7,
    with no live query."""
    from libpointmatcher_tpu_torch.parallel.batch import _pad_tile_aux_np

    sub = cases[0]["sub"]
    aux = _pad_tile_aux_np([c["per"] for c in cases], len(sub.units) - 1)
    b, tp, tq = aux["q_rows"].shape
    rows = aux["q_rows"].reshape(b, -1)
    pts = np.stack([c["q"][np.maximum(r, 0)] for c, r in zip(cases, rows)])
    mask = np.stack([(r >= 0) & c["qm"][np.maximum(r, 0)]
                     for c, r in zip(cases, rows)])
    if warp_mask:
        slot = np.arange(tq)
        dead = (((slot >= 32) & (slot < 64))
                | ((slot >= tq // 2 + 32) & (slot < tq // 2 + 64)))
        par = (np.arange(tp) % 3 == 0)[:, None] & dead[None, :]
        mask &= ~np.broadcast_to(par.reshape(-1), mask.shape)
    t = torch.from_numpy
    cand_t = ts.gather_candidates(t(sub.units), t(aux["blocks"]))
    return ((t(pts), t(mask), None, cand_t, t(aux["ncols"]), t(aux["vrows"])),
            t(aux["parent"]))


# ------------------------------------------------------------- recording
def _parent(vrows, cand_t):
    """The ``parent`` argument of a tree whose step still takes it."""
    kd, tp = vrows.shape[-2:]
    bf = vrows.numel() // (kd * tp)
    return tc._parents_of(vrows, bf, cand_t.shape[-3]).reshape(
        *vrows.shape[:-2], -1)


def record(path: str) -> dict:
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch import matchers
    from libpointmatcher_tpu_torch.matchers import BlockGridMatcher
    from libpointmatcher_tpu_torch.ops import knn_self
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    saved = {}

    def keep(name, kernel, call):
        # the matcher's and knn_self's calls: (points, qmask, q_rows, cand_t,
        # max_dist, parent, vrows[, k], ncols)
        pts, qmask, q_rows, cand_t, max_dist, _, vrows = call[:7]
        k, ncols = (call[7], call[8]) if kernel == "K8" else (0, call[7])
        saved[name] = {"kernel": kernel, "k": k, "max_dist": max_dist,
                       "args": tuple(None if x is None else x.cpu() for x in
                                     (pts, qmask, q_rows, cand_t, ncols, vrows)),
                       "parent": _parent(vrows, cand_t).cpu()}

    for n_map in cs.TERRAIN_MAPS:
        rng = np.random.default_rng(7)
        map_pts, side = cs.make_terrain(n_map, rng)
        scans, _ = cs.make_terrain_scans(map_pts, side, rng)
        clouds = [pt.PointCloud.from_numpy(s) for s in scans]
        seq = cs.terrain_sequence(pt)
        main = n_map == cs.TERRAIN_MAPS[0]
        with cs.InputRecorder(knn_self, STEPS["K8"], keep=1) as rec:
            seq.set_map(pt.PointCloud.from_numpy(map_pts), seed=0)
        if main:
            keep("K8 set_map k=10", "K8", rec.calls[0])
        with cs.InputRecorder(matchers, STEPS["K7"], keep=2) as rec:
            register_batch_to_map(seq, clouds, seed=1)
        keep(f"K7 batch {'1e5' if main else '4e5'}", "K7", rec.calls[1])
        if not main:
            continue
        with cs.InputRecorder(matchers, STEPS["K7"], keep=2) as rec:
            register_queue_to_map(seq, clouds * cs.TILE_QUEUE_REPEAT, seed=1,
                                  lanes=cs.QUEUE_LANES)
        keep("K7 queue 1e5", "K7", rec.calls[1])
        seq.matcher = BlockGridMatcher(dict(cs.TILE_MATCHER, knn="3"))
        seq.matcher.init(seq.get_prefiltered_internal_map())
        with cs.InputRecorder(matchers, STEPS["K8"], keep=2) as rec:
            register_batch_to_map(seq, clouds, seed=1)
        keep("K8 batch k=3", "K8", rec.calls[1])
        del seq
        torch.cuda.empty_cache()
    torch.save(saved, path)
    return {name: stats(v) for name, v in saved.items()}


def stats(v) -> dict:
    """The shape and the work of a recorded step (on any device)."""
    pts, qmask, q_rows, cand_t, ncols, vrows = v["args"]
    bf, tp, tq, tv, kd, m = tc._parent_shape(pts, qmask, q_rows, cand_t, ncols,
                                             vrows)
    dev = pts.device
    if q_rows is None:
        live = qmask.reshape(bf, tp, tq)
    else:
        r = q_rows.long()
        live = ((r >= 0) & qmask[r.clamp(min=0)]).reshape(1, tp, tq)
    nlive = live.sum(-1).double()                        # [Bf, Tp]
    vr = vrows.reshape(bf, kd, tp).long()
    at = torch.arange(bf, device=dev)[:, None, None] * tv + vr
    nc = (torch.full((bf * tv,), m, device=dev) if ncols is None
          else ncols.reshape(-1).long())
    real = (cand_t.reshape(bf * tv, tc.DPAD, m)[:, tc.PEN_ROW] == 0).sum(-1)
    # a merge step's virtual tile counts once per parent (the sentinel
    # repeats past a parent's own)
    first = torch.ones_like(vr, dtype=torch.bool)
    first[:, 1:] = vr[:, 1:] != vr[:, :-1]
    cols = (nc[at] * first).sum(1).double()
    cands = (real[at] * first).sum(1).double()
    own = ((nc[at] > 0) & first).sum(1)[nlive > 0].cpu()
    return {"kernel": v["kernel"], "k": v["k"], "scans": bf, "parents": tp,
            "tile_queries": tq, "virtual_tiles": tv, "depth": kd, "columns": m,
            "live_queries": int(nlive.sum()),
            "pairs_per_tile_sweep": bf * tv * tq * m,
            "live_pairs": float((nlive * cols).sum()),
            "valid_pairs": float((nlive * cands).sum()),
            "live_columns": float((cols * (nlive > 0)).sum()),
            "vtiles_per_live_parent": [float(own.double().mean()),
                                       float(np.percentile(own.numpy(), 99)),
                                       int(own.max())] if own.numel() else None}


# ---------------------------------------------------------------- timing
def _ms(fn, reps, device) -> float:
    fn()
    if device == "cpu":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return 1e3 * (time.perf_counter() - t) / reps
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def _sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout.split()
    return 1e6 * float(out[0]) if out else 1.98e9


def bounds(st: dict, sms: int, clock_hz: float) -> dict:
    """The bound (operations at the fp32 peak, or the bytes: each live
    query's coordinates and outputs, the dim + 2 rows of each live column
    of a parent with a live query, read once) and the issue floor."""
    pairs, nq = st["valid_pairs"], st["live_queries"]
    nbytes = 12 * nq + 20 * st["live_columns"] + 8 * max(st["k"], 1) * nq
    t_ops, t_bytes = OPS_PER_PAIR * pairs / FP32_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "issue_floor_ms": 1e3 * OPS_PER_PAIR * pairs
            / (sms * 4 * 32 * clock_hz)}


def _launches(fn) -> dict:
    """The device kernels and memory operations of one call of ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = memops = launches = 0
    for e in prof.events():
        dt = str(getattr(e, "device_type", ""))
        if dt.endswith("CUDA"):
            if "Memcpy" in e.name or "Memset" in e.name:
                memops += 1
            else:
                kernels += 1
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                        "cudaMemcpyAsync", "cudaMemsetAsync"):
            launches += 1
    return {"device_kernels": kernels, "device_memops": memops,
            "runtime_launches": launches}


def time_steps(path, tree, reps, rounds, device="cuda", set_map=False,
               teams=None) -> dict:
    if os.path.abspath(tree) != ROOT:   # the tree's own port, not this one's
        sys.path.insert(0, os.path.abspath(tree))
        for mod in [m for m in sys.modules
                    if m.startswith("libpointmatcher_tpu_torch")]:
            del sys.modules[mod]
    import chip_smoke as cs
    from libpointmatcher_tpu_torch.ops import tile_cuda as ttc
    from libpointmatcher_tpu_torch.ops import tilesweep as tts

    out = {"tree": os.path.abspath(tree), "inputs": {}}
    if device == "cuda":
        ttc.build()
        out["build"] = [ln.strip() for ln in ttc.LIBRARY.build_log.splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = _sm_clock_hz()
    parent_form = hasattr(ttc, "tile_sweep_parents")
    kernels = (("tile_sweep_parents", "tile_sweep_k_parents") if parent_form
               else ("tile_sweep", "tile_sweep_k"))
    for name, v in torch.load(path).items():
        res = stats(v)
        pts, qmask, q_rows, cand_t, ncols, vrows = (
            None if x is None else x.to(device) for x in v["args"])
        parent = v["parent"].to(device)
        k, md = v["k"], v["max_dist"]
        step = getattr(tts, STEPS[v["kernel"]])
        call = [pts, qmask, q_rows, cand_t, md, parent, vrows]
        if k:
            call.append(k)
        kw = ({"ncols": ncols} if "ncols" in inspect.signature(step).parameters
              else {})
        run = lambda: step(*call, **kw)
        d, i = run()
        # the plain version: the parent form's, or the step with the
        # per-tile sweeps' plain versions in a tree without it
        if parent_form:
            plain = (ttc.tile_sweep_parents_plain if k == 0 else
                     lambda *a: ttc.tile_sweep_k_parents_plain(*a, k))
            dp, ip = plain(pts, qmask, q_rows, cand_t, ncols, vrows, md)
        else:
            saved = tts.tile_sweep, tts.tile_sweep_k
            tts.tile_sweep, tts.tile_sweep_k = (ttc.tile_sweep_plain,
                                                ttc.tile_sweep_k_plain)
            try:
                dp, ip = step(*call)
            finally:
                tts.tile_sweep, tts.tile_sweep_k = saved
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"{name}: the step differs from its plain version")
        res["step_ms"] = [_ms(run, reps, device) for _ in range(rounds)]
        wrapper = kernels[0 if k == 0 else 1]
        with cs.InputRecorder(tts, wrapper) as rec:   # the kernel's inputs
            run()
        if device == "cuda":
            res["step_launches"] = _launches(run)
        res["kernel"] = f"{wrapper} x {len(rec.calls)}"
        kernel = lambda: getattr(ttc, wrapper)(*rec.calls[0])
        res["kernel_ms"] = [_ms(kernel, reps, device) for _ in range(rounds)]
        if teams and k == 0 and hasattr(ttc, "TEAMS"):
            own, res["kernel_ms_by_teams"] = ttc.TEAMS, {}
            for t in teams:        # each held to the plain version first
                ttc.TEAMS = t
                dt, it = kernel()
                if not (torch.equal(dt, dp) and torch.equal(it, ip)):
                    raise AssertionError(f"{name}: {t} teams differ from the "
                                         f"plain version")
                res["kernel_ms_by_teams"][str(t)] = [
                    _ms(kernel, reps, device) for _ in range(rounds)]
            ttc.TEAMS = own
        if device == "cuda":
            res.update(bounds(res, sms, clock))
        out["inputs"][name] = res
        del pts, qmask, q_rows, cand_t, ncols, vrows, d, i, dp, ip
        if device == "cuda":
            torch.cuda.empty_cache()
    if set_map:
        out["set_map"] = time_set_map(device)
    return out


def time_set_map(device, reps=3) -> dict:
    """``set_map`` of chip_smoke.py's 10^5-point terrain map (SurfaceNormal
    through the culled self-search, one K8 launch): host seconds of
    ``reps`` calls after a warm-up, each ending in a synchronize, and the
    device kernels and memory operations of one call."""
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt

    map_pts, _ = cs.make_terrain(cs.TERRAIN_MAPS[0], np.random.default_rng(7))
    seq = cs.terrain_sequence(pt)

    def run():
        seq.set_map(pt.PointCloud.from_numpy(map_pts, device=device), seed=0)
        if device == "cuda":
            torch.cuda.synchronize()

    run()
    secs = []
    for _ in range(reps):
        t = time.perf_counter()
        run()
        secs.append(time.perf_counter() - t)
    res = {"points": len(map_pts), "seconds": secs}
    if device == "cuda":
        res.update(_launches(run))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "time"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None, help="the file `record` wrote")
    ap.add_argument("--tree", default=ROOT, help="root of the port to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--set-map", action="store_true",
                    help="also time set_map of the 10^5-point terrain map")
    ap.add_argument("--teams", default=None,
                    help="K7's warps a block for a parent's virtual tiles to "
                    "time in turn, e.g. 1,2,4")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("tile_micro: no CUDA device", file=sys.stderr)
        return 1
    smi = (os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
           if args.device == "cuda" else "cpu (plain versions)")
    if args.mode == "record":
        if not args.out:
            ap.error("record needs --out")
        res = {"device": smi, "recorded": record(args.out)}
    else:
        if not args.inputs:
            ap.error("time needs --inputs")
        teams = [int(x) for x in args.teams.split(",")] if args.teams else None
        res = {"device": smi, **time_steps(args.inputs, args.tree, args.reps,
                                           args.rounds, args.device,
                                           args.set_map, teams)}
    if args.out and args.mode == "time":
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
