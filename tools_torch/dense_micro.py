"""K1, K5 and K9, the dense k-NN kernels, timed at recorded main-path
inputs: the A/B of two trees of the port on one card.

    python3 tools_torch/dense_micro.py record --out FILE
    python3 tools_torch/dense_micro.py time --inputs FILE [--tree DIR]
        [--reps 20] [--rounds 3] [--blocks-per-sm 4,8] [--k9-blocks 2:128,...]
        [--k9-bits FILE] [--shares] [--yardstick] [--device cuda|cpu]
        [--out JSON]

``record`` keeps the positional inputs of five searches, written to FILE
with ``torch.save``:

- ``K1 sequence``: K1 at the second iteration of ``ICPSequence.compute`` on
  chip_smoke.py's 100 000-point scene (its 50 147-row map);
- ``K1 dense batch``: K1 at the second lockstep iteration of a
  ``register_batch_to_map`` of 8 scans on the dense route's map (the ``K1``
  scene of tools_torch/profile_serving.py: 8 × 20 992 query rows);
- ``K1 pairs``: K1's pair axis at the second lockstep iteration of
  ``register_batch`` of 4 one-shot pairs (chip_smoke.py phase 12);
- ``K5 sequence k=5``: K5 at the second iteration of the sequence with
  ``KDTreeMatcher({"knn": "5"})``;
- ``K5 normals k=10``: K5 in ``SurfaceNormal(knn=10)`` on a 50 000-point
  terrain at chip_smoke.py's density, under ``CULL_MIN_POINTS``, so dense.

``time`` loads them and imports the port from ``--tree`` (default: this
checkout), so that an unpacked older commit is timed on the same inputs:
run the trees in turns (parent, change, change, parent), one process each.
Each search is first checked against ``knn_brute_force`` bit for bit, then
timed with CUDA events (``--reps`` launches, ``--rounds`` times), beside
its bound (9 fp32 operations a valid pair at 67 TFLOP/s, or the bytes at
3.35 TB/s) and its issue floor (9 instructions a valid pair at one warp
instruction a clock in each SM partition). ``--blocks-per-sm`` times the
split rule's aims in turn (trees that have ``knn_cuda.BLOCKS_PER_SM``);
``--shares`` adds, for K5, the share of (warp, group) units that take the
insertion branch, from :func:`emulate` on the recorded inputs;
``--yardstick`` times ``torch.cdist`` + ``topk``, one call per pair (cut
where its output would pass 2^31 entries).

Each K1 input (k = 1) also runs K9 (``knn_cuda.knn1_mxu``, the expansion
form), K1 its control: held within 2^-20·(q² + r²max) of
``knn1_mxu_plain``, its ε excess over K1's d² reported, timed the same
way, beside its bound (8 fp32 operations a valid pair) and its issue floor
(6 instructions a valid pair); ``--yardstick`` adds ``torch.cdist`` in
its matmul form (TF32 off) + ``min``. ``--k9-bits FILE`` holds K9's
outputs of every input: the first tree run writes them, a later one must
equal them bit for bit (the A/B of a K9 redesign). ``--k9-blocks`` times
K9 at other split rules, ``K9_BLOCKS_PER_SM:K9_UNIT_ROWS`` (trees with
``knn_cuda.k9_split``).
``--device cpu`` runs the wrappers' plain versions, to check the script;
its times are the host's clock and no measure of the card. Prints one JSON
object (and writes it to ``--out``).

:func:`emulate` is the kernels' schedule in plain torch (chunks as
``knn_cuda._split`` cuts them, ``x + pen`` staging, groups of 8 rows, K1's
group argmin with its recomputed best group, K5's k-slot insertion in
group order, the chunk merge), which tests/test_torch_knn_schedule.py
holds to ``knn_brute_force`` bit for bit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from libpointmatcher_tpu_torch.ops import knn_cuda as kc  # noqa: E402

FP32_FLOPS = 67e12      # H100 SXM, dense fp32 outside the tensor cores
HBM_BYTES_S = 3.35e12
OPS_PER_PAIR = 9
K9_OPS_PER_PAIR = 8     # the dot's 5, q² + r²pen, −2·dot fused with the sum
K9_ISSUE_PER_PAIR = 6   # FMUL, 2 FFMA, FADD, FFMA and the group fold's FMNMX
THREADS = 128           # K1/K5 threads a block (csrc/knn.cu kThreads)


# ------------------------------------------------------------- emulation
def _fmin_groups(d):
    """fminf over the last axis as the kernels fold a group (NaN ignored)."""
    while d.shape[-1] > 1:
        w = d.shape[-1] // 2
        d = torch.fmin(d[..., :w], d[..., w:])
    return d[..., 0]


def _d2(q, x, y, z):
    """d² in the kernels' order against x + pen: q [N, 3] and rows [..., G]
    → [..., N, G]."""
    dx = q[:, 0, None] - x[..., None, :]
    dy = q[:, 1, None] - y[..., None, :]
    dz = q[:, 2, None] - z[..., None, :]
    return (dx * dx + dy * dy) + dz * dz


def _stable_merge(ld, li, d, i):
    """Sorted lists ``(ld, li)`` [..., kk] with the entries ``(d, i)``
    [..., G] inserted in order, each with a strict '<' (equal distances keep
    their arrival order; the kernels' shift insertion): the stable merge,
    cut to kk."""
    kk = ld.shape[-1]
    sd, order = torch.sort(torch.cat([ld, d], -1), dim=-1, stable=True)
    return sd[..., :kk], torch.gather(torch.cat([li, i], -1), -1, order)[..., :kk]


def _emulate_pair(q, qm, r, rm, k, splits, chunk, block=0):
    """One (query set, reference) pair → (d [N, k], i [N, k], taken,
    units): the kernels' partials per chunk, merged in chunk order.
    ``block``: the queries a block of ``THREADS`` threads takes, where not
    ``kc.block_queries`` (T2's, tools_torch/knn_micro.py)."""
    dev = q.device
    inf = float("inf")
    n, m = q.shape[0], r.shape[0]
    kk = 0 if k == 1 else kc.knnk_list(k)
    qb = block or kc.block_queries(kk)
    g_rows = kc.GROUP_ROWS
    n_pad = max(qb, -(-n // qb) * qb)
    q3 = torch.zeros((n_pad, 3), dtype=torch.float32, device=dev)
    q3[:n, :q.shape[1]] = q
    valid = torch.zeros(n_pad, dtype=torch.bool, device=dev)
    valid[:n] = qm
    # query b * qb + j * THREADS + t is thread t's j-th query in block b,
    # in the block's warp t // 32: [..., n_pad] → any per [..., block, warp]
    warp = lambda v: v.reshape(*v.shape[:-1], -1, qb // THREADS,
                               THREADS // 32, 32).any(-1).any(-2)
    live = warp(valid)                                     # [blocks, 4]
    q_live = live[:, None, :, None].expand(
        -1, qb // THREADS, -1, 32).reshape(-1)             # [n_pad]
    # each chunk's rows padded with (+inf, 0, 0) to whole groups
    span = -(-chunk // g_rows) * g_rows
    rows = torch.zeros((splits, span, 3), dtype=torch.float32, device=dev)
    rows[..., 0] = inf
    for c in range(splits):
        j0, j1 = c * chunk, min(m, (c + 1) * chunk)
        pen = torch.where(rm[j0:j1], 0.0, inf).to(torch.float32)
        rows[c, :j1 - j0, 0] = r[j0:j1, 0] + pen
        rows[c, :j1 - j0, 1] = r[j0:j1, 1]
        if r.shape[1] == 3:
            rows[c, :j1 - j0, 2] = r[j0:j1, 2]
    counts = torch.tensor([max(0, min(m, (c + 1) * chunk) - c * chunk)
                           for c in range(splits)], device=dev)
    groups = -(-counts // g_rows)                          # per chunk
    gsz = (splits, n_pad)
    taken = units = 0
    if k == 1:
        best = torch.full(gsz, inf, device=dev)
        grp = torch.full(gsz, -1, dtype=torch.int64, device=dev)
    else:
        bd = torch.full((*gsz, kk), inf, device=dev)
        bi = torch.full((*gsz, kk), -1, dtype=torch.int64, device=dev)
        thr = torch.full(gsz, inf, device=dev)
    for g in range(int(groups.max()) if splits else 0):
        sl = slice(g * g_rows, (g + 1) * g_rows)
        d = _d2(q3, rows[:, sl, 0], rows[:, sl, 1], rows[:, sl, 2])
        d = torch.where(q_live[:, None], d, inf)           # dead warps
        on = (g < groups)[:, None]                         # [splits, 1]
        gmin = _fmin_groups(d)
        if k == 1:
            take = on & (gmin < best)
            best = torch.where(take, gmin, best)
            grp = torch.where(take, g, grp)
            continue
        hit = on & (gmin < thr)
        taken += int((warp(hit) & live).sum())
        units += int(live.sum()) * int(on.sum())
        if not bool(hit.any()):
            continue
        # the group's rows inserted in index order with a strict '<', every
        # query at once: the list's stable merge with them, cut to kk
        rows_g = torch.full(d.shape, g * g_rows, dtype=torch.int64, device=dev)
        bd, bi = _stable_merge(bd, bi, torch.where(on[..., None], d, inf),
                               rows_g + torch.arange(g_rows, device=dev))
        thr = bd[..., -1]
    base = torch.arange(splits, device=dev)[:, None] * chunk
    if k == 1:
        # the first row of the best group whose d² equals the best
        gi = torch.clamp(grp, min=0)[..., None] * g_rows + torch.arange(
            g_rows, device=dev)                            # [splits, n_pad, G]
        sel = torch.gather(rows, 1, gi.reshape(splits, -1, 1).expand(-1, -1, 3)
                           ).reshape(splits, n_pad, g_rows, 3)
        dx = q3[None, :, None, 0] - sel[..., 0]
        dy = q3[None, :, None, 1] - sel[..., 1]
        dz = q3[None, :, None, 2] - sel[..., 2]
        dg = (dx * dx + dy * dy) + dz * dz
        inside = gi < counts[:, None, None]
        eq = (dg == best[..., None]) & inside
        first = torch.argmax(eq.to(torch.int8), dim=-1)
        pid = torch.where((grp >= 0) & eq.any(-1), grp * g_rows + first + base, -1)
        out_d = torch.full((n_pad,), inf, device=dev)
        out_i = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
        for c in range(splits):                            # the merge, in order
            take = best[c] < out_d
            out_d = torch.where(take, best[c], out_d)
            out_i = torch.where(take, pid[c], out_i)
        out_d, out_i = out_d[:, None], out_i[:, None]
    else:
        pid = torch.where(bi >= 0, bi + base[..., None], -1)
        out_d = torch.full((n_pad, kk), inf, device=dev)
        out_i = torch.full((n_pad, kk), -1, dtype=torch.int64, device=dev)
        for c in range(splits):                            # the merge, in order
            out_d, out_i = _stable_merge(out_d, out_i, bd[c], pid[c])
        out_d, out_i = out_d[:, :k], out_i[:, :k]
    out_d, out_i = out_d[:n], out_i[:n]
    ok = torch.isfinite(out_d) & qm[:, None]
    out_d = torch.where(qm[:, None], out_d, inf)
    out_i = torch.where(ok, out_i, -1)
    return out_d, out_i.to(torch.int32), taken, units


def emulate(q, qm, r, rm, k: int = 1, sms: int = 132):
    """The schedule of K1 (``k`` 1) or K5 in plain torch, on any device →
    ``(d [.., N, k], i [.., N, k], taken, units)``: the kernels' results
    and, for K5, of the (live warp, group) units swept, how many took the
    insertion branch. ``sms`` is the SM count the chunks are cut for; with
    a pair axis (``q`` [B, N, d]) the chunks are cut for B pairs."""
    pairs = q.ndim == 3
    qs, qms, rs, rms = ((q, qm, r, rm) if pairs else
                        (q[None], qm[None], r[None], rm[None]))
    kk = 0 if k == 1 else kc.knnk_list(k)
    splits, chunk = kc._split(qs.shape[1], rs.shape[1], sms,
                              qs.shape[0] if pairs else 1, kk,
                              kc.BLOCKS_PER_SM["knn1" if k == 1 else "knnk"])
    outs = [_emulate_pair(*a, k, splits, chunk)
            for a in zip(qs, qms, rs, rms)]
    d = torch.stack([o[0] for o in outs])
    i = torch.stack([o[1] for o in outs])
    taken = sum(o[2] for o in outs)
    units = sum(o[3] for o in outs)
    return (d, i, taken, units) if pairs else (d[0], i[0], taken, units)


def _mxu_sq(x):
    """``(x₀x₀ + x₁x₁) + x₂x₂`` (+ 0 at d = 2), each step rounded, as
    ``knn_cuda.knn1_mxu_plain`` forms q² and r²."""
    return ((x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1])
            + (x[..., 2] * x[..., 2] if x.shape[-1] == 3 else 0.0))


def _mxu_d2(q, q2, r, rp):
    """K9's d² in ``knn1_mxu_plain``'s rounded arithmetic: q [N, d] against
    rows r [..., d] with r²pen rp [...] → ``(q² + r²pen) − 2·dot``,
    ``dot = (q₀r₀ + q₁r₁) + q₂r₂``."""
    dot = None
    for c in range(q.shape[-1]):
        term = q[:, c, None] * r[..., c]
        dot = term if dot is None else dot + term
    return (q2[:, None] + rp) - 2.0 * dot


def _fma32(a, b, c):
    """fma(a, b, c) of float32 arrays with one rounding, as the card's FFMA:
    a·b is exact in float64, TwoSum gives the sum's error, and where the
    float64 sum lies halfway between two float32 values the error decides
    the side (a double rounding would tie to even)."""
    a64, b64, c64 = (np.asarray(x, np.float64) for x in (a, b, c))
    p = a64 * b64
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)             # p + c = s + e exactly
    with np.errstate(invalid="ignore", over="ignore"):
        r = s.astype(np.float32)
        up = np.nextafter(r, np.float32(np.inf))
        dn = np.nextafter(r, np.float32(-np.inf))
        r = np.where((s == (r.astype(np.float64) + up) / 2) & (e > 0), up, r)
        r = np.where((s == (r.astype(np.float64) + dn) / 2) & (e < 0), dn, r)
    return r.astype(np.float32)


def k9_reference(q, qm, r, rm, tile: int = 2048):
    """K9's function in numpy, bit for bit the kernel's: d² = fma(−2, dot,
    q² + r²pen) with dot = fma(qz, rz, fma(qy, ry, qx·rx)), q² and r² as
    ``((x·x + y·y) + z·z)`` (z = 0 at d = 2, as the kernel stages it), r²pen
    +inf at a masked row; the lowest index of the least d² (NaN never
    taken), clamped at 0; (+inf, −1) for a masked query or one with no
    neighbour → ``(d [N] float32, id [N] int32)``."""
    q, r = (np.asarray(x, np.float32) for x in (q, r))
    qm, rm = np.asarray(qm, bool), np.asarray(rm, bool)
    z = lambda x: x[:, 2] if x.shape[1] == 3 else np.zeros(len(x), np.float32)
    sq = lambda x: (x[:, 0] * x[:, 0] + x[:, 1] * x[:, 1]) + z(x) * z(x)
    q2 = sq(q)
    r2pen = np.where(rm, sq(r), np.float32(np.inf)).astype(np.float32)
    n, m = len(q), len(r)
    best = np.full(n, np.inf, np.float32)
    best_i = np.full(n, -1, np.int64)
    for t0 in range(0, m, tile):
        rt = r[t0:t0 + tile]
        dot = _fma32(z(q)[:, None], z(rt)[None], _fma32(
            q[:, 1, None], rt[None, :, 1], q[:, 0, None] * rt[None, :, 0]))
        with np.errstate(invalid="ignore"):
            d = _fma32(np.float32(-2.0), dot, q2[:, None] + r2pen[None, t0:t0 + tile])
        d = np.where(np.isnan(d), np.float32(np.inf), d)
        ti = np.argmin(d, axis=1) if d.shape[1] else np.zeros(n, np.int64)
        td = d[np.arange(n), ti] if d.shape[1] else np.full(n, np.inf, np.float32)
        take = td < best
        best = np.where(take, td, best)
        best_i = np.where(take, ti + t0, best_i)
    best = np.maximum(best, np.float32(0.0))
    ok = np.isfinite(best) & qm
    return (np.where(qm, best, np.float32(np.inf)).astype(np.float32),
            np.where(ok, best_i, -1).astype(np.int32))


def _emulate_k9_pair(q, qm, r, rm, splits, chunk):
    """One (query set, reference) pair through K9's schedule → (d [N],
    id [N])."""
    dev = q.device
    inf = float("inf")
    n, m = q.shape[0], r.shape[0]
    g_rows, bq = kc.K9_GROUP_ROWS, kc.K9_BLOCK_QUERIES
    q2 = _mxu_sq(q)
    r2pen = torch.where(rm, _mxu_sq(r), torch.full_like(r[:, 0], inf))
    # a warp's queries are one contiguous run of bq / 4 (128 threads a
    # block): a warp, or a block, whose queries are all masked does not sweep
    nb = max(1, -(-n // bq))
    valid = torch.zeros(nb * bq, dtype=torch.bool, device=dev)
    valid[:n] = qm
    sweeps = valid.view(nb, 4, bq // 4).any(-1, keepdim=True).expand(
        nb, 4, bq // 4).reshape(-1)[:n]
    # the reference staged as (x, y, z, r²pen), (0, 0, 0, +inf) past its end
    rc = torch.zeros((splits * chunk, q.shape[1]), dtype=torch.float32, device=dev)
    rp = torch.full((splits * chunk,), inf, device=dev)
    rc[:m], rp[:m] = r, r2pen
    best = torch.full((splits, n), inf, device=dev)
    grp = torch.full((splits, n), -1, dtype=torch.int64, device=dev)
    for c in range(splits):
        rows = slice(c * chunk, (c + 1) * chunk)
        d = torch.where(sweeps[:, None], _mxu_d2(q, q2, rc[rows], rp[rows]), inf)
        # each group folded with fminf (NaN ignored; a group of NaN is never
        # taken, as +inf is not), (best, best group) kept with a strict '<'
        gm = torch.where(torch.isnan(d), inf, d).view(
            n, chunk // g_rows, g_rows).amin(-1)
        best[c] = gm.amin(-1)
        first = (gm == best[c][:, None]).int().argmax(-1)
        grp[c] = torch.where(best[c] < inf, c * chunk + first * g_rows, -1)
    # the merge: the chunks in order with a strict '<', then the first row of
    # the winning chunk's best group whose recomputed d² equals the minimum
    out_d = torch.full((n,), inf, device=dev)
    win = torch.full((n,), -1, dtype=torch.int64, device=dev)
    for c in range(splits):
        take = best[c] < out_d
        out_d = torch.where(take, best[c], out_d)
        win = torch.where(take, grp[c], win)
    idx = win[:, None] + torch.arange(g_rows, device=dev)
    inside = (win[:, None] >= 0) & (idx < m)
    idx = idx.clamp(0, max(m - 1, 0))
    if m:
        eq = (_mxu_d2(q, q2, r[idx], r2pen[idx]) == out_d[:, None]) & inside
    else:
        eq = inside
    out_i = torch.where(eq.any(-1), win + eq.int().argmax(-1), -1)
    out_d = torch.clamp(out_d, min=0.0)
    ok = torch.isfinite(out_d) & qm
    return (torch.where(qm, out_d, inf),
            torch.where(ok, out_i, -1).to(torch.int32))


def emulate_k9(q, qm, r, rm, sms: int = 132):
    """K9's schedule in plain torch, on any device → ``(d [.., N], id
    [.., N])``: the reference cut by ``knn_cuda.k9_split`` for ``sms`` SMs
    (with a pair axis, ``q`` [B, N, d], for B pairs); blocks of
    ``K9_BLOCK_QUERIES`` queries, each warp's a contiguous run (a block or
    a warp whose queries are all masked does not sweep); the chunk staged
    as (x, y, z, r²pen), (0, 0, 0, +inf) past its end; each query folds a
    group of ``K9_GROUP_ROWS`` rows with fminf and keeps (best, best group)
    with a strict '<'; the chunks merge unclamped in order with a strict
    '<'; the winning chunk's best group is recomputed and its first row
    equal to the minimum taken; then the clamp at 0 and the query mask.
    d² in ``knn1_mxu_plain``'s rounded arithmetic (the kernel fuses the
    products into FMAs): the schedule is under test, not the rounding."""
    pairs = q.ndim == 3
    qs, qms, rs, rms = ((q, qm, r, rm) if pairs else
                        (q[None], qm[None], r[None], rm[None]))
    splits, chunk = kc.k9_split(qs.shape[1], rs.shape[1], sms, qs.shape[0])
    outs = [_emulate_k9_pair(*a, splits, chunk) for a in zip(qs, qms, rs, rms)]
    d = torch.stack([o[0] for o in outs])
    i = torch.stack([o[1] for o in outs])
    return (d, i) if pairs else (d[0], i[0])


# ------------------------------------------------------------- recording
def record(path: str) -> dict:
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.filters.normals import \
        SurfaceNormalDataPointsFilter
    from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
    from libpointmatcher_tpu_torch.ops import dispatch
    from libpointmatcher_tpu_torch.parallel import (register_batch,
                                                    register_batch_to_map)

    saved = {}

    def keep(name, kernel, k, call):
        q, qm, r, rm = (x.cpu() for x in call[:4])
        saved[name] = {"kernel": kernel, "k": k, "q": q, "qm": qm, "r": r,
                       "rm": rm}

    # the sequence (profile_registration.py's scene and first scans)
    rng = np.random.default_rng(0)
    world = cs.make_scene(rng)
    poses = cs.make_poses(world, 5, rng)
    scans = [cs.make_scan(world, P, rng) for P in poses]
    for name, params, fn, k in (("K1 sequence", {}, "knn1", 1),
                                ("K5 sequence k=5", {"knn": "5"}, "knnk", 5)):
        seq = pt.ICPSequence()
        seq.set_default()
        if params:
            seq.matcher = KDTreeMatcher(params)
        seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        with cs.InputRecorder(dispatch, fn, keep=2) as rec:
            seq.compute(pt.PointCloud.from_numpy(scans[1]),
                        T_init=cs.perturb(rng) @ poses[1], seed=1)
        keep(name, name[:2], k, rec.calls[1])
    # register_batch's pair axis (chip_smoke.py phase 12)
    icp = pt.ICP()
    icp.set_default()
    gts = [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(cs.PAIRS)]
    with cs.InputRecorder(dispatch, "knn1", keep=2) as rec:
        register_batch(icp, [pt.PointCloud.from_numpy(scans[i + 1])
                             for i in range(cs.PAIRS)],
                       [pt.PointCloud.from_numpy(scans[i])
                        for i in range(cs.PAIRS)],
                       T_inits=[cs.perturb(rng) @ g for g in gts], seed=1)
    keep("K1 pairs", "K1", 1, rec.calls[1])
    # the dense serving batch (profile_serving.py's K1 scene: the scenes of
    # the K4 and K3 routes are drawn first, as there)
    rng = np.random.default_rng(0)
    for route, target in cs.SERVE_SCENES.items():
        w = cs.make_scene(rng, target)
        ps = cs.make_poses(w, cs.SERVE_BATCH, rng)
        clouds = [pt.PointCloud.from_numpy(cs.make_scan(w, P, rng)) for P in ps]
        inits = [cs.perturb(rng) @ P for P in ps]
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(w), seed=0)
    with cs.InputRecorder(dispatch, "knn1", keep=2) as rec:
        register_batch_to_map(seq, clouds, T_inits=inits, seed=1)
    keep("K1 dense batch", "K1", 1, rec.calls[1])
    # SurfaceNormal(knn=10) on a terrain under CULL_MIN_POINTS: dense K5
    terrain, _ = cs.make_terrain(50_000, np.random.default_rng(7))
    with cs.InputRecorder(dispatch, "knnk", keep=1) as rec:
        SurfaceNormalDataPointsFilter({"knn": "10"}).filter(
            pt.PointCloud.from_numpy(terrain))
    keep("K5 normals k=10", "K5", 10, rec.calls[0])
    torch.save(saved, path)
    return {name: _shape(v) for name, v in saved.items()}


def _shape(v) -> dict:
    q, qm, r, rm = v["q"], v["qm"], v["r"], v["rm"]
    pairs = int((qm.reshape(-1, qm.shape[-1]).sum(-1).double()
                 * rm.reshape(-1, rm.shape[-1]).sum(-1).double()).sum())
    return {"kernel": v["kernel"], "k": v["k"], "query": list(q.shape),
            "valid_queries": int(qm.sum()), "ref": list(r.shape),
            "valid_refs": int(rm.sum()), "valid_pairs": pairs}


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


def bounds(shape: dict, sms: int, clock_hz: float, ops: int = OPS_PER_PAIR,
           issue: int = OPS_PER_PAIR) -> dict:
    """The bound (``ops`` operations a valid pair at the fp32 peak, or
    bytes at the HBM rate) and the issue floor (``issue`` instructions a
    valid pair, one warp instruction a clock in each of an SM's four
    partitions)."""
    pairs = shape["valid_pairs"]
    rows = int(np.prod(shape["query"][:-1])) + int(np.prod(shape["ref"][:-1]))
    nbytes = 13 * rows + 8 * int(np.prod(shape["query"][:-1])) * shape["k"]
    t_ops, t_bytes = ops * pairs / FP32_FLOPS, nbytes / HBM_BYTES_S
    return {"bound_ms": 1e3 * max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "issue_floor_ms": 1e3 * issue * pairs / (sms * 4 * 32 * clock_hz)}


def _k9(tkc, q, qm, r, rm, reps, rounds, device, sms, rules, yardstick, k1):
    """K9 at one K1 input: within 2^-20·(q² + r²max) of its plain version
    with the same misses, its ε excess over K1's d² (``k1``: K1's output);
    timed at this tree's split rule and at the other ``rules``
    ``(K9_BLOCKS_PER_SM, K9_UNIT_ROWS)`` → (record, (d, id))."""
    run = lambda: tkc.knn1_mxu(q, qm, r, rm)

    def plain():
        if q.ndim == 2:
            return tkc.knn1_mxu_plain(q, qm, r, rm)
        return tuple(torch.stack(x) for x in zip(*(
            tkc.knn1_mxu_plain(*a) for a in zip(q, qm, r, rm))))

    d, i = run()
    dp, ip = plain()
    d1, i1 = k1
    q2 = (q * q).sum(-1)
    r2max = (torch.where(rm, (r * r).sum(-1), 0.0).amax(-1, keepdim=True)
             if r.numel() else torch.zeros_like(q2[..., :1]))
    tol = 2.0 ** -20 * (q2 + r2max)
    fin = torch.isfinite(dp)
    if not (torch.equal(fin, torch.isfinite(d))
            and bool(((d - dp).abs() <= tol)[fin].all())):
        raise AssertionError("K9: |Δd²| to its plain version above 2^-20·(q²+r²max)")
    if not torch.equal(i == -1, ip == -1):
        raise AssertionError("K9: its misses differ from its plain version's")
    # the (1+ε) contract: the exact distance of K9's pick over K1's
    pick = torch.gather(r, -2, i.clamp(min=0).long()[..., None].expand(
        *i.shape, r.shape[-1]))
    diff = q - pick
    dj = diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1]
    if diff.shape[-1] == 3:
        dj = dj + diff[..., 2] * diff[..., 2]
    ok = fin & (d1 > 0)
    res = {"K9 max_abs_err": float((d - dp).abs()[fin].max()) if fin.any() else 0.0,
           "K9 eps_excess": float((torch.sqrt(dj[ok] / d1[ok]) - 1).max())
           if ok.any() else 0.0,
           "K9 id_agreement_k1": float((i[qm] == i1[qm]).float().mean())}
    own = ((tkc.K9_BLOCKS_PER_SM, tkc.K9_UNIT_ROWS)
           if hasattr(tkc, "k9_split") else None)
    for rule in [own] + ([x for x in rules if x != own] if own else []):
        if rule is not None:
            tkc.K9_BLOCKS_PER_SM, tkc.K9_UNIT_ROWS = rule
        key = "K9 ms" if rule == own else "K9 ms blocks {}:{}".format(*rule)
        if rule != own:
            db, ib = run()
            if not (torch.equal(db, d) and torch.equal(ib, i)):
                raise AssertionError(f"K9 at split rule {rule} differs")
        res[key] = [_ms(run, reps, device) for _ in range(rounds)]
        if own is not None:
            n, m = q.shape[-2], r.shape[-2]
            res[key.replace("ms", "splits, chunk")] = list(tkc.k9_split(
                n, m, sms if device == "cuda" else 132,
                q.shape[0] if q.ndim == 3 else 1))
    if own is not None:
        tkc.K9_BLOCKS_PER_SM, tkc.K9_UNIT_ROWS = own
    if device == "cuda" and yardstick:
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            calls = [(a, b[bm]) for a, b, bm in zip(q.reshape(-1, *q.shape[-2:]),
                                                  r.reshape(-1, *r.shape[-2:]),
                                                  rm.reshape(-1, rm.shape[-1]))]
            res["K9 yardstick_ms"] = _ms(lambda: [torch.cdist(
                a, b, compute_mode="use_mm_for_euclid_dist").min(dim=1)
                for a, b in calls], 3, device)
            res["K9 plain_ms"] = _ms(plain, 1, device)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    return res, (d, i)


def time_kernels(path, tree, reps, rounds, aims=None, shares=False,
                 yardstick=False, device="cuda", morton=False, k9_blocks=(),
                 k9_bits=None) -> dict:
    if os.path.abspath(tree) != ROOT:   # the tree's own port, not this one's
        sys.path.insert(0, os.path.abspath(tree))
        for mod in [m for m in sys.modules
                    if m.startswith("libpointmatcher_tpu_torch")]:
            del sys.modules[mod]
    from libpointmatcher_tpu_torch.ops import knn_cuda as tkc
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    out = {"tree": os.path.abspath(tree), "inputs": {}}
    if device == "cuda":
        tkc.build()
        out["build"] = [ln.strip() for ln in tkc.LIBRARY.build_log.splitlines()
                        if "Compiling entry" in ln or "registers" in ln
                        or "spill" in ln]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        clock = _sm_clock_hz()
    else:
        sms, clock = 132, 1.98e9
    has_aim = hasattr(tkc, "BLOCKS_PER_SM")
    if aims and not has_aim:
        raise SystemExit(f"{tree}: its port has no BLOCKS_PER_SM")
    k9_out = {}
    for name, v in torch.load(path).items():
        q, qm, r, rm = (v[x].to(device) for x in ("q", "qm", "r", "rm"))
        k = v["k"]
        run = ((lambda: tkc.knn1(q, qm, r, rm)) if k == 1 else
               (lambda: tkc.knnk(q, qm, r, rm, k)))
        d, i = run()
        d = d[..., None] if k == 1 else d
        i = i[..., None] if k == 1 else i
        dp, ip = knn_brute_force(q, qm, r, rm, k=k)
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"{name}: the kernel differs from "
                                 f"knn_brute_force")
        res = _shape(v)
        wrapper = "knn1" if k == 1 else "knnk"
        own = tkc.BLOCKS_PER_SM[wrapper] if has_aim else None
        times = {}
        for aim in aims or [own]:
            if has_aim:
                tkc.BLOCKS_PER_SM[wrapper] = aim
            times[str(aim)] = [_ms(run, reps, device) for _ in range(rounds)]
        if has_aim:
            tkc.BLOCKS_PER_SM[wrapper] = own
        res["ms"] = times
        if k == 1:
            rec, k9_out[name] = _k9(tkc, q, qm, r, rm, reps, rounds, device,
                                    sms, k9_blocks, yardstick,
                                    (d[..., 0], i[..., 0]))
            res.update(rec)
            if device == "cuda":
                res["K9 bound"] = bounds(res, sms, clock, K9_OPS_PER_PAIR,
                                         K9_ISSUE_PER_PAIR)
        if device == "cuda":
            res.update(bounds(res, sms, clock))
            if yardstick:
                # one cdist + topk per pair, each cut so that its output
                # stays under 2^31 entries (the kernels' grid limit)
                calls = []
                for a, b, bm in zip(q.reshape(-1, *q.shape[-2:]),
                                    r.reshape(-1, *r.shape[-2:]),
                                    rm.reshape(-1, rm.shape[-1])):
                    rows = max(1, (2**31 - 1) // max(int(bm.sum()), 1))
                    calls += [(a[i:i + rows], b[bm]) for i in range(0, len(a), rows)]
                lib = lambda: [torch.cdist(a, b, compute_mode=(
                    "donot_use_mm_for_euclid_dist")).topk(k, dim=1, largest=False)
                    for a, b in calls]
                res["yardstick_ms"] = _ms(lib, 1, device)
                res["yardstick_calls"] = len(calls)
                del calls
                torch.cuda.empty_cache()
        if morton and k > 1 and q.ndim == 2:
            # the same search with the queries in Morton order: each query's
            # result is its own, so only the warps' spatial spread changes
            from libpointmatcher_tpu_torch.ops.morton import morton_argsort_device
            order = morton_argsort_device(q, qm)
            qs, qms = q[order].contiguous(), qm[order].contiguous()
            ds, is_ = tkc.knnk(qs, qms, r, rm, k)
            if not (torch.equal(ds, d[order]) and torch.equal(is_, i[order])):
                raise AssertionError(f"{name}: sorted queries gave other results")
            res["ms_morton_queries"] = [_ms(lambda: tkc.knnk(qs, qms, r, rm, k),
                                            reps, device) for _ in range(rounds)]
            res["morton_order_ms"] = _ms(lambda: morton_argsort_device(q, qm),
                                         reps, device)
            if shares:
                _, _, taken, units = emulate(qs, qms, r, rm, k,
                                             sms if device == "cuda" else 132)
                res["insertion_share_morton"] = taken / max(units, 1)
        if shares and k > 1:
            _, _, taken, units = emulate(q, qm, r, rm, k,
                                         sms if device == "cuda" else 132)
            res["insertion_units"] = [taken, units]
            res["insertion_share"] = taken / max(units, 1)
        out["inputs"][name] = res
        del q, qm, r, rm, d, i, dp, ip
        if device == "cuda":
            torch.cuda.empty_cache()
    if k9_bits:
        k9_out = {name: tuple(x.cpu() for x in v) for name, v in k9_out.items()}
        if os.path.exists(k9_bits):
            want = torch.load(k9_bits)
            same = {name: want.keys() == k9_out.keys() and all(
                torch.equal(a.view(torch.int32), b.view(torch.int32))
                for a, b in zip(want[name], k9_out[name])) for name in k9_out}
            out["K9 equal to " + k9_bits] = same
            if not all(same.values()):
                raise AssertionError(f"K9's outputs differ from {k9_bits}: {same}")
        else:
            torch.save(k9_out, k9_bits)
            out["K9 written to"] = k9_bits
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=("record", "time"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--inputs", default=None, help="the file `record` wrote")
    ap.add_argument("--tree", default=ROOT, help="root of the port to time")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--blocks-per-sm", default=None,
                    help="the split rule's aims to time, e.g. 4,8")
    ap.add_argument("--k9-blocks", default="",
                    help="other split rules to time K9 at, BLOCKS:UNIT_ROWS "
                         "(K9_BLOCKS_PER_SM, K9_UNIT_ROWS), e.g. 2:128,4:32")
    ap.add_argument("--k9-bits", default=None,
                    help="K9's outputs: written if absent, else compared")
    ap.add_argument("--shares", action="store_true")
    ap.add_argument("--yardstick", action="store_true")
    ap.add_argument("--morton", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    if args.device == "cuda" and not torch.cuda.is_available():
        print("dense_micro: no CUDA device", file=sys.stderr)
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
        aims = ([int(x) for x in args.blocks_per_sm.split(",")]
                if args.blocks_per_sm else None)
        res = {"device": smi, **time_kernels(
            args.inputs, args.tree, args.reps, args.rounds, aims, args.shares,
            args.yardstick, args.device, args.morton,
            [tuple(int(y) for y in x.split(":")) for x in args.k9_blocks.split(",")
             if x], args.k9_bits)}
        if args.out:
            os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
            with open(args.out, "w") as f:
                json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
