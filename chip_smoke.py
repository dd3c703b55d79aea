"""Smoke run of libpointmatcher_tpu_torch on one CUDA card (Hopper, sm_90).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
   compute capability 9.0 is required;
2. build: every kernel source of ``libpointmatcher_tpu_torch/csrc``
   (knn.cu, sweep.cu, tile.cu, skip.cu, knn_variants.cu), one nvcc each,
   all started together; ptxas's register and spill report, and no spill
   in knn.cu (K1, K9 and every K5 list length);
3. dense kernels: K1, K9 and K5 against their plain torch versions on the
   card, at the serving shapes 20480 x 12459 and 25000 x 100000, timed with
   CUDA events beside the plain version and a ``torch.cdist`` yardstick;
4. one-shot and sequence registration: a synthetic indoor scene of about
   100 000 points and scans of 25 000 points (numpy, seeded); the
   filters draw JAX's threefry values from each call's seed. One one-shot
   ``ICP`` of two scans, ``ICPSequence.set_map`` on the scene and eight
   scans through ``compute``, each pose held to the ground truth (rotation
   < 0.02 rad, translation < 0.05 m). Kernel launch counts are set to 0
   just before and read just after; the same is done for a matcher with
   ``epsilon`` at the K9 floor (the K9 route) and one with ``knn`` = 5
   (the K5 route);
5. K1, K9 and K5 once more at the shapes the sequence gave them;
6. survivor kernels: K2, K3 and K4 against their plain versions on a batch
   of 8 scans of 25 000 points, flattened, against the scene's map of
   50 147 rows (K4) and the map of a 60 000-point scene (about 30 000
   rows, K3), cold and with a transported bound: K2's bounds and flags
   equal, K3 and K4 equal to their plain versions and to each other, both
   at K2's own 256-query flags (the route's) and at their 1024-query fold,
   and the two folds equal on every valid query; the survivor route's d2
   equal to K1's bit for bit and its ids equal to K1's through the Morton
   order where the neighbour is unique, and every valid query's true
   neighbour in a surviving chunk; the survivor lists' lengths per tile
   (mean, 99th percentile, maximum) and the pairs swept are logged at both
   folds;
7. batch serving: ``register_batch_to_map`` of 8 scans on the 50 147-row
   map (K2 + K4), the ~30 000-row map (K2 + K3) and the map of a
   25 000-point scene (under 16 384 rows: K1), each pose held to the
   ground truth; the launches of each run, counted from 0, equal the
   lockstep iteration count on the route's kernels and 0 on the others;
   the same batch with ``block=False`` gives the same poses; the 8 scans'
   reading draws formed on the card equal the same draws formed on the CPU
   bit for bit, and the host time of each batch's prep (the scans'
   chains, draws included, order, compaction and stacking) is logged;
8. K2, K3 and K4 once more at the inputs the serving runs gave them (the
   second lockstep iteration), timed beside the plain versions and, for
   K3 and K4, a ``torch.cdist`` yardstick; K3 is also timed at K4's inputs
   and K4 at K3's, each sweep also at the 1024-query fold and with only its
   longest list kept; the sweeps' bound counts the pairs the route sweeps
   (its 256-query tiles), and the pairs of the 1024-query fold and the bound
   over them, with the list statistics, are logged beside it;
9. K6, the top-k survivor sweep, against its plain version for k = 2, 3
   and 4 on the 8 scans of phase 6 against the ~30 000-row map, cold and
   with a transported bound: equal bit for bit, and the route's d² equal
   to K5's dense top-k column for column, its ids equal to K5's through
   the Morton order where the neighbour is unique;
10. K1's pair axis: 4 scans against 4 other scans in one launch, equal bit
   for bit to 4 single launches and to the plain version;
11. queue serving: ``register_queue_to_map`` of 64 scans of 25 000 points
   through 8 lanes, plain and coarse-to-fine ``(4, 16, 1.0)``, on the
   K4, K3 and dense maps, then with ``knn`` = 3 under
   ``PMTPU_SERVE_SKIP=1`` on the K3 map (K2 + K6). Every pose is held to
   the ground truth; the launches of each run, counted from 0, equal the
   lane iterations of both passes on the route's kernels and 0 on the
   others; the plain queue's first 8 scans equal a
   ``register_batch_to_map`` of the same 8 in iterations and codes;
   registrations per second are logged. Each c2f run records the inputs of
   its coarse pass's first two matcher calls (8 lanes at the coarse pool's
   cap), and the route's kernels are held to their plain versions there:
   K2, K3, K4 and K1 as in phase 6, K6 as in phase 9, K1 on the dense map.
   K6 is then timed at the knn = 3 queue's inputs (its second lane
   iteration) beside its plain version and a ``torch.cdist`` + ``topk``
   yardstick;
12. ``register_batch``: 4 one-shot pairs, each scan against the one before
   it, under the pose gates, with K1 launches equal to the lockstep
   iterations; every K1 call of that run (filtered readings against
   references of other row counts, each pair padded to the largest) is
   held to its plain version and to one launch per pair, bit for bit;
13. large-map tile-sweep serving, the configuration of
   tools/large_reg_bench.py: a terrain map of 10^5 points at 120 points/m²
   and 8 scans of ~18 500 points (7 m balls, 0.02 m of noise, priors up to
   2° and 0.3 m off), chain ``RandomSampling(0.75)`` / ``SurfaceNormal(knn=10)``
   / ``BlockGridMatcher(maxDist=0.5, motionBound=1.0, tileQueries=64,
   blockCap=1024)`` / ``TrimmedDist(0.85)`` / ``PointToPlane`` /
   ``Counter(40)`` + ``Differential``. ``set_map`` runs SurfaceNormal
   through the culled self-search: one K8 launch (k = 10), its inputs
   recorded and K8 held to its plain version there bit for bit, and the
   whole search held to dense K5 (d² equal, ids where unique);
14. ``register_batch_to_map`` of the 8 scans on that map: every pose under
   the gates, no motion-bound flag, K7 launches equal to the lockstep
   iterations and no other k-NN launch; the second lockstep iteration's K7
   call is recorded and held to its plain version bit for bit, and the
   step's result, ``maxDist`` applied, to dense K1 wherever K1's neighbour
   lies within ``maxDist`` (equal d², equal ids where unique, +inf beyond);
15. ``register_queue_to_map`` of 24 scans (the 8, three times) through 8
   lanes on that map: every pose under the gates, no motion-bound flag, K7
   launches equal to the lane iterations, the first 8 scans' iterations and
   codes equal to the batch's;
16. one batch of the 8 scans against a 4·10^5-point terrain map, under the
   same gates and launch rule. K7 and K8 are timed at their recorded inputs
   beside their plain versions and a batched ``torch.cdist`` yardstick;
17. the v1 skip route's kernels K10 and K11 on the 8 scans of phase 6
   against the ~30 000-row map, cold and with a transported bound: K10 and
   K11 equal to their plain versions bit for bit, the v1 step (with the
   transported bound alone and tightened by K10) equal to dense K1 (d², and
   ids through the Morton order where the neighbour is unique), every valid
   query's true neighbour in a super-chunk its tile does not skip, and K10's
   bound above K1's d² on every valid query; the effective error constant of
   K10 is logged and must leave 8x headroom under ``BOUND_ERR_C``; the
   skipped shares are logged;
18. serving through the v1 routes on that map: ``register_batch_to_map`` of
   the 8 scans of phase 7 under ``PMTPU_SKIP_V1=1``, under it with
   ``PMTPU_SKIP_MXU_BOUND=1``, and under it with ``PMTPU_SKIP_HOST_MORTON=1``;
   ``register_queue_to_map`` of phase 11's 64 scans through 8 lanes, plain
   and coarse-to-fine, under both switches. Every pose under the gates;
   launches, counted from 0, equal to the iterations for K11 (and K10 under
   the bound switch) and 0 for every other kernel; per scan, iterations and
   codes equal, and T within 1e-6 of, the survivor route's runs of the same
   scans (phases 7 and 11; for the host order, a survivor-route batch under
   the same switch); registrations per second logged. K10 and K11 are timed
   at the bound-switch batch's second lockstep iteration beside their plain
   versions and their yardsticks, one call per scan: ``(qa @ ra).amin(-1)``
   in fp32 (TF32 off) for K10, ``torch.cdist`` + ``min`` against the sorted
   map for K11;
19. K7's ablations T4 and T5 (tools_torch/tile_kernel_micro.py) at phase
   14's recorded K7 inputs, and through the tool itself at its shape (2048
   tiles × 256 queries × 4096 candidates), its launches counted from 0: both
   equal their plain version and K7's d² bit for bit; timed there beside K7
   and a batched ``torch.cdist`` + ``amin`` yardstick;
20. the 1-NN lowerings T1, T2 and T3 (tools_torch/knn_micro.py) at the
   tool's shape (20 480 x 12 459, uniform in [-10, 10]^3, the last 7% of
   the queries masked) and at phase 5's recorded K1 inputs: each equal to
   its plain version bit for bit, T1 and T2 equal to K1 in d² and ids, T3
   within 2^-20·(q² + r²max) of K1's d² with ids equal where the neighbour
   is unique beyond that bound; timed beside the plain versions and a
   yardstick (``torch.cdist`` + ``min``, the difference form for T1 and T2,
   the matrix-product form with TF32 off for T3); then the tool itself
   runs once, its launches counted from 0.

The second-to-last line is the JSON of kernels, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result. Only the port is imported.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# Published H100 SXM peaks (dense, no sparsity), used for the bound.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

SCENE_POINTS = 100_000
SCAN_POINTS = 25_000
SEQ_SCANS = 8
ROT_TOL = 0.02
TRANS_TOL = 0.05
SERVE_BATCH = 8
#: scene sizes of the three serving maps: SamplingSurfaceNormal keeps about
#: half, so the K4 (> 32768 rows), K3 (16384..32768) and dense (< 16384)
#: routes
SERVE_SCENES = {"K4": SCENE_POINTS, "K3": 60_000, "K1": 25_000}


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ scene
def _plane(rng, origin, u, v, nu, nv, density):
    n = max(int(nu * nv * density), 1)
    a = rng.uniform(0, nu, n)
    b = rng.uniform(0, nv, n)
    return (np.asarray(origin, float) + a[:, None] * np.asarray(u, float)
            + b[:, None] * np.asarray(v, float))


def _box(rng, center, size, density):
    sx, sy, sz = size
    o = np.asarray(center, float) - np.asarray(size, float) / 2
    return np.concatenate([
        _plane(rng, o, [1, 0, 0], [0, 1, 0], sx, sy, density),
        _plane(rng, o + [0, 0, sz], [1, 0, 0], [0, 1, 0], sx, sy, density),
        _plane(rng, o, [1, 0, 0], [0, 0, 1], sx, sz, density),
        _plane(rng, o + [0, sy, 0], [1, 0, 0], [0, 0, 1], sx, sz, density),
        _plane(rng, o, [0, 1, 0], [0, 0, 1], sy, sz, density),
        _plane(rng, o + [sx, 0, 0], [0, 1, 0], [0, 0, 1], sy, sz, density),
    ])


def make_scene(rng, target=SCENE_POINTS):
    """An apartment-like room (floor, ceiling, walls, a split inner wall,
    furniture boxes), in the style of tools/synth_eth.py, resampled to
    ``target`` points."""
    W, L, H, d = 14.0, 10.0, 2.8, 300.0
    parts = [_plane(rng, [0, 0, 0], [1, 0, 0], [0, 1, 0], W, L, d),
             _plane(rng, [0, 0, H], [1, 0, 0], [0, 1, 0], W, L, d / 2)]
    for o, u, nu in (([0, 0, 0], [1, 0, 0], W), ([0, L, 0], [1, 0, 0], W),
                     ([0, 0, 0], [0, 1, 0], L), ([W, 0, 0], [0, 1, 0], L)):
        parts.append(_plane(rng, o, u, [0, 0, 1], nu, H, d))
    parts.append(_plane(rng, [W / 2, 0, 0], [0, 1, 0], [0, 0, 1], L * 0.4, H, d))
    parts.append(_plane(rng, [W / 2, L * 0.6, 0], [0, 1, 0], [0, 0, 1],
                        L * 0.4, H, d))
    for _ in range(10):
        c = [rng.uniform(1, W - 1), rng.uniform(1, L - 1), rng.uniform(0.3, 0.9)]
        parts.append(_box(rng, c, rng.uniform(0.4, 1.6, 3), d))
    world = np.concatenate(parts)
    return world[rng.choice(len(world), target, replace=False)]


def _yaw(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1.0]])


def make_poses(world, n, rng):
    """Sensor→world poses walking through the scene."""
    lo, hi = world.min(0), world.max(0)
    pos = (lo + hi) / 2
    pos[2] = lo[2] + 1.3
    ang = rng.uniform(0, 2 * np.pi)
    poses = []
    for _ in range(n):
        P = np.eye(4)
        P[:3, :3] = _yaw(ang)
        P[:3, 3] = pos
        poses.append(P)
        ang += rng.uniform(-0.25, 0.25)
        pos = pos + _yaw(ang)[:, 0] * rng.uniform(0.15, 0.45)
        pos[:2] = np.clip(pos[:2], lo[:2] + 1, hi[:2] - 1)
    return poses


def make_scan(world, P, rng, target=SCAN_POINTS):
    """Range-limited, range-noised scan in the sensor frame."""
    Pinv = np.linalg.inv(P)
    local = world @ Pinv[:3, :3].T + Pinv[:3, 3]
    r = np.linalg.norm(local, axis=1)
    keep = (r > 0.7) & (r < 15.0)
    local, r = local[keep], r[keep]
    sel = rng.choice(len(local), min(target, len(local)), replace=False)
    local, r = local[sel], r[sel]
    noise = (rng.standard_normal(len(local)) * (0.005 + 0.002 * r))[:, None]
    local = local + local / r[:, None] * noise + 0.002 * rng.standard_normal(local.shape)
    return local.astype(np.float32)


def perturb(rng, trans_sigma=0.08, rot_sigma=0.03):
    dT = np.eye(4)
    w = rng.standard_normal(3) * rot_sigma
    th = np.linalg.norm(w)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    dT[:3, :3] = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    dT[:3, 3] = rng.standard_normal(3) * trans_sigma
    return dT


def pose_error(T, gT):
    T = np.asarray(T, np.float64)
    R = T[:3, :3] @ gT[:3, :3].T
    ang = float(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return ang, float(np.linalg.norm(T[:3, 3] - gT[:3, 3]))


# ----------------------------------------------------------------- timing
def reset_launch_counts() -> None:
    """Every kernel wrapper's launch count to 0."""
    from libpointmatcher_tpu_torch.ops import (knn_cuda, knn_variants_cuda,
                                               skip_cuda, sweep_cuda, tile_cuda)

    for mod in (knn_cuda, sweep_cuda, tile_cuda, skip_cuda, knn_variants_cuda):
        mod.reset_launch_counts()


def cuda_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


KERNELS = {
    # name: (TPU kernel it replaces, fp32 operations per pair)
    "K1 knn1": ("libpointmatcher_tpu/ops/knn_pallas.py:32", 9),
    "K9 knn1_mxu": ("libpointmatcher_tpu/ops/knn_pallas.py:93", 8),
    "K5 knnk": ("libpointmatcher_tpu/ops/knn_pallas.py:123", 9),
    # per (query row, chunk column): 13 operations for the bound, 20 for
    # the flag (csrc/sweep.cu)
    "K2 survivors_and_bounds": ("libpointmatcher_tpu/ops/knn_sweep2.py:132", 33),
    # per (valid query, valid row of a surviving chunk), as K1
    "K3 nn1_survivor_sweep": ("libpointmatcher_tpu/ops/knn_sweep2.py:242", 9),
    "K4 nn1_survivor_sweep_stream": ("libpointmatcher_tpu/ops/knn_sweep2.py:482", 9),
    # per (valid query, valid row of a surviving chunk), as K3; the top-k
    # insertions are rare and not counted
    "K6 nnk_survivor_sweep": ("libpointmatcher_tpu/ops/knn_sweep2.py:349", 9),
    # per (valid query, valid candidate) of a tile, as K1; K8's insertions
    # are not counted
    "K7 tile_sweep": ("libpointmatcher_tpu/ops/tilesweep.py:460", 9),
    "K8 tile_sweep_k": ("libpointmatcher_tpu/ops/tilesweep.py:737", 9),
    # per (valid query, valid map row): five products, four sums, one min
    "K10 approx_min_sorted": ("libpointmatcher_tpu/ops/knn_skip.py:270", 10),
    # per (valid query, valid row of a super-chunk its tile does not skip)
    "K11 nn1_sorted_skip": ("libpointmatcher_tpu/ops/knn_skip.py:377", 9),
    # per (valid query, valid candidate) of a tile, as K7
    "T4 tile_min_only": ("tools/tile_kernel_micro.py:79", 9),
    "T5 tile_min_one": ("tools/tile_kernel_micro.py:131", 9),
    # per (valid query, valid reference): as K1, and as K9 for T3
    "T1 knn1_chunked": ("tools/knn_variants.py:26", 9),
    "T2 knn1_transposed": ("tools/knn_variants.py:122", 9),
    "T3 knn1_mxu": ("tools/knn_variants.py:195", 8),
}
QUEUE_SCANS = 64
QUEUE_LANES = 8
COARSE = (4, 16, 1.0)
PAIRS = 4


def bound_ms(name, n_valid, m_valid, n, m, k):
    """Least time on the card: operations over the fp32 peak, or bytes
    (inputs read once, outputs written once) over the HBM rate."""
    ops = KERNELS[name][1] * n_valid * m_valid
    nbytes = 13 * (n + m) + 8 * n * k
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def check_kernel(torch, kc, name, q, qm, r, rm, k, reps=20, plain_reps=3):
    """Kernel vs plain version on the card → dict of measurements."""
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    n, m = q.shape[0], r.shape[0]
    if name.startswith("K1"):
        run = lambda: kc.knn1(q, qm, r, rm)
        plain = lambda: knn_brute_force(q, qm, r, rm, k=1)
        lib = lambda: torch.cdist(q, r[rm], compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
    elif name.startswith("K9"):
        run = lambda: kc.knn1_mxu(q, qm, r, rm)
        plain = lambda: kc.knn1_mxu_plain(q, qm, r, rm)
        lib = lambda: torch.cdist(q, r[rm], compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
    else:
        run = lambda: kc.knnk(q, qm, r, rm, k)
        plain = lambda: knn_brute_force(q, qm, r, rm, k=k)
        lib = lambda: torch.cdist(q, r[rm], compute_mode="donot_use_mm_for_euclid_dist").topk(
            k, dim=1, largest=False)
    d, i = run()
    dp, ip = plain()
    torch.cuda.synchronize()
    d, i, dp, ip = (x.reshape(n, -1) for x in (d, i, dp, ip))
    fin = torch.isfinite(dp)
    if not torch.equal(fin, torch.isfinite(d)):
        raise AssertionError(f"{name}: finite pattern differs from the plain version")
    err = float((d[fin] - dp[fin]).abs().max()) if fin.any() else 0.0
    out = {"max_abs_err": err}
    if name.startswith("K9"):
        # expansion form: both sides round the uncancelled terms q² and r²
        # (the kernel with FMAs), so the bound scales with their size
        q2 = (q * q).sum(dim=1)
        r2max = float((r[rm] * r[rm]).sum(dim=1).max())
        tol = 2.0 ** -20 * (q2[:, None] + r2max)
        if not bool(((d - dp).abs() <= tol)[fin].all()):
            raise AssertionError(f"{name}: |Δd²| above 2^-20·(q²+r²max)")
        # ids equal where the nearest neighbour is unique beyond that bound
        d1, i1 = kc.knn1(q, qm, r, rm)
        dk, _ = kc.knnk(q, qm, r, rm, 2)
        second = dk[:, 1]
        unique = fin[:, 0] & ((second - d1) > 2 * tol[:, 0])
        if not torch.equal(i[:, 0][unique], ip[:, 0][unique]):
            raise AssertionError(f"{name}: ids differ where the neighbour is unique")
        # (1+ε) contract: exact distance of K9's pick vs the exact optimum
        pick = r[i[:, 0].clamp(min=0).long()]
        diff = q - pick
        dj = ((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
              + diff[:, 2] * diff[:, 2])
        ok = fin[:, 0] & (d1 > 0)
        excess = float((torch.sqrt(dj[ok] / d1[ok]) - 1.0).max()) if ok.any() else 0.0
        out["eps_excess"] = excess
        out["id_agreement"] = float((i == ip).float().mean())
    else:
        if not (torch.equal(d[fin], dp[fin]) and torch.equal(i, ip)):
            raise AssertionError(f"{name}: kernel and plain version differ")
        out["id_agreement"] = 1.0
    out["ms"] = cuda_ms(torch, run, reps)
    out["plain_ms"] = cuda_ms(torch, plain, plain_reps)
    out["library_ms"] = cuda_ms(torch, lib, plain_reps)
    nv, mv = int(qm.sum()), int(rm.sum())
    out["bound_ms"], out["bound_by"] = bound_ms(name, nv, mv, n, m, k)
    return out



# ------------------------------------------------------- survivor kernels
def bound_of(ops, nbytes):
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def survivor_work(torch, qp, surv, ct, nch):
    """Pairs a sweep must visit: per tile of ``surv`` (256 or 1024 queries a
    row), its valid queries times the valid rows of its surviving chunks."""
    tile = qp.shape[0] // surv.shape[0]
    valid_q = (qp[:, 3] == 0).reshape(-1, tile).sum(dim=1).double()
    rows = surv[:, :nch].double() @ ct[6, :nch].double()
    return float((valid_q * rows).sum())


def list_stats(torch, qp, surv, ct, nch):
    """Survivor-list lengths (chunks per tile: mean, 99th percentile and
    maximum over the tiles that have a list; the tiles without) and the
    pairs swept, at K2's own 256-query tiles and at the 1024-query fold."""
    out = {}
    for fold, flags in (("256", surv),
                        ("1024", surv.reshape(-1, 4, surv.shape[1]).amax(dim=1))):
        lens = flags[:, :nch].sum(dim=1).double()
        kept = lens[lens > 0]
        out[fold] = {
            "tiles": int(lens.numel()), "empty": int((lens == 0).sum()),
            "mean": float(kept.mean()) if kept.numel() else 0.0,
            "p99": float(torch.quantile(kept, 0.99)) if kept.numel() else 0.0,
            "max": int(lens.max()) if lens.numel() else 0,
            "pairs": survivor_work(torch, qp, flags, ct, nch)}
    out["pairs_256_over_1024"] = (out["256"]["pairs"] / out["1024"]["pairs"]
                                  if out["1024"]["pairs"] else None)
    return out


def check_survivor_step(torch, sc, sweep, kc, qs, qm, ub_t, tab, label):
    """K2, K3 and K4 against their plain versions and K1 on one query
    batch, K3 and K4 at K2's own flags and at the 1024-query fold → the
    route's d2."""
    rt3, ct, ref_s, refm_s, rorder, ref, refm = tab
    nch = rt3.shape[0]
    qp = sweep.query_table(qs, qm, ub_t)
    ub, surv = sc.survivors_and_bounds(qp, ct, nch=nch)
    ubp, survp = sc.survivors_and_bounds_plain(qp, ct, nch=nch)
    # the whole table, padding chunks included, gives the same
    ubf, survf = sc.survivors_and_bounds(qp, ct)
    torch.cuda.synchronize()
    if not (torch.equal(ub, ubp) and torch.equal(surv, survp)):
        raise AssertionError(f"{label}: K2 differs from its plain version")
    if not (torch.equal(ub, ubf) and torch.equal(surv, survf)):
        raise AssertionError(f"{label}: K2 over the padding chunks differs")
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    swept = {}
    for fold, flags in (("256", surv), ("1024", surv4)):
        d3, i3 = sc.nn1_survivor_sweep(qp, rt3, flags)
        d4, i4 = sc.nn1_survivor_sweep_stream(qp, rt3, flags)
        dp, ip = sc.survivor_sweep_plain(qp, rt3, flags)
        torch.cuda.synchronize()
        if not (torch.equal(d3, dp) and torch.equal(i3, ip)):
            raise AssertionError(f"{label}: K3 differs from its plain version "
                                 f"at {fold}-query flags")
        if not (torch.equal(d4, d3) and torch.equal(i4, i3)):
            raise AssertionError(f"{label}: K4 differs from K3 at {fold}-query "
                                 f"flags")
        swept[fold] = d3, i3
    # valid queries (the rows the step keeps) get the same at both folds
    qv = qp[:, 3] == 0
    if not (torch.equal(swept["256"][0][qv], swept["1024"][0][qv])
            and torch.equal(swept["256"][1][qv], swept["1024"][1][qv])):
        raise AssertionError(f"{label}: the sweep at 256-query flags differs "
                             f"from the 1024-query fold")
    # the true neighbour's chunk survives for every valid query
    d1, i1 = kc.knn1(qp[:, :3].contiguous(), qv, ref_s, refm_s)
    row = torch.arange(qp.shape[0], device=qp.device)
    kept = surv[row // 256, i1.clamp(min=0).long() // 128] == 1
    if not bool(kept[qv & (i1 >= 0)].all()):
        raise AssertionError(f"{label}: a true neighbour's chunk was dropped")
    # the whole route against K1 on the map in its own order
    d2, ids, frac = sweep.nn1_sorted_v2(qs, qm, ub_t, rt3, ct,
                                        stream=label.startswith("K4"))
    flat_q, flat_m = qs.reshape(-1, 3), qm.reshape(-1)
    e1, j1 = kc.knn1(flat_q, flat_m, ref, refm)
    if not torch.equal(d2.reshape(-1), e1):
        raise AssertionError(f"{label}: survivor-route d2 differs from K1's")
    e2, _ = kc.knnk(flat_q, flat_m, ref, refm, 2)
    unique = flat_m & torch.isfinite(e1) & (e2[:, 1] > e1)
    mapped = rorder[ids.reshape(-1).clamp(min=0).long()].to(torch.int32)
    if not torch.equal(mapped[unique], j1[unique]):
        raise AssertionError(f"{label}: survivor-route ids differ from K1's")
    log(f"[survivor] {label}: {qp.shape[0]} query rows x {rt3.shape[0]} "
        f"chunks, survivor share {float(frac.mean()):.4f}, "
        f"{int(unique.sum())} unique neighbours compared; K2/K3/K4 equal at "
        f"both flag folds; lists {json.dumps(list_stats(torch, qp, surv, ct, nch))}")
    return d2


def survivor_tables(torch, morton, sweep, internal):
    """The sorted map and its tables, as KDTreeMatcher builds them."""
    pts, mask = internal.host_rows()
    rorder, _ = morton.morton_argsort(pts, mask)
    t = lambda a: torch.as_tensor(a, device="cuda")
    return (t(sweep.chunked_ref_table(pts[rorder], mask[rorder])),
            t(sweep.chunk_summaries(pts[rorder], mask[rorder])),
            t(pts[rorder]), t(mask[rorder]), t(rorder.astype(np.int64)),
            internal.points, internal.mask)


def record_survivor_kernels(torch, sc, sweep, qs, qm, ub_t, tab, names,
                            launches, label):
    """Time the named survivor kernels on one serving iteration's inputs →
    kernel records for the JSON line. Both sweeps, K3 and K4, are timed on
    these inputs at K2's own flags (the route's), each also at the
    1024-query fold and with only the longest list kept; only the named ones
    are recorded. The sweeps' bound counts the pairs the route sweeps, those
    of its 256-query tiles; the bound over the pairs of the 1024-query fold
    (the yardstick of the sweeps before they took K2's own tiles) is logged
    beside it."""
    rt3, ct, ref_s, refm_s = tab[:4]
    nch = rt3.shape[0]
    qp = sweep.query_table(qs, qm, ub_t)
    _, surv = sc.survivors_and_bounds(qp, ct, nch=nch)
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    stats = list_stats(torch, qp, surv, ct, nch)
    sweeps = {"K3 nn1_survivor_sweep": sc.nn1_survivor_sweep,
              "K4 nn1_survivor_sweep_stream": sc.nn1_survivor_sweep_stream}
    out = []
    for name in [n for n in names if n.startswith("K2")] + list(sweeps):
        extra = ""
        if name.startswith("K2"):
            run = lambda: sc.survivors_and_bounds(qp, ct, nch=nch)
            plain = lambda: sc.survivors_and_bounds_plain(qp, ct, nch=nch)
            lib = None
            # every query row's bound over the map's chunks (the padding
            # chunks are not visited); the flags of every column written
            n_pad, nch_pad = qp.shape[0], ct.shape[1]
            ops = KERNELS[name][1] * n_pad * nch
            nbytes = 36 * n_pad + 32 * nch + 4 * (n_pad // 256) * nch_pad
        else:
            fn = sweeps[name]
            run = lambda: fn(qp, rt3, surv)
            plain = lambda: sc.survivor_sweep_plain(qp, rt3, surv)
            # no one PyTorch call takes the batch: cdist's CUDA grid refuses
            # 8 x 20480 x 50147 outputs (batched or not). The yardstick is
            # one cdist call per scan, reported beside the record.
            rv = ref_s[refm_s]
            lib = lambda: [torch.cdist(
                q, rv, compute_mode="donot_use_mm_for_euclid_dist").min(dim=1)
                for q in qs]
            ops = KERNELS[name][1] * stats["256"]["pairs"]
            nbytes = (40 * qp.shape[0] + 4096 * nch
                      + 4 * surv.shape[0] * surv.shape[1])
            b1024, _ = bound_of(KERNELS[name][1] * stats["1024"]["pairs"],
                                nbytes)
            ms_fold = cuda_ms(torch, lambda: fn(qp, rt3, surv4), 20)
            longest = torch.zeros_like(surv)
            top = int(surv[:, :nch].sum(dim=1).argmax())
            longest[top] = surv[top]
            ms_longest = cuda_ms(torch, lambda: fn(qp, rt3, longest), 20)
            extra = (f", {stats['256']['pairs']:.6g} pairs at the 256-query "
                     f"tiles against {stats['1024']['pairs']:.6g} at the "
                     f"1024-query fold (bound over those {b1024:.5f} ms); at "
                     f"the fold {ms_fold:.4f} ms; the longest list "
                     f"({int(surv[top, :nch].sum())} chunks) alone "
                     f"{ms_longest:.4f} ms")
        d, i = run()
        dp, ip = plain()
        torch.cuda.synchronize()
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"{name}: kernel and plain version differ")
        ms = cuda_ms(torch, run, 20)
        if name not in names:
            log(f"[kernel] {name} at the {label} route's inputs ({qp.shape[0]} "
                f"query rows x {nch} chunks): {ms:.4f} ms{extra}")
            continue
        fin = torch.isfinite(dp)
        err = float((d[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0
        plain_ms = cuda_ms(torch, plain, 2)
        yard = ""
        if lib is not None:
            torch.cuda.empty_cache()
            yard = (f", cdist one call per scan x{qs.shape[0]}: "
                    f"{cuda_ms(torch, lib, 1):.2f} ms")
        bms, by = bound_of(ops, nbytes)
        rec = {"name": name, "route": "cuda",
               "source": "libpointmatcher_tpu_torch/csrc/sweep.cu",
               "replaces": KERNELS[name][0], "launches": launches[name],
               "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bms, "bound_by": by, "library_ms": None}
        log(f"[kernel] main path {name} {qp.shape[0]} query rows x {nch} "
            f"chunks{yard}{extra}: " + json.dumps(rec))
        out.append(rec)
    log(f"[kernel] {label} route's recorded inputs: lists {json.dumps(stats)}")
    return out


class InputRecorder:
    """Keeps copies of the positional arguments of the first ``keep`` calls
    (all with None) that a serving run makes to ``module.name``: the
    matcher's survivor step (``ops.sweep.nn1_sorted_v2``, or
    ``nnk_sorted_v2`` for knn > 1, once per iteration) or its dense search
    (``matchers.knn_search``, K1)."""

    def __init__(self, module, name="nn1_sorted_v2", keep=None):
        self.module = module
        self.name = name
        self.keep = keep
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __call__(self, *a, **k):
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append(tuple(x.clone() if hasattr(x, "clone") else x
                                    for x in a))
        return self.orig(*a, **k)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class PrepTimer:
    """Host time of the serving batch's prep calls (``batch._prep_scans``)
    while the context is open, summed in ``ms``."""

    def __init__(self, module):
        self.module = module
        self.ms = 0.0

    def __enter__(self):
        self.orig = self.module._prep_scans

        def timed(*a, **k):
            t = time.perf_counter()
            out = self.orig(*a, **k)
            self.ms += 1e3 * (time.perf_counter() - t)
            return out

        self.module._prep_scans = timed
        return self

    def __exit__(self, *exc):
        self.module._prep_scans = self.orig


# ------------------------------------------------------------ slice 3
def serving_queries(torch, morton, cell, stride=11):
    """The cell's scans placed at their true poses in the map frame, each
    in its Morton order, every ``stride``-th row masked, cut to a common
    length → (qs [B, n, 3], qm [B, n])."""
    trm = cell["seq"].trm_host()
    qs, qm = [], []
    for scan, P in zip(cell["scans"], cell["poses"]):
        T = np.linalg.inv(trm) @ P
        q = torch.as_tensor((scan @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
                            device="cuda")
        m = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
        m[::stride] = False
        o = morton.morton_argsort_device(q, m)
        qs.append(q[o])
        qm.append(m[o])
    n = min(x.shape[0] for x in qs)
    return torch.stack([x[:n] for x in qs]), torch.stack([x[:n] for x in qm])


def check_topk_step(torch, sc, sweep, kc, qs, qm, ub_t, tab, k, label):
    """K6 against its plain version, and the top-k survivor route against
    K5 on the map in its own order, on one query batch → the route's d²."""
    rt3, ct, _, _, rorder, ref, refm = tab
    nch = rt3.shape[0]
    qp = sweep.query_table(qs, qm, ub_t)
    _, surv = sc.survivors_and_bounds(qp, ct, k, nch=nch)
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    d6, i6 = sc.nnk_survivor_sweep(qp, rt3, surv4, k)
    dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv4, k)
    torch.cuda.synchronize()
    if not (torch.equal(d6, dp) and torch.equal(i6, ip)):
        raise AssertionError(f"{label}: K6 differs from its plain version")
    dk, ik, frac = sweep.nnk_sorted_v2(qs, qm, ub_t, rt3, ct, k)
    flat_q, flat_m = qs.reshape(-1, 3), qm.reshape(-1)
    e, j = kc.knnk(flat_q, flat_m, ref, refm, k + 1)
    if not torch.equal(dk.reshape(-1, k), e[:, :k]):
        raise AssertionError(f"{label}: top-k route d2 differs from K5's")
    below = torch.cat([torch.full_like(e[:, :1], -1.0), e[:, :k - 1]], dim=1)
    unique = (torch.isfinite(e[:, :k]) & (e[:, :k] > below)
              & (e[:, 1:] > e[:, :k]))
    mapped = rorder[ik.reshape(-1, k).clamp(min=0).long()].to(torch.int32)
    if not torch.equal(mapped[unique], j[:, :k][unique]):
        raise AssertionError(f"{label}: top-k route ids differ from K5's")
    log(f"[survivor] {label}: {qp.shape[0]} query rows x {nch} chunks, "
        f"survivor share {float(frac.mean()):.4f}, {int(unique.sum())} unique "
        f"neighbours compared; K6 equals its plain version and K5")
    return dk


def record_topk_kernel(torch, sc, sweep, qs, qm, ub_t, tab, k, launches):
    """Time K6 at one serving iteration's inputs → its kernel record."""
    rt3, ct, ref_s, refm_s = tab[:4]
    nch = rt3.shape[0]
    name = "K6 nnk_survivor_sweep"
    qp = sweep.query_table(qs, qm, ub_t)
    _, surv = sc.survivors_and_bounds(qp, ct, k, nch=nch)
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    run = lambda: sc.nnk_survivor_sweep(qp, rt3, surv4, k)
    plain = lambda: sc.nnk_survivor_sweep_plain(qp, rt3, surv4, k)
    d, i = run()
    dp, ip = plain()
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        raise AssertionError(f"{name}: kernel and plain version differ")
    ms = cuda_ms(torch, run, 20)
    plain_ms = cuda_ms(torch, plain, 2)
    # the yardstick: one cdist + topk call per lane over its valid queries
    # (no one call takes the batch, as for K3)
    rv = ref_s[refm_s]
    lib = lambda: [torch.cdist(q[m], rv, compute_mode="donot_use_mm_for_euclid_dist")
                   .topk(k, dim=1, largest=False) for q, m in zip(qs, qm)]
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(torch, lib, 1)
    ops = KERNELS[name][1] * survivor_work(torch, qp, surv4, ct, nch)
    nbytes = (32 + 8 * k) * qp.shape[0] + 4096 * nch + 4 * surv4.numel()
    bms, by = bound_of(ops, nbytes)
    fin = torch.isfinite(dp)
    rec = {"name": name, "route": "cuda",
           "source": "libpointmatcher_tpu_torch/csrc/sweep.cu",
           "replaces": KERNELS[name][0], "launches": launches,
           "max_abs_err": float((d[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": None}
    log(f"[kernel] main path {name} k={k} {qp.shape[0]} query rows x {nch} "
        f"chunks, cdist+topk one call per lane x{qs.shape[0]}: {lib_ms:.2f} ms: "
        + json.dumps(rec))
    return rec


def check_k1_call(torch, kc, q, qm, r, rm, label):
    """One K1 call against its plain version and, with a pair axis
    (``r`` [B, M, 3]), against one launch per pair, bit for bit."""
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    d, i = kc.knn1(q, qm, r, rm)
    dp, ip = knn_brute_force(q, qm, r, rm, k=1)
    torch.cuda.synchronize()
    if not (torch.equal(d, dp[..., 0]) and torch.equal(i, ip[..., 0])):
        raise AssertionError(f"{label}: K1 differs from its plain version")
    if r.ndim == 3:
        singles = [kc.knn1(q[b], qm[b], r[b], rm[b]) for b in range(r.shape[0])]
        if not (torch.equal(d, torch.stack([x[0] for x in singles]))
                and torch.equal(i, torch.stack([x[1] for x in singles]))):
            raise AssertionError(f"{label}: K1 pair axis differs from single "
                                 f"launches")
    log(f"[kernel] {label}: K1 at {tuple(q.shape)} queries ({int(qm.sum())} "
        f"valid) x {tuple(r.shape)} references ({rm.sum(dim=-1).tolist()} "
        f"valid) equals its plain version"
        + (" and single launches" if r.ndim == 3 else ""))


def check_pair_axis(torch, kc, scans):
    """K1 over PAIRS pairs in one launch against single launches and the
    plain version (scan i+1 against scan i, sensor frames, masks of their
    own)."""
    n = min(len(x) for x in scans[:PAIRS + 1])
    t = lambda a: torch.as_tensor(np.stack(a), device="cuda")
    q = t([scans[i + 1][:n] for i in range(PAIRS)])
    r = t([scans[i][:n] for i in range(PAIRS)])
    qm = torch.ones(q.shape[:2], dtype=torch.bool, device="cuda")
    rm = torch.ones(r.shape[:2], dtype=torch.bool, device="cuda")
    qm[:, ::11] = False
    rm[:, 3::7] = False
    check_k1_call(torch, kc, q, qm, r, rm, "K1 pair axis, raw scans")
    ms = cuda_ms(torch, lambda: kc.knn1(q, qm, r, rm), 20)
    ms1 = cuda_ms(torch, lambda: [kc.knn1(q[b], qm[b], r[b], rm[b])
                                  for b in range(PAIRS)], 20)
    log(f"[kernel] K1 pair axis {PAIRS} x {n} x {n}: {ms:.4f} ms in one "
        f"launch, {ms1:.4f} ms in {PAIRS}")


def run_queue(torch, register_queue_to_map, seq, cell, coarse,
              launches, label):
    """One queue through the port's entry point, its launches counted from
    0 and its lane iterations (calls of the engine's step) counted →
    (T, info, launches, lane iterations, recorded). With ``coarse``,
    ``recorded`` holds the inputs of the first two matcher calls, which
    belong to the coarse pass (it runs first), by callee name."""
    from contextlib import ExitStack

    from libpointmatcher_tpu_torch import matchers
    from libpointmatcher_tpu_torch.ops import sweep

    steps = [0]
    step = seq._step

    def counted(*a, **k):
        steps[0] += 1
        return step(*a, **k)

    seq._step = counted
    try:
        with ExitStack() as stack:
            recs = [stack.enter_context(InputRecorder(mod, name, keep=2))
                    for mod, name in ((sweep, "nn1_sorted_v2"),
                                      (sweep, "nnk_sorted_v2"),
                                      (matchers, "knn_search"))] if coarse else []
            reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            T, info = register_queue_to_map(seq, cell["qclouds"],
                                            T_inits=cell["qinits"], seed=1,
                                            lanes=QUEUE_LANES, coarse=coarse)
            sec = time.perf_counter() - t
            counts = launches()
    finally:
        del seq._step
    recorded = {r.name: r.calls for r in recs if r.calls}
    errs = [pose_error(Ti, P) for Ti, P in zip(T, cell["qposes"])]
    log(f"[queue] {label}{' c2f' if coarse else ''}: {len(T)} scans, "
        f"{QUEUE_LANES} lanes, {steps[0]} lane iterations, {sec * 1e3:.1f} ms, "
        f"{len(T) / sec:.2f} registrations/s, fine iterations "
        f"{info['iterations'].tolist()}, codes {sorted(set(info['codes'].tolist()))}, "
        f"worst rot err {max(a for a, _ in errs):.5f} rad, worst trans err "
        f"{max(b for _, b in errs):.5f} m, launches {counts}")
    for i, ((a, b), Ti) in enumerate(zip(errs, T)):
        if not (np.isfinite(Ti).all() and a < ROT_TOL and b < TRANS_TOL):
            raise AssertionError(f"{label} queue scan {i}: pose error {a}, {b}")
    return T, info, counts, steps[0], recorded


def check_coarse_pass(torch, kc, sc, sweep, recorded, tab, route):
    """The coarse pass's first two matcher calls (cold, then with the
    transported bound), recorded in a c2f queue run, through the route's
    kernels against their plain versions: K2 and K3/K4 (and K1 on the same
    queries) on the K4 and K3 routes, K6 on the K6 route, K1 on the dense
    one."""
    name = {"K1": "knn_search", "K6": "nnk_sorted_v2"}.get(route, "nn1_sorted_v2")
    calls = recorded.get(name, [])
    if len(calls) != 2 or len(recorded) != 1:
        seen = {k: len(v) for k, v in recorded.items()}
        raise AssertionError(f"{route} c2f: recorded {seen}, expected 2 calls "
                             f"of {name}")
    for it, call in enumerate(calls):
        label = f"{route} c2f coarse pass, iteration {it}"
        if route == "K1":
            check_k1_call(torch, kc, *call[:4], label)
        elif route == "K6":
            check_topk_step(torch, sc, sweep, kc, *call[:3], tab, 3, label)
        else:
            check_survivor_step(torch, sc, sweep, kc, *call[:3], tab, label)


# ------------------------------------------------------------ slice 4
TERRAIN_MAPS = (100_000, 400_000)
TERRAIN_DENSITY = 120.0   # points per m² of terrain footprint
TERRAIN_RADIUS = 7.0      # m, the ball around each scan centre
TERRAIN_NOISE = 0.02      # m of sensor noise on scans
TILE_QUEUE_REPEAT = 3     # the queue holds the 8 scans this many times
TILE_MATCHER = {"maxDist": "0.5", "motionBound": "1.0", "tileQueries": "64",
                "blockCap": "1024"}


def make_terrain(n, rng):
    """tools/large_reg_bench.py::make_map: terrain at constant density."""
    side = float(np.sqrt(n / TERRAIN_DENSITY))
    xy = rng.uniform(0, side, (n, 2))
    z = 0.4 * np.sin(xy[:, 0]) * np.cos(xy[:, 1] * 0.7) \
        + 0.05 * rng.standard_normal(n)
    return np.concatenate([xy, z[:, None]], 1).astype(np.float32), side


def small_pose(rng, center, max_deg=2.0, max_trans=0.3):
    """tools/large_reg_bench.py::small_pose: a rotation about the scan's
    own centre and a small translation."""
    ang = np.deg2rad(rng.uniform(-max_deg, max_deg, 3))
    ca, sa = np.cos(ang), np.sin(ang)
    Rx = np.array([[1, 0, 0], [0, ca[0], -sa[0]], [0, sa[0], ca[0]]])
    Ry = np.array([[ca[1], 0, sa[1]], [0, 1, 0], [-sa[1], 0, ca[1]]])
    Rz = np.array([[ca[2], -sa[2], 0], [sa[2], ca[2], 0], [0, 0, 1]])
    T = np.eye(4)
    T[:3, :3] = Rz @ Ry @ Rx
    c = np.array([center[0], center[1], 0.0])
    T[:3, 3] = c - T[:3, :3] @ c + rng.uniform(-max_trans, max_trans, 3)
    return T


def make_terrain_scans(map_pts, side, rng, count=SERVE_BATCH):
    """tools/large_reg_bench.py::make_scans: balls of the map plus noise,
    moved off the map frame by the inverse of their pose → (scans, poses)."""
    scans, poses = [], []
    for _ in range(count):
        c = rng.uniform(TERRAIN_RADIUS, side - TERRAIN_RADIUS, 2)
        sel = np.linalg.norm(map_pts[:, :2] - c[None, :], axis=1) < TERRAIN_RADIUS
        pts = map_pts[sel] + TERRAIN_NOISE * rng.standard_normal(
            (int(sel.sum()), 3)).astype(np.float32)
        T = small_pose(rng, c)
        Ti = np.linalg.inv(T)
        scans.append(pts @ Ti[:3, :3].T.astype(np.float32)
                     + Ti[:3, 3].astype(np.float32))
        poses.append(T)
    return scans, poses


def terrain_sequence(pt):
    """tools/large_reg_bench.py::build_seq with the tile matcher."""
    from libpointmatcher_tpu_torch.checkers import (
        CounterTransformationChecker, DifferentialTransformationChecker)
    from libpointmatcher_tpu_torch.filters import (
        RandomSamplingDataPointsFilter, SurfaceNormalDataPointsFilter)
    from libpointmatcher_tpu_torch.matchers import BlockGridMatcher
    from libpointmatcher_tpu_torch.minimizers import PointToPlaneErrorMinimizer
    from libpointmatcher_tpu_torch.outlierfilters import TrimmedDistOutlierFilter

    seq = pt.ICPSequence()
    seq.set_default()
    seq.reading_filters = [RandomSamplingDataPointsFilter({"prob": "0.75"})]
    seq.reference_filters = [SurfaceNormalDataPointsFilter({"knn": "10"})]
    seq.matcher = BlockGridMatcher(TILE_MATCHER)
    seq.outlier_filters = [TrimmedDistOutlierFilter({"ratio": "0.85"})]
    seq.error_minimizer = PointToPlaneErrorMinimizer()
    seq.checkers = [CounterTransformationChecker({"maxIterationCount": "40"}),
                    DifferentialTransformationChecker()]
    return seq


def record_tile_kernel(torch, tc, name, q, cand_t, dim, k, qvalid, launches):
    """K7 (``k`` None) or K8 at recorded main-path inputs against its plain
    version, timed beside it and a batched ``torch.cdist`` yardstick over
    the same tiles → its kernel record. ``qvalid`` holds each tile's valid
    queries. The bound counts what the function needs: its operations on
    the valid (query, candidate) pairs, and its bytes, each valid query's
    ``dim`` coordinates, the ``dim`` + 2 rows (coordinates, pen, id) of
    each valid candidate column of a tile that has a valid query, and the
    valid queries' outputs (a distance and an id each)."""
    if k is None:
        run = lambda: tc.tile_sweep(q, cand_t, dim)
        plain = lambda: tc.tile_sweep_plain(q, cand_t, dim)
    else:
        run = lambda: tc.tile_sweep_k(q, cand_t, dim, k)
        plain = lambda: tc.tile_sweep_k_plain(q, cand_t, dim, k)
    d, i = run()
    dp, ip = plain()
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        raise AssertionError(f"{name}: kernel and plain version differ")
    ms = cuda_ms(torch, run, 20)
    plain_ms = cuda_ms(torch, plain, 2)
    pen = cand_t[:, 6]
    qq = q[..., :dim].contiguous()
    cc = cand_t[:, :dim].transpose(1, 2).contiguous()

    def lib():
        dist = torch.cdist(qq, cc, compute_mode="donot_use_mm_for_euclid_dist")
        d2 = dist * dist + pen[:, None, :]
        return d2.min(dim=2) if k is None else d2.topk(k, dim=2, largest=False)

    torch.cuda.empty_cache()
    try:
        library_ms = cuda_ms(torch, lib, 2)
    except RuntimeError as e:          # a batch cdist's grid may refuse it
        log(f"[kernel] {name}: batched cdist refused: {e}")
        library_ms = None
    torch.cuda.empty_cache()
    ncand = (pen == 0).sum(dim=1).double()
    pairs = float((qvalid.double() * ncand).sum())
    nq = float(qvalid.sum())
    ncols = float((ncand * (qvalid > 0)).sum())
    nbytes = 4 * dim * nq + 4 * (dim + 2) * ncols + 8 * (k or 1) * nq
    bms, by = bound_of(KERNELS[name][1] * pairs, nbytes)
    fin = torch.isfinite(dp)
    rec = {"name": name, "route": "cuda",
           "source": "libpointmatcher_tpu_torch/csrc/tile.cu",
           "replaces": KERNELS[name][0], "launches": launches,
           "max_abs_err": float((d[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": library_ms}
    log(f"[kernel] main path {name}{'' if k is None else f' k={k}'} "
        f"{q.shape[0]} tiles x {q.shape[1]} queries x {cand_t.shape[2]} "
        f"candidates, {pairs:.0f} valid pairs, {nq:.0f} valid queries, "
        f"{ncols:.0f} valid candidate columns, {nbytes:.0f} bytes: "
        + json.dumps(rec))
    return rec


def check_tile_step(torch, kc, call, ref, label):
    """The recorded tile step (reading in tile order) against dense K1 on
    the same queries: equal d² wherever K1's neighbour lies within maxDist,
    equal ids where it is unique, +inf beyond."""
    from libpointmatcher_tpu_torch.ops import tilesweep

    pts, qmask, _, _, max_dist = call[:5]
    d, i = tilesweep.tile_nn1_from_candidates(*call)
    flat, fm = pts.reshape(-1, 3), qmask.reshape(-1)
    d1, i1 = kc.knn1(flat, fm, ref.points, ref.mask)
    d2, _ = kc.knnk(flat, fm, ref.points, ref.mask, 2)
    torch.cuda.synchronize()
    d, i = d.reshape(-1), i.reshape(-1)
    inside = fm & (d1 <= float(np.float32(max_dist) * np.float32(max_dist)))
    unique = inside & (d2[:, 1] > d1)
    if not (torch.equal(torch.isfinite(d), inside)
            and torch.equal(d[inside], d1[inside])
            and torch.equal(i[unique], i1[unique])):
        raise AssertionError(f"{label}: the tile step differs from dense K1 "
                             f"within maxDist")
    log(f"[tile] {label}: {int(fm.sum())} valid queries, {int(inside.sum())} "
        f"neighbours within maxDist, {int(unique.sum())} unique: equal to dense K1")


def tile_serving(torch, pt, kc, sc, tc, launches):
    """Phases 13-16 → (the K7 and K8 kernel records, K7's recorded inputs
    ``(q, cand_t, dim, valid queries per tile)``)."""
    from contextlib import ExitStack

    from libpointmatcher_tpu_torch import matchers
    from libpointmatcher_tpu_torch.ops import knn_self, tilesweep
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    def all_launches():
        return dict(launches(), K7=tc.tile_sweep.launches,
                    K8=tc.tile_sweep_k.launches)

    def reset():
        reset_launch_counts()
        torch.cuda.synchronize()

    def gates(T, poses, info, label):
        errs = [pose_error(Ti, P) for Ti, P in zip(T, poses)]
        worst = (max(a for a, _ in errs), max(b for _, b in errs))
        for j, ((a, b), Ti) in enumerate(zip(errs, T)):
            if not (np.isfinite(Ti).all() and a < ROT_TOL and b < TRANS_TOL):
                raise AssertionError(f"{label} scan {j}: pose error {a}, {b}")
        if info["motion_bound_exceeded"].any():
            raise AssertionError(f"{label}: motion bound exceeded on scans "
                                 f"{np.flatnonzero(info['motion_bound_exceeded'])}")
        return worst

    records = []
    for n_map in TERRAIN_MAPS:
        rng = np.random.default_rng(7)
        map_pts, side = make_terrain(n_map, rng)
        scans, poses = make_terrain_scans(map_pts, side, rng)
        clouds = [pt.PointCloud.from_numpy(s) for s in scans]
        seq = terrain_sequence(pt)
        main = n_map == TERRAIN_MAPS[0]
        # ---- 13. set_map: SurfaceNormal through the culled self-search (K8)
        with ExitStack() as stack:
            rk = stack.enter_context(InputRecorder(tilesweep, "tile_sweep_k", keep=1))
            rs = stack.enter_context(InputRecorder(knn_self,
                                                   "tile_knnk_from_candidates",
                                                   keep=1))
            reset()
            t = time.perf_counter()
            seq.set_map(pt.PointCloud.from_numpy(map_pts), seed=0)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            counts = all_launches()
        log(f"[tile] set_map of the {n_map}-point terrain map: {sec:.3f} s, "
            f"launches {counts}")
        if counts["K8"] != 1 or counts["K7"] != 0:
            raise AssertionError(f"set_map made {counts['K8']} K8 and "
                                 f"{counts['K7']} K7 launches, expected 1 and 0")
        internal = seq.get_prefiltered_internal_map()
        if main:
            pts_c, mask_c, q_rows, _, _, parent = rs.calls[0][:6]
            k = rs.calls[0][7]
            dk, ik = knn_self.knn_self_culled(pts_c, mask_c, k)
            de, ie = kc.knnk(pts_c, mask_c, pts_c, mask_c, k)
            dnext, _ = kc.knnk(pts_c, mask_c, pts_c, mask_c, k + 1)
            torch.cuda.synchronize()
            below = torch.cat([torch.full_like(de[:, :1], -1.0), de[:, :k - 1]], 1)
            unique = torch.isfinite(de) & (de > below) & (dnext[:, 1:] > de)
            if not (torch.equal(dk, de) and torch.equal(ik[unique], ie[unique])):
                raise AssertionError("the culled self-search differs from dense K5")
            log(f"[tile] culled self-search of {int(mask_c.sum())} points, "
                f"k={k}: equal to dense K5 ({int(unique.sum())} unique neighbours)")
            live = (q_rows >= 0) & mask_c[q_rows.clamp(min=0).long()]
            qvalid = live.sum(dim=1)[parent.long()]
            k8_launches = counts["K8"]
            k8_inputs = rk.calls[0], qvalid
        del rk, rs
        # ---- 14. / 16. the batch of 8 scans
        register_batch_to_map(seq, clouds, seed=1)      # warm-up
        with ExitStack() as stack:
            r7 = stack.enter_context(InputRecorder(tilesweep, "tile_sweep", keep=2))
            rstep = stack.enter_context(InputRecorder(
                matchers, "tile_nn1_from_candidates", keep=2))
            reset()
            t = time.perf_counter()
            T, info = register_batch_to_map(seq, clouds, seed=1)
            sec = time.perf_counter() - t
            counts = all_launches()
        it = int(info["iterations"].max())
        worst = gates(T, poses, info, f"tile batch, {n_map}-point map")
        log(f"[tile] batch of {len(clouds)} scans ({[c.num_points for c in clouds]} "
            f"points) on the {n_map}-point map: {1e3 * sec:.2f} ms, "
            f"{len(clouds) / sec:.2f} registrations/s, iterations "
            f"{info['iterations'].tolist()}, codes {info['codes'].tolist()}, worst "
            f"rot err {worst[0]:.5f} rad, trans err {worst[1]:.5f} m, launches {counts}")
        want = {name: 0 for name in counts}
        want["K7"] = it
        if counts != want:
            raise AssertionError(f"tile batch launches {counts}, expected {want}")
        if main:
            check_tile_step(torch, kc, rstep.calls[1], internal,
                            "tile batch, second lockstep iteration")
            q7, cand7, dim7 = r7.calls[1][:3]
            qmask7, parent7 = rstep.calls[1][1], rstep.calls[1][5]
            qvalid7 = qmask7.reshape(*parent7.shape[:-1], -1, q7.shape[1]).sum(dim=-1)
            qvalid7 = torch.gather(qvalid7, -1, parent7.long()).reshape(-1)
            k7_launches = counts["K7"]
            batch_info = info
        del r7, rstep
        torch.cuda.empty_cache()
        if not main:
            continue
        # ---- 15. the queue of 24 scans through 8 lanes
        steps = [0]
        step = seq._step

        def counted(*a, **kw):
            steps[0] += 1
            return step(*a, **kw)

        seq._step = counted
        try:
            qclouds = clouds * TILE_QUEUE_REPEAT
            register_queue_to_map(seq, qclouds, seed=1, lanes=QUEUE_LANES)  # warm-up
            steps[0] = 0
            reset()
            t = time.perf_counter()
            Tq, iq = register_queue_to_map(seq, qclouds, seed=1, lanes=QUEUE_LANES)
            sec = time.perf_counter() - t
            counts = all_launches()
        finally:
            del seq._step
        worst = gates(Tq, poses * TILE_QUEUE_REPEAT, iq,
                      f"tile queue, {n_map}-point map")
        log(f"[tile] queue of {len(qclouds)} scans through {QUEUE_LANES} lanes "
            f"on the {n_map}-point map: {1e3 * sec:.2f} ms, "
            f"{len(qclouds) / sec:.2f} registrations/s, {steps[0]} lane "
            f"iterations, iterations {iq['iterations'].tolist()}, worst rot err "
            f"{worst[0]:.5f} rad, trans err {worst[1]:.5f} m, launches {counts}")
        want = {name: 0 for name in counts}
        want["K7"] = steps[0]
        if counts != want:
            raise AssertionError(f"tile queue launches {counts}, expected {want}")
        for key in ("iterations", "codes"):
            if not np.array_equal(iq[key][:SERVE_BATCH], batch_info[key]):
                raise AssertionError(f"tile queue {key} {iq[key][:SERVE_BATCH]} "
                                     f"differ from the batch's {batch_info[key]}")
        del seq, internal, clouds
        torch.cuda.empty_cache()
    # ---- the kernels at their recorded inputs, for the record
    records.append(record_tile_kernel(torch, tc, "K7 tile_sweep", q7, cand7, dim7,
                                      None, qvalid7, k7_launches))
    (q8, cand8, dim8, k8), qvalid8 = k8_inputs[0][:4], k8_inputs[1]
    records.append(record_tile_kernel(torch, tc, "K8 tile_sweep_k", q8, cand8,
                                      dim8, k8, qvalid8, k8_launches))
    return records, (q7, cand7, dim7, qvalid7)


# ------------------------------------------------------------ slice 5
V1_KEYS = ("PMTPU_SKIP_V1", "PMTPU_SKIP_MXU_BOUND", "PMTPU_SKIP_HOST_MORTON")
V1_RUNS = {"v1": ("PMTPU_SKIP_V1",),
           "v1 + bound": ("PMTPU_SKIP_V1", "PMTPU_SKIP_MXU_BOUND"),
           "v1 + host order": ("PMTPU_SKIP_V1", "PMTPU_SKIP_HOST_MORTON")}
EPS = float(np.float32(1.1920929e-07))     # ops/skip.py's eps
HEADROOM = 8.0


def set_switches(on) -> None:
    """Each of V1_KEYS to "1" where named in ``on``, else to "0"."""
    for key in V1_KEYS:
        os.environ[key] = "1" if key in on else "0"


def gates(T, poses, label):
    """Every pose within ROT_TOL / TRANS_TOL of its truth → worst errors."""
    errs = [pose_error(Ti, P) for Ti, P in zip(T, poses)]
    for j, ((a, b), Ti) in enumerate(zip(errs, T)):
        if not (np.isfinite(Ti).all() and a < ROT_TOL and b < TRANS_TOL):
            raise AssertionError(f"{label} scan {j}: pose error {a}, {b}")
    return max(a for a, _ in errs), max(b for _, b in errs)


def same_per_scan(T, info, ref, label):
    """Per scan the iterations and codes of ``ref`` = (T, info), and T
    within 1e-6."""
    T_ref, info_ref = ref
    for key in ("iterations", "codes"):
        if not np.array_equal(info[key], info_ref[key]):
            raise AssertionError(f"{label} {key} {info[key]} differ from the "
                                 f"survivor route's {info_ref[key]}")
    err = float(np.abs(T - T_ref).max())
    if err > 1e-6:
        raise AssertionError(f"{label}: T differs from the survivor route's "
                             f"by {err}")
    return err


def v1_tables(torch, skip, tab):
    """The v1 route's tables of the sorted map, as KDTreeMatcher builds
    them → (rt, rpen, super-chunk boxes, K10's table) on the card."""
    from libpointmatcher_tpu_torch.ops import skip_cuda

    rs, rsm = tab[2].cpu().numpy(), tab[3].cpu().numpy()
    m_pad = 128 * -(-len(rs) // 128)
    rt, rpen = skip.v1_tables(rs, rsm, m_pad)
    t = lambda a: torch.as_tensor(a, device="cuda")
    return (t(rt), t(rpen), t(skip.chunk_bboxes(rs, rsm, skip_cuda.SUPER)),
            t(skip.augmented_ref_table(rs, rsm, m_pad)[0]))


def check_v1_step(torch, kc, skc, skip, qs, qm, ub2, vt, tab, label):
    """K10 and K11 against their plain versions, and the v1 step (with the
    transported bound ``ub2`` alone, then tightened by K10) against dense
    K1, on one query batch → (the step's d², K10's effective error
    constant: the largest (d² − amin) / (eps (8 (q² + max(amin, 0)) + 1e-6))
    over the valid queries)."""
    rt, rpen, cbox, ra = vt
    _, _, ref_s, refm_s, rorder, ref, refm = tab
    b, n, _ = qs.shape
    qa, q2 = skip.augment_queries(qs, -(-n // skc.TILE_Q) * skc.TILE_Q)
    amin = skc.approx_min_sorted(qa, ra)
    aminp = skc.approx_min_sorted_plain(qa, ra)
    torch.cuda.synchronize()
    if not torch.equal(amin, aminp):
        raise AssertionError(f"{label}: K10 differs from its plain version")
    amin = amin[:, :n]
    margin = skip.bound_margin(q2, amin)
    flat_q, flat_m = qs.reshape(-1, 3), qm.reshape(-1)
    e1, j1 = kc.knn1(flat_q, flat_m, ref, refm)
    e2, _ = kc.knnk(flat_q, flat_m, ref, refm, 2)
    _, js = kc.knn1(flat_q, flat_m, ref_s, refm_s)   # the neighbour's sorted row
    d1 = e1.reshape(b, n)
    if not bool(((amin + margin)[qm] >= d1[qm]).all()):
        raise AssertionError(f"{label}: K10's bound lies below K1's d²")
    scale = EPS * (8.0 * (q2 + amin.clamp(min=0.0)) + 1e-6)
    c_eff = float(((d1 - amin) / scale)[qm].max())
    unique = flat_m & torch.isfinite(e1) & (e2[:, 1] > e1)
    tile = torch.arange(n, device="cuda") // skc.TILE_Q
    scan = torch.arange(b, device="cuda")[:, None]
    sg = js.reshape(b, n).clamp(min=0).long() // skc.SUPER
    shares = {}
    for bound, ub in (("transported", ub2),
                      ("with K10", torch.minimum(ub2, amin + margin))):
        flags = skip.build_skip_mask(qs, qm, ub, cbox)
        d, i = skc.nn1_sorted_skip(qs, qm, rt, rpen, flags)
        dp, ip = skc.nn1_sorted_skip_plain(qs, qm, rt, rpen, flags)
        torch.cuda.synchronize()
        if not (torch.equal(d, dp) and torch.equal(i, ip)):
            raise AssertionError(f"{label}, {bound} bound: K11 differs from its "
                                 f"plain version")
        if not torch.equal(d.reshape(-1), e1):
            raise AssertionError(f"{label}, {bound} bound: v1 d² differs from K1's")
        mapped = rorder[i.reshape(-1).clamp(min=0).long()].to(torch.int32)
        if not torch.equal(mapped[unique], j1[unique]):
            raise AssertionError(f"{label}, {bound} bound: v1 ids differ from K1's")
        swept = flags[scan, tile[None, :], sg] == 0
        if not bool(swept[qm].all()):
            raise AssertionError(f"{label}, {bound} bound: a true neighbour's "
                                 f"super-chunk was skipped")
        shares[bound] = round(float(flags.float().mean()), 4)
    d2, ids, frac = skip.nn1_sorted_v1(qs, qm, ub2, rt, rpen, cbox, ra)
    if not (torch.equal(d2.reshape(-1), e1) and torch.equal(d2, d)
            and torch.equal(ids, i)):
        raise AssertionError(f"{label}: nn1_sorted_v1 differs from the step")
    log(f"[v1] {label}: {b} x {n} query rows x {rt.shape[1]} map columns "
        f"({cbox.shape[0]} super-chunks), skipped share {shares}, "
        f"{int(unique.sum())} unique neighbours compared, K10's effective "
        f"error constant {c_eff:.4f}; K10 and K11 equal their plain versions")
    return d2, c_eff


def record_v1_kernels(torch, skc, skip, call, tab, launches):
    """Time K10 and K11 at one serving iteration's inputs (the arguments of
    ``ops.skip.nn1_sorted_v1``, bound switch on) → their kernel records.
    The yardsticks, one call per scan (no one PyTorch call takes the batch,
    as for K3), are logged beside the records, whose ``library_ms`` is
    null."""
    qs, qm, ub2, rt, rpen, cbox, ra = call[:7]
    b, n, _ = qs.shape
    ni = -(-n // skc.TILE_Q)
    qa, q2 = skip.augment_queries(qs, ni * skc.TILE_Q)
    nq = float(qm.sum())
    valid = rpen[0] == 0
    mv = float(valid.sum())
    amin = skc.approx_min_sorted(qa, ra)[:, :n]
    flags = skip.build_skip_mask(
        qs, qm, torch.minimum(ub2, amin + skip.bound_margin(q2, amin)), cbox)
    nsg = flags.shape[-1]
    rows = torch.nn.functional.pad(valid, (0, nsg * skc.SUPER - valid.numel()))
    rows = rows.reshape(nsg, skc.SUPER).sum(dim=1).double()
    vq = torch.nn.functional.pad(qm, (0, ni * skc.TILE_Q - n))
    vq = vq.reshape(b, ni, skc.TILE_Q).sum(dim=-1).double()
    pairs = float((((flags == 0).double() @ rows) * vq).sum())
    rv = tab[2][tab[3]]

    def k10_lib():
        return [(qa[j] @ ra).amin(dim=-1) for j in range(b)]

    def k11_lib():
        return [torch.cdist(q[m], rv, compute_mode="donot_use_mm_for_euclid_dist")
                .min(dim=1) for q, m in zip(qs, qm)]

    kernels = (
        ("K10 approx_min_sorted", lambda: skc.approx_min_sorted(qa, ra),
         lambda: skc.approx_min_sorted_plain(qa, ra), k10_lib,
         # five products, four sums and a min per pair; 5 floats of qa and
         # ra, and one output, per valid query and map column
         KERNELS["K10 approx_min_sorted"][1] * nq * mv, 24 * nq + 20 * mv),
        ("K11 nn1_sorted_skip", lambda: skc.nn1_sorted_skip(qs, qm, rt, rpen, flags),
         lambda: skc.nn1_sorted_skip_plain(qs, qm, rt, rpen, flags), k11_lib,
         # per pair of a super-chunk the tile sweeps; the queries in and the
         # (d², id) out, each valid map row (x, y, z, pen) once, the flags
         KERNELS["K11 nn1_sorted_skip"][1] * pairs,
         20 * nq + 16 * mv + 4 * flags.numel()))
    out = []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for name, run, plain, lib, ops, nbytes in kernels:
            got, want = run(), plain()
            torch.cuda.synchronize()
            if name.startswith("K10"):
                got, want = (got,), (want,)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise AssertionError(f"{name}: kernel and plain version differ")
            fin = torch.isfinite(want[0])
            err = (float((got[0][fin] - want[0][fin]).abs().max())
                   if bool(fin.any()) else 0.0)
            ms = cuda_ms(torch, run, 20)
            plain_ms = cuda_ms(torch, plain, 2)
            torch.cuda.empty_cache()
            lib_ms = cuda_ms(torch, lib, 1)
            torch.cuda.empty_cache()
            bms, by = bound_of(ops, nbytes)
            rec = {"name": name, "route": "cuda",
                   "source": "libpointmatcher_tpu_torch/csrc/skip.cu",
                   "replaces": KERNELS[name][0],
                   "launches": launches[name.split()[0]],
                   "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None}
            log(f"[kernel] main path {name} {b} x {n} query rows ({nq:.0f} valid) "
                f"x {rt.shape[1]} map columns ({mv:.0f} valid), skipped share "
                f"{float(flags.float().mean()):.4f}, {pairs:.0f} pairs swept, "
                f"yardstick one call per scan x{b}: {lib_ms:.2f} ms: "
                + json.dumps(rec))
            out.append(rec)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def v1_serving(torch, pt, kc, skc, skip, morton, cell, launches, route_launches):
    """Phases 17 and 18 on the ~30 000-row map of ``cell`` → the K10 and
    K11 kernel records."""
    from libpointmatcher_tpu_torch.ops import sweep
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    tab = cell["tab"]
    vt = v1_tables(torch, skip, tab)
    # ---- 17. K10 and K11 on the 8 scans of phase 6, cold and warm
    qs, qm = serving_queries(torch, morton, cell)
    ub2 = torch.full(qm.shape, float("inf"), device="cuda")
    d2, c_cold = check_v1_step(torch, kc, skc, skip, qs, qm, ub2, vt, tab, "cold")
    shift = torch.tensor([0.012, -0.01, 0.012], device="cuda")
    ub = torch.sqrt(d2) + torch.linalg.norm(shift)
    _, c_warm = check_v1_step(torch, kc, skc, skip, qs + shift, qm,
                              (ub * ub) * sweep.UP, vt, tab, "warm")
    c_eff = max(c_cold, c_warm)
    headroom = skip.BOUND_ERR_C / c_eff if c_eff > 0 else float("inf")
    log(f"[v1] K10's effective error constant {c_eff:.4f} against BOUND_ERR_C "
        f"{skip.BOUND_ERR_C}: headroom {headroom:.2f}x")
    if headroom < HEADROOM:
        raise AssertionError(f"K10's bound keeps {headroom:.2f}x headroom, "
                             f"below {HEADROOM}x")
    del qs, qm, d2, ub, ub2
    torch.cuda.empty_cache()

    # ---- 18. serving through the v1 routes
    s_seq = cell["seq"]
    clouds = [pt.PointCloud.from_numpy(x) for x in cell["scans"]]
    totals = {"K10": 0, "K11": 0}
    saved = {key: os.environ.get(key) for key in V1_KEYS}

    def batch():
        return register_batch_to_map(s_seq, clouds, T_inits=cell["T_inits"], seed=1)

    try:
        for label, on in V1_RUNS.items():
            ref = cell["batch_out"]
            if "PMTPU_SKIP_HOST_MORTON" in on:
                # the survivor route with the same row order
                set_switches(("PMTPU_SKIP_HOST_MORTON",))
                ref = batch()
            set_switches(on)
            batch()                                    # warm-up
            with InputRecorder(skip, "nn1_sorted_v1", keep=2) as rec:
                reset_launch_counts()
                torch.cuda.synchronize()
                t = time.perf_counter()
                T, info = batch()
                sec = time.perf_counter() - t
                counts = launches()
            it = int(info["iterations"].max())
            worst = gates(T, cell["poses"], f"{label} batch")
            bound = "PMTPU_SKIP_MXU_BOUND" in on
            want = route_launches("V1_MXU" if bound else "V1", it)
            if counts != want:
                raise AssertionError(f"{label} batch launches {counts}, expected "
                                     f"{want}")
            err = same_per_scan(T, info, ref, f"{label} batch")
            fr = [round(float(f.mean()), 4) for f in s_seq.matcher.skip_fractions]
            log(f"[v1] {label} batch of {len(clouds)}: {1e3 * sec:.2f} ms, "
                f"{len(clouds) / sec:.2f} registrations/s, iterations "
                f"{info['iterations'].tolist()}, codes {info['codes'].tolist()}, "
                f"worst rot err {worst[0]:.5f} rad, trans err {worst[1]:.5f} m, "
                f"|T - survivor T| {err:.3g}, skipped share per iteration {fr}, "
                f"launches {counts}")
            for key in totals:
                totals[key] += counts[key]
            if bound:
                recorded = rec.calls[1]
        set_switches(V1_RUNS["v1 + bound"])
        for coarse in (None, COARSE):
            T, info, counts, steps, _ = run_queue(
                torch, register_queue_to_map, s_seq, cell, coarse, launches,
                "v1 + bound route")
            want = route_launches("V1_MXU", steps)
            if counts != want:
                raise AssertionError(f"v1 queue launches {counts}, expected {want}")
            same_per_scan(T, info, cell["queue_out"][coarse],
                          f"v1 + bound queue{' c2f' if coarse else ''}")
            for key in totals:
                totals[key] += counts[key]
    finally:
        for key, val in saved.items():
            if val is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = val
    log(f"[v1] launches over phase 18: {totals}")
    return record_v1_kernels(torch, skc, skip, recorded, tab, totals)


def cdist_min_ms(torch, q, cand_t, dim, label):
    """ms of one batched ``torch.cdist`` + ``amin`` over the tiles (pen
    added), T4's and T5's function; None, logged, where cdist's grid
    refuses the shape."""
    pen = cand_t[:, 6]
    qq = q[..., :dim].contiguous()
    cc = cand_t[:, :dim].transpose(1, 2).contiguous()

    def lib():
        dist = torch.cdist(qq, cc, compute_mode="donot_use_mm_for_euclid_dist")
        return dist.square_().add_(pen[:, None, :]).amin(dim=2)

    torch.cuda.empty_cache()
    try:
        return cuda_ms(torch, lib, 1)
    except RuntimeError as e:          # a batch cdist's grid may refuse it
        log(f"[kernel] {label}: batched cdist refused at {tuple(q.shape)} x "
            f"{tuple(cand_t.shape)}: {e}")
        return None
    finally:
        torch.cuda.empty_cache()


def record_min_kernel(torch, tc, name, fn, q, cand_t, dim, launches):
    """T4 or T5 at one input against its plain version and K7's d², timed
    beside K7 and a batched ``torch.cdist`` + ``amin`` yardstick → its
    kernel record. The bound counts every query valid and every candidate
    with pen 0: 9 operations a pair, each valid query's coordinates and
    minimum, and the (x, y, z, pen) of each valid candidate column."""
    d = fn(q, cand_t, dim)
    dp = tc.tile_min_plain(q, cand_t, dim)
    d7, _ = tc.tile_sweep(q, cand_t, dim)
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(d, d7)):
        raise AssertionError(f"{name} differs from its plain version or K7's d²")
    ms = cuda_ms(torch, lambda: fn(q, cand_t, dim), 20)
    k7_ms = cuda_ms(torch, lambda: tc.tile_sweep(q, cand_t, dim), 20)
    plain_ms = cuda_ms(torch, lambda: tc.tile_min_plain(q, cand_t, dim), 2)
    library_ms = cdist_min_ms(torch, q, cand_t, dim, name)
    pen = cand_t[:, 6]
    ncand = (pen == 0).sum(dim=1).double()
    nq = float(q.shape[0] * q.shape[1])
    pairs = float((ncand * q.shape[1]).sum())
    nbytes = 4 * (dim + 1) * nq + 4 * (dim + 1) * float(ncand.sum())
    bms, by = bound_of(KERNELS[name][1] * pairs, nbytes)
    rec = {"name": name, "route": "cuda",
           "source": "libpointmatcher_tpu_torch/csrc/tile.cu",
           "replaces": KERNELS[name][0], "launches": launches,
           "max_abs_err": float((d - dp).abs().max()), "ms": ms,
           "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": library_ms}
    log(f"[kernel] main path {name} {q.shape[0]} tiles x {q.shape[1]} queries x "
        f"{cand_t.shape[2]} candidates, {pairs:.0f} pairs, K7 at the same "
        f"inputs {k7_ms:.4f} ms: " + json.dumps(rec))
    return rec


def tile_ablations(torch, tc, k7_inputs):
    """Phase 19 → the T4 and T5 kernel records (at the tool's shape)."""
    from tools_torch import tile_kernel_micro as tkm

    q7, cand7, dim7, _ = k7_inputs
    d7, _ = tc.tile_sweep(q7, cand7, dim7)
    times = {"K7": cuda_ms(torch, lambda: tc.tile_sweep(q7, cand7, dim7), 20)}
    for name, fn in (("T4", tc.tile_min_only), ("T5", tc.tile_min_one)):
        d = fn(q7, cand7, dim7)
        dp = tc.tile_min_plain(q7, cand7, dim7)
        torch.cuda.synchronize()
        if not (torch.equal(d, dp) and torch.equal(d, d7)):
            raise AssertionError(f"{name} at K7's recorded inputs differs from its "
                                 f"plain version or K7's d²")
        times[name] = cuda_ms(torch, lambda: fn(q7, cand7, dim7), 20)
    times["cdist + amin"] = cdist_min_ms(torch, q7, cand7, dim7, "K7's inputs")
    log(f"[tile] T4 and T5 at phase 14's K7 inputs ({q7.shape[0]} tiles x "
        f"{q7.shape[1]} queries x {cand7.shape[2]} candidates) equal their plain "
        f"version and K7's d²; ms {json.dumps(times)}")
    reset_launch_counts()
    report = tkm.run()
    counts = {"T4 tile_min_only": tc.tile_min_only.launches,
              "T5 tile_min_one": tc.tile_min_one.launches}
    log(f"[tile] tools_torch/tile_kernel_micro.py: {json.dumps(report)}, "
        f"launches {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the tool launched T4/T5 {counts} times")
    q, cand, _, _ = tkm.make_inputs(torch, tkm.T, tkm.TQ, tkm.M, "cuda")
    fns = {"T4 tile_min_only": tc.tile_min_only, "T5 tile_min_one": tc.tile_min_one}
    return [record_min_kernel(torch, tc, name, fn, q, cand, 3, counts[name])
            for name, fn in fns.items()]


# ------------------------------------------------------------ slice 6
def check_draws(torch, batch, scans, seed=1):
    """The reading draws of a serving batch's scans (their first filter's
    keys), formed on the card, equal to the same draws formed on the CPU bit
    for bit; the host time of forming them on the card is logged."""
    rows = max(len(s) for s in scans)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        u = batch.scan_keys(seed, len(scans), rows, "cuda").fold_in(0).draws()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t))
    uc = batch.scan_keys(seed, len(scans), rows, "cpu").fold_in(0).draws()
    if not torch.equal(u.cpu(), uc):
        raise AssertionError("the draws formed on the card differ from the CPU's")
    log(f"[draws] {len(scans)} scans x {rows} rows: the card's draws equal the "
        f"CPU's bit for bit; formed in {times[0]:.3f} ms (first), "
        f"{times[1]:.3f} ms of host time")


def check_variant(torch, kc, kv, name, q, qm, r, rm, label):
    """One of T1, T2, T3 at one input: equal to its plain version bit for
    bit, T1 and T2 to K1 as well, T3 within 2^-20·(q² + r²max) of K1's d²
    with ids equal where the neighbour is unique beyond that bound; timed
    beside its plain version and its yardstick → dict of measurements."""
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    mxu = name.startswith("T3")
    fn = {"T1": kv.knn1_chunked, "T2": kv.knn1_transposed,
          "T3": kv.knn1_mxu}[name[:2]]
    run = lambda: fn(q, qm, r, rm)
    if mxu:
        plain = lambda: kv.knn1_mxu3_plain(q, qm, r, rm)
    else:
        plain = lambda: tuple(x[:, 0] for x in knn_brute_force(q, qm, r, rm, k=1))
    mode = "use_mm_for_euclid_dist" if mxu else "donot_use_mm_for_euclid_dist"
    lib = lambda: torch.cdist(q, r[rm], compute_mode=mode).min(dim=1)
    d, i = run()
    dp, ip = plain()
    d1, i1 = kc.knn1(q, qm, r, rm)
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        raise AssertionError(f"{label} {name} differs from its plain version")
    fin = torch.isfinite(dp)
    out = {"max_abs_err": float((d[fin] - dp[fin]).abs().max()) if fin.any() else 0.0}
    if mxu:
        fin = torch.isfinite(d1)
        tol = 2.0 ** -20 * ((q * q).sum(dim=1)
                            + float((r[rm] * r[rm]).sum(dim=1).max()))
        if not (torch.equal(fin, torch.isfinite(d))
                and bool(((d - d1).abs() <= tol)[fin].all())):
            raise AssertionError(f"{label} {name}: |Δd²| to K1 above 2^-20·(q²+r²max)")
        second = kc.knnk(q, qm, r, rm, 2)[0][:, 1]
        unique = fin & ((second - d1) > 2 * tol)
        if not torch.equal(i[unique], i1[unique]):
            raise AssertionError(f"{label} {name}: ids differ from K1's where the "
                                 "neighbour is unique")
        out["max_abs_err_to_k1"] = float((d - d1).abs()[fin].max())
        out["unique_share"] = float(unique[qm].float().mean())
        out["id_agreement"] = float((i[qm] == i1[qm]).float().mean())
    elif not (torch.equal(d, d1) and torch.equal(i, i1)):
        raise AssertionError(f"{label} {name} differs from K1")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["ms"] = cuda_ms(torch, run, 20)
        out["k1_ms"] = cuda_ms(torch, lambda: kc.knn1(q, qm, r, rm), 20)
        out["plain_ms"] = cuda_ms(torch, plain, 3)
        out["library_ms"] = cuda_ms(torch, lib, 3)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    n, m = q.shape[0], r.shape[0]
    out["bound_ms"], out["bound_by"] = bound_ms(name, int(qm.sum()), int(rm.sum()),
                                                n, m, 1)
    log(f"[kernel] {label} {name} {n}x{m}: " + json.dumps(out))
    return out


def knn_variants(torch, kc, kv, seq_k1_inputs):
    """Phase 20 → the T1, T2 and T3 kernel records (at the tool's shape)."""
    from tools_torch import knn_micro

    names = ("T1 knn1_chunked", "T2 knn1_transposed", "T3 knn1_mxu")
    for name in names:
        check_variant(torch, kc, kv, name, *seq_k1_inputs, "sequence K1 inputs")
    tool_inputs = knn_micro.make_inputs(torch, knn_micro.N, knn_micro.M, "cuda")
    res = {name: check_variant(torch, kc, kv, name, *tool_inputs, "tool's shape")
           for name in names}
    reset_launch_counts()
    report = knn_micro.run()
    counts = {"T1 knn1_chunked": kv.knn1_chunked.launches,
              "T2 knn1_transposed": kv.knn1_transposed.launches,
              "T3 knn1_mxu": kv.knn1_mxu.launches}
    log(f"[variants] tools_torch/knn_micro.py: {json.dumps(report)}, "
        f"launches {counts}")
    if min(counts.values()) == 0:
        raise AssertionError(f"the tool launched T1-T3 {counts} times")
    return [{"name": name, "route": "cuda",
             "source": "libpointmatcher_tpu_torch/csrc/knn_variants.cu",
             "replaces": KERNELS[name][0], "launches": counts[name],
             **{k: res[name][k] for k in ("max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by", "library_ms")}}
            for name in names]


def kernel_inputs(torch, world, scan_world, n, m, rng, device="cuda"):
    """Queries from a scan placed in the world, references from the scene,
    every 11th query and every 7th reference masked."""
    q = scan_world[rng.choice(len(scan_world), n, replace=n > len(scan_world))]
    q = q + 0.002 * rng.standard_normal(q.shape)
    r = world[rng.choice(len(world), m, replace=m > len(world))]
    qm = np.ones(n, bool)
    rm = np.ones(m, bool)
    qm[::11] = False
    rm[::7] = False
    c = world.mean(0)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    b = lambda a: torch.as_tensor(a, device=device)
    return t(q - c), b(qm), t(r - c), b(rm)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch import matchers
    from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
    from libpointmatcher_tpu_torch.ops import morton, skip, sweep
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import knn_variants_cuda as kv
    from libpointmatcher_tpu_torch.ops import skip_cuda as skc
    from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.ops.dispatch import MXU_EPSILON_FLOOR
    from libpointmatcher_tpu_torch.parallel import (register_batch,
                                                    register_batch_to_map,
                                                    register_queue_to_map)
    from libpointmatcher_tpu_torch.parallel import batch as batch_mod

    # ---- 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {smi}")
    cap = torch.cuda.get_device_capability(0)
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"capability {cap} {torch.cuda.get_device_name(0)}")
    if cap != (9, 0):
        raise RuntimeError(f"sm_90 required, found compute capability {cap}")

    # ---- 2. build
    t0 = time.perf_counter()
    libs = (kc.LIBRARY, sc.LIBRARY, tc.LIBRARY, skc.LIBRARY, kv.LIBRARY)
    with ThreadPoolExecutor(len(libs)) as pool:   # one nvcc per source, together
        list(pool.map(lambda lib: lib.load(), libs))
    log(f"[build] {', '.join(lib.source.name for lib in libs)} built in "
        f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        for line in lib.build_log.splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                log(f"[build] {lib.source.name}: {line.strip()}")
    # the dense kernels keep their lists and staging in registers
    spills = [ln.strip() for ln in kc.LIBRARY.build_log.splitlines()
              if any(int(x) for x in re.findall(r"(\d+) bytes spill", ln))]
    if spills:
        raise AssertionError(f"knn.cu spills: {spills}")

    # ---- scene
    rng = np.random.default_rng(0)
    world = make_scene(rng)
    poses = make_poses(world, SEQ_SCANS + 1, rng)
    scans = [make_scan(world, P, rng) for P in poses]
    log(f"[scene] {len(world)} scene points, {len(scans)} scans of "
        f"{len(scans[0])} points")
    scan_world = scans[0] @ poses[0][:3, :3].T + poses[0][:3, 3]

    # ---- 3. kernels at the serving shapes
    k9_excess = []
    for name, k, (n, m) in (("K1 knn1", 1, (20480, 12459)),
                            ("K1 knn1", 1, (25000, 100000)),
                            ("K9 knn1_mxu", 1, (20480, 12459)),
                            ("K9 knn1_mxu", 1, (25000, 100000)),
                            ("K5 knnk", 10, (20480, 12459)),
                            ("K5 knnk", 32, (20480, 12459))):
        q, qm, r, rm = kernel_inputs(torch, world, scan_world, n, m, rng)
        res = check_kernel(torch, kc, name, q, qm, r, rm, k)
        log(f"[kernel] {name} k={k} {n}x{m}: " + json.dumps(res))
        if name.startswith("K9"):
            k9_excess.append(res["eps_excess"])
        del q, qm, r, rm
        torch.cuda.empty_cache()

    # ---- 4. registration through the port's entry points
    def register_sequence(seq, idx, label):
        out = []
        for i in idx:
            gT = poses[i]
            T_init = perturb(rng) @ gT
            torch.cuda.synchronize()
            t = time.perf_counter()
            T = seq.compute(pt.PointCloud.from_numpy(scans[i]), T_init=T_init, seed=i)
            T = T.cpu().numpy()
            ms = 1e3 * (time.perf_counter() - t)
            ang, tr = pose_error(T, gT)
            log(f"[{label}] scan {i}: {seq.last_iteration_count} iterations, "
                f"code {seq.last_code}, {ms:.2f} ms, rot err {ang:.5f} rad, "
                f"trans err {tr:.5f} m")
            if not (np.isfinite(T).all() and ang < ROT_TOL and tr < TRANS_TOL):
                raise AssertionError(f"{label} scan {i}: pose error {ang}, {tr}")
            out.append(seq.last_iteration_count)
        return out

    kc.reset_launch_counts()
    icp = pt.ICP()
    icp.set_default()
    gT = np.linalg.inv(poses[0]) @ poses[1]
    torch.cuda.synchronize()
    t = time.perf_counter()
    T = icp.compute(pt.PointCloud.from_numpy(scans[1]), pt.PointCloud.from_numpy(scans[0]),
                    T_init=perturb(rng) @ gT, seed=1).cpu().numpy()
    ms = 1e3 * (time.perf_counter() - t)
    ang, tr = pose_error(T, gT)
    log(f"[one-shot] {icp.last_iteration_count} iterations, code {icp.last_code}, "
        f"{ms:.2f} ms, rot err {ang:.5f} rad, trans err {tr:.5f} m")
    if not (ang < ROT_TOL and tr < TRANS_TOL):
        raise AssertionError(f"one-shot pose error {ang}, {tr}")
    iters = icp.last_iteration_count
    seq = pt.ICPSequence()
    seq.set_default()
    torch.cuda.synchronize()
    t = time.perf_counter()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    torch.cuda.synchronize()
    log(f"[set_map] {len(world)} -> {seq.prefiltered_reference_pts_count} map "
        f"points in {1e3 * (time.perf_counter() - t):.2f} ms")
    iters += sum(register_sequence(seq, range(1, SEQ_SCANS + 1), "sequence"))
    launches = {"K1 knn1": kc.knn1.launches}
    log(f"[launches] default chain: K1 {kc.knn1.launches} (iterations {iters}), "
        f"K9 {kc.knn1_mxu.launches}, K5 {kc.knnk.launches}")
    if kc.knn1.launches != iters:
        raise AssertionError("K1 launches differ from the iteration count")
    main_n = seq.prefiltered_reading_pts_count
    internal = seq.get_prefiltered_internal_map()
    T_last = poses[SEQ_SCANS]

    for name, params, attr in (("K9 knn1_mxu", {"epsilon": str(MXU_EPSILON_FLOOR)},
                                "knn1_mxu"),
                               ("K5 knnk", {"knn": "5"}, "knnk")):
        kc.reset_launch_counts()
        s2 = pt.ICPSequence()
        s2.set_default()
        s2.matcher = KDTreeMatcher(params)
        s2.set_map(pt.PointCloud.from_numpy(world), seed=0)
        it = sum(register_sequence(s2, (1, 2), f"sequence {params}"))
        launches[name] = getattr(kc, attr).launches
        log(f"[launches] {params}: {name} {launches[name]} (iterations {it}), "
            f"K1 {kc.knn1.launches}")
        if launches[name] != it or kc.knn1.launches != 0:
            raise AssertionError(f"{name}: launches do not follow the route")

    # ---- 5. kernels at the main path's shapes, for the record
    trm = seq.trm_host()
    scan_T = np.linalg.inv(trm) @ T_last
    last = scans[SEQ_SCANS]
    rows = last[rng.choice(len(last), main_n, replace=False)]
    q = torch.as_tensor((rows @ scan_T[:3, :3].T + scan_T[:3, 3]).astype(np.float32),
                        device="cuda")
    qm = torch.ones(q.shape[0], dtype=torch.bool, device="cuda")
    records = []
    for name, k in (("K1 knn1", 1), ("K9 knn1_mxu", 1), ("K5 knnk", 5)):
        res = check_kernel(torch, kc, name, q, qm, internal.points, internal.mask, k)
        log(f"[kernel] main path {name} k={k} {q.shape[0]}x{internal.num_points}: "
            + json.dumps(res))
        if name.startswith("K9"):
            k9_excess.append(res["eps_excess"])
        records.append({
            "name": name, "route": "cuda",
            "source": "libpointmatcher_tpu_torch/csrc/knn.cu",
            "replaces": KERNELS[name][0], "launches": launches[name],
            "max_abs_err": res["max_abs_err"], "ms": res["ms"],
            "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
            "bound_by": res["bound_by"], "library_ms": res["library_ms"]})
    seq_k1_inputs = (q, qm, internal.points, internal.mask)
    # K9 serves the (1+ε) contract only if its measured excess over the
    # exact neighbour distance stays below the routing floor
    if max(k9_excess) >= MXU_EPSILON_FLOOR:
        raise AssertionError(f"K9 excess {max(k9_excess):.3g} not below "
                             f"MXU_EPSILON_FLOOR {MXU_EPSILON_FLOOR}")
    del q, qm, seq, internal
    torch.cuda.empty_cache()

    # ---- serving scenes: one map per route, 8 scans each
    serve = {}
    for route, target in SERVE_SCENES.items():
        w = world if target == SCENE_POINTS else make_scene(rng, target)
        ps = make_poses(w, SERVE_BATCH, rng)
        s_seq = pt.ICPSequence()
        s_seq.set_default()
        s_seq.set_map(pt.PointCloud.from_numpy(w), seed=0)
        serve[route] = {"seq": s_seq, "poses": ps, "world": w,
                        "scans": [make_scan(w, P, rng) for P in ps],
                        "T_inits": [perturb(rng) @ P for P in ps]}
        log(f"[scene] {route} route: {len(w)} scene points -> "
            f"{s_seq.prefiltered_reference_pts_count} map rows, "
            f"{SERVE_BATCH} scans of {len(serve[route]['scans'][0])} points")

    # ---- 6. survivor kernels on 8 scans of 25 000 points, flattened
    for route in ("K4", "K3"):
        cell = serve[route]
        internal = cell["seq"].get_prefiltered_internal_map()
        tab = survivor_tables(torch, morton, sweep, internal)
        qs, qm = serving_queries(torch, morton, cell)
        ub_t = torch.full(qm.shape, float("inf"), device="cuda")
        d2 = check_survivor_step(torch, sc, sweep, kc, qs, qm, ub_t, tab,
                                 f"{route} cold")
        # the next iteration: the scans moved by 2 cm, the bound carried
        shift = torch.tensor([0.012, -0.01, 0.012], device="cuda")
        ub_t = (torch.sqrt(d2) + torch.linalg.norm(shift)) * sweep.UP
        check_survivor_step(torch, sc, sweep, kc, qs + shift, qm, ub_t, tab,
                            f"{route} warm")
        cell["tab"] = tab
        del qs, qm, d2, ub_t
        torch.cuda.empty_cache()

    # ---- 7. batch serving through register_batch_to_map
    def launches():
        return {"K1": kc.knn1.launches,
                "K2": sc.survivors_and_bounds.launches,
                "K3": sc.nn1_survivor_sweep.launches,
                "K4": sc.nn1_survivor_sweep_stream.launches,
                "K5": kc.knnk.launches,
                "K6": sc.nnk_survivor_sweep.launches,
                "K10": skc.approx_min_sorted.launches,
                "K11": skc.nn1_sorted_skip.launches}

    def route_launches(route, n):
        """The launches a serving run of n iterations makes on a route."""
        used = {"K1": ("K1",), "K3": ("K2", "K3"), "K4": ("K2", "K4"),
                "K6": ("K2", "K6"), "V1": ("K11",),
                "V1_MXU": ("K10", "K11")}[route]
        return {name: n if name in used else 0 for name in launches()}

    check_draws(torch, batch_mod, serve["K4"]["scans"])
    for route, cell in serve.items():
        s_seq = cell["seq"]
        clouds = [pt.PointCloud.from_numpy(x) for x in cell["scans"]]
        register_batch_to_map(s_seq, clouds, T_inits=cell["T_inits"], seed=1)
        torch.cuda.synchronize()
        reset_launch_counts()
        with PrepTimer(batch_mod) as prep:
            t = time.perf_counter()
            T, info = register_batch_to_map(s_seq, clouds,
                                            T_inits=cell["T_inits"], seed=1)
            ms = 1e3 * (time.perf_counter() - t)
        counts = launches()
        it = int(info["iterations"].max())
        fracs = [round(float(f.mean()), 4)
                 for f in s_seq.matcher.survivor_fractions]
        log(f"[serve] {route} route, batch {SERVE_BATCH}: {ms:.2f} ms per batch, "
            f"{ms / SERVE_BATCH:.2f} ms per scan, prep {prep.ms:.2f} ms, "
            f"iterations {info['iterations'].tolist()}, codes "
            f"{info['codes'].tolist()}")
        log(f"[serve] {route} route: launches {counts}, survivor share per "
            f"iteration {fracs}")
        for i, (Ti, P) in enumerate(zip(T, cell["poses"])):
            ang, tr = pose_error(Ti, P)
            log(f"[serve] {route} scan {i}: rot err {ang:.5f} rad, "
                f"trans err {tr:.5f} m")
            if not (np.isfinite(Ti).all() and ang < ROT_TOL and tr < TRANS_TOL):
                raise AssertionError(f"{route} serving scan {i}: pose error "
                                     f"{ang}, {tr}")
        want = route_launches(route, it)
        if counts != want:
            raise AssertionError(f"{route} serving launches {counts}, "
                                 f"expected {want}")
        cell["launches"] = counts
        cell["batch_out"] = T, info
        with InputRecorder(sweep) as rec:
            pending = register_batch_to_map(s_seq, clouds,
                                            T_inits=cell["T_inits"], seed=1,
                                            block=False)
            T2, _ = pending.result()
        if not np.allclose(T2, T, atol=1e-6):
            raise AssertionError(f"{route}: block=False gave other poses")
        cell["inputs"] = (rec.calls[min(1, len(rec.calls) - 1)][:3]
                          if rec.calls else None)

    # ---- 8. survivor kernels at the serving runs' inputs, for the record
    serve_launches = {
        "K2 survivors_and_bounds": serve["K4"]["launches"]["K2"],
        "K3 nn1_survivor_sweep": serve["K3"]["launches"]["K3"],
        "K4 nn1_survivor_sweep_stream": serve["K4"]["launches"]["K4"]}
    for route, names in (("K4", ("K2 survivors_and_bounds",
                                 "K4 nn1_survivor_sweep_stream")),
                         ("K3", ("K3 nn1_survivor_sweep",))):
        cell = serve[route]
        records += record_survivor_kernels(torch, sc, sweep, *cell["inputs"],
                                           cell["tab"], names, serve_launches,
                                           route)
        torch.cuda.empty_cache()

    # ---- 9. K6 on the 8 scans of phase 6, against the ~30 000-row map
    cell = serve["K3"]
    qs, qm = serving_queries(torch, morton, cell)
    shift = torch.tensor([0.012, -0.01, 0.012], device="cuda")
    for k in (2, 3, 4):
        ub_t = torch.full(qm.shape, float("inf"), device="cuda")
        dk = check_topk_step(torch, sc, sweep, kc, qs, qm, ub_t, cell["tab"],
                             k, f"K6 k={k} cold")
        ub_t = (torch.sqrt(dk[..., -1]) + torch.linalg.norm(shift)) * sweep.UP
        check_topk_step(torch, sc, sweep, kc, qs + shift, qm, ub_t,
                        cell["tab"], k, f"K6 k={k} warm")
    del qs, qm, dk, ub_t
    torch.cuda.empty_cache()

    # ---- 10. K1's pair axis
    check_pair_axis(torch, kc, scans)

    # ---- 11. queue serving, 64 scans through 8 lanes, per route
    knn3 = pt.ICPSequence()
    knn3.set_default()
    knn3.matcher = KDTreeMatcher({"knn": "3"})
    knn3.set_map(pt.PointCloud.from_numpy(serve["K3"]["world"]), seed=0)
    serve["K6"] = dict(serve["K3"], seq=knn3)
    for route, cell in serve.items():
        if route == "K6":
            cell.update({k: serve["K3"][k] for k in ("qclouds", "qinits", "qposes")})
            continue
        ps = make_poses(cell["world"], QUEUE_SCANS, rng)
        cell["qposes"] = ps
        cell["qclouds"] = [pt.PointCloud.from_numpy(make_scan(cell["world"], P, rng))
                           for P in ps]
        cell["qinits"] = [perturb(rng) @ P for P in ps]
    env_skip = os.environ.get("PMTPU_SERVE_SKIP")
    k6_launches = 0
    for route, cell in serve.items():
        if route == "K6":
            os.environ["PMTPU_SERVE_SKIP"] = "1"
        q_seq = cell["seq"]
        for coarse in (None, COARSE):
            T, info, counts, steps, recorded = run_queue(
                torch, register_queue_to_map, q_seq, cell, coarse,
                launches, f"{route} route")
            want = route_launches(route, steps)
            if counts != want:
                raise AssertionError(f"{route} queue launches {counts}, "
                                     f"expected {want}")
            cell.setdefault("queue_out", {})[coarse] = T, info
            if coarse is not None:
                check_coarse_pass(torch, kc, sc, sweep, recorded,
                                  cell.get("tab"), route)
                del recorded
                torch.cuda.empty_cache()
            if route == "K6":
                k6_launches += counts["K6"]
            if coarse is None:
                _, ib = register_batch_to_map(
                    q_seq, cell["qclouds"][:SERVE_BATCH],
                    T_inits=cell["qinits"][:SERVE_BATCH], seed=1)
                for key in ("iterations", "codes"):
                    if not np.array_equal(ib[key], info[key][:SERVE_BATCH]):
                        raise AssertionError(
                            f"{route} queue {key} {info[key][:SERVE_BATCH]} "
                            f"differ from the batch's {ib[key]}")
        if route == "K6":
            with InputRecorder(sweep, "nnk_sorted_v2") as rec:
                register_queue_to_map(q_seq, cell["qclouds"][:2 * QUEUE_LANES],
                                      T_inits=cell["qinits"][:2 * QUEUE_LANES],
                                      seed=1, lanes=QUEUE_LANES)
            if env_skip is None:
                del os.environ["PMTPU_SERVE_SKIP"]
            else:
                os.environ["PMTPU_SERVE_SKIP"] = env_skip
            records.append(record_topk_kernel(
                torch, sc, sweep, *rec.calls[1][:3], cell["tab"], 3, k6_launches))
        torch.cuda.empty_cache()

    # ---- 12. register_batch: 4 one-shot pairs, scan i+1 onto scan i
    pair_icp = pt.ICP()
    pair_icp.set_default()
    gts = [np.linalg.inv(poses[i]) @ poses[i + 1] for i in range(PAIRS)]
    kc.reset_launch_counts()
    with InputRecorder(matchers, "knn_search") as rec:
        T, info = register_batch(
            pair_icp, [pt.PointCloud.from_numpy(scans[i + 1]) for i in range(PAIRS)],
            [pt.PointCloud.from_numpy(scans[i]) for i in range(PAIRS)],
            T_inits=[perturb(rng) @ g for g in gts], seed=1)
    it = int(info["iterations"].max())
    k1_launches = kc.knn1.launches
    log(f"[pairs] register_batch of {PAIRS} pairs: iterations "
        f"{info['iterations'].tolist()}, codes {info['codes'].tolist()}, K1 "
        f"launches {kc.knn1.launches} (lockstep iterations {it})")
    for i, (Ti, g) in enumerate(zip(T, gts)):
        ang, tr = pose_error(Ti, g)
        log(f"[pairs] pair {i}: rot err {ang:.5f} rad, trans err {tr:.5f} m")
        if not (np.isfinite(Ti).all() and ang < ROT_TOL and tr < TRANS_TOL):
            raise AssertionError(f"register_batch pair {i}: pose error {ang}, {tr}")
    if (k1_launches, kc.knn1_mxu.launches, kc.knnk.launches) != (it, 0, 0):
        raise AssertionError("register_batch launches do not follow the route")
    # every K1 call of that run, at the filtered pairs' padded shapes
    if len(rec.calls) != it or any(c[2].ndim != 3 for c in rec.calls):
        raise AssertionError(f"register_batch made {len(rec.calls)} pair-axis "
                             f"searches, expected {it}")
    for j, call in enumerate(rec.calls):
        check_k1_call(torch, kc, *call[:4], f"register_batch iteration {j}")
    del rec
    torch.cuda.empty_cache()

    # ---- 13.-16. large-map tile-sweep serving
    tile_records, k7_inputs = tile_serving(torch, pt, kc, sc, tc, launches)
    records += tile_records
    torch.cuda.empty_cache()

    # ---- 17.-18. the v1 skip routes on the ~30 000-row map
    records += v1_serving(torch, pt, kc, skc, skip, morton, serve["K3"],
                          launches, route_launches)
    del serve
    torch.cuda.empty_cache()

    # ---- 19. K7's ablations T4 and T5
    records += tile_ablations(torch, tc, k7_inputs)
    del k7_inputs
    torch.cuda.empty_cache()

    # ---- 20. the 1-NN lowerings T1, T2 and T3
    records += knn_variants(torch, kc, kv, seq_k1_inputs)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
