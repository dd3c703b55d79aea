"""Smoke run of libpointmatcher_tpu_torch on one CUDA card (Hopper, sm_90).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
   compute capability 9.0 is required;
2. build: every kernel source of ``libpointmatcher_tpu_torch/csrc``
   (knn.cu, sweep.cu, tile.cu, skip.cu, knn_variants.cu), one nvcc each,
   all started together; ptxas's register and spill report, and no spill
   in knn.cu (K1, K9 and every K5 list length), in sweep.cu (K2, K3/K4,
   every K6 list length), in tile.cu (K7, every K8 list length, T4, T5)
   nor in knn_variants.cu (T1, T2, T3);
3. dense kernels: K1, K9 and K5 against their plain torch versions on the
   card, at the serving shapes 20480 x 12459 and 25000 x 100000, timed with
   CUDA events beside the plain version and a ``torch.cdist`` yardstick
   (for K9 its matmul form, TF32 off);
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
   equal, and equal to its schedule emulated in torch
   (tests/torch_survivor_emulation.py), whose shares of (warp, chunk)
   pairs that the prefilter passes are logged; K3 and K4 equal to their plain versions and to each other, both
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
   second lockstep iteration), timed beside the plain versions (K2 over
   200 calls) and, for K3 and K4, a ``torch.cdist`` yardstick; K2's bound
   counts the work of these inputs: the pairs its emulated schedule
   evaluates per query in each pass and its prefilter's test of every
   (warp, chunk) pair (the bound over every (query, chunk) pair, the
   unpruned work, is logged beside it); K3 is also timed at K4's inputs
   and K4 at K3's, each sweep also at the 1024-query fold and with only its
   longest list kept; the sweeps' bound counts the pairs the route sweeps
   (its 256-query tiles), and the pairs of the 1024-query fold and the bound
   over them, with the list statistics, are logged beside it;
9. K6, the top-k survivor sweep, against its plain version for k = 2, 3
   and 4 on the 8 scans of phase 6 against the ~30 000-row map, cold and
   with a transported bound, at K2's own 256-query flags (the route's):
   equal bit for bit to its plain version there, and on every valid query
   to the plain version at the 1024-query fold (the TPU's), and the
   route's d² equal to K5's dense top-k column for column, its ids equal
   to K5's through the Morton order where the neighbour is unique;
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
   iteration) at the route's flags beside its plain version and a
   ``torch.cdist`` + ``topk`` yardstick, its bound over the pairs of the
   256-query tiles it sweeps; the bound over the pairs of the 1024-query
   fold is logged beside it;
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
   through the culled self-search: one K8 launch (k = 10, the parent form:
   every parent tile over its virtual tiles, merged, the radius applied in
   the kernel), its call recorded and K8 held to its plain version there
   bit for bit, and the whole search held to dense K5 (d² equal, ids where
   unique);
14. ``register_batch_to_map`` of the 8 scans on that map: every pose under
   the gates, no motion-bound flag, K7 launches equal to the lockstep
   iterations and no other k-NN launch; the second lockstep iteration's K7
   call (the parent form) is recorded and held to its plain version bit for
   bit, and the step's result, ``maxDist`` applied, to dense K1 wherever
   K1's neighbour lies within ``maxDist`` (equal d², equal ids where
   unique, +inf beyond);
15. ``register_queue_to_map`` of 24 scans (the 8, three times) through 8
   lanes on that map: every pose under the gates, no motion-bound flag, K7
   launches equal to the lane iterations, the first 8 scans' iterations and
   codes equal to the batch's;
16. one batch of the 8 scans against a 4·10^5-point terrain map, under the
   same gates and launch rule. K7 and K8 are timed at their recorded calls
   beside their plain versions and a batched ``torch.cdist`` yardstick over
   the same virtual tiles, their bound and issue floor from the recorded
   work (tools_torch/tile_micro.py's ``stats``: live queries, live and real
   candidate columns, virtual tiles per parent), which is logged;
17. the v1 skip route's kernels K10 and K11 on the 8 scans of phase 6
   against the ~30 000-row map, cold and with a transported bound: K10 and
   K11 equal to their plain versions bit for bit, the v1 step (with the
   transported bound alone and tightened by K10) equal to dense K1 (d², and
   ids through the Morton order where the neighbour is unique), every valid
   query's true neighbour in a super-chunk its tile does not skip, and K10's
   bound above K1's d² on every valid query; K10 also equal to its schedule
   emulated in torch (tests/torch_skip_emulation.py), whose swept share of
   the (query, column) pairs is logged; the same checks cold with the scans
   and the map translated by 10³ m; the effective error constant of
   K10 is logged and must leave 8x headroom under ``BOUND_ERR_C`` at the
   scene's own coordinates; the skipped shares are logged;
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
   map for K11; K10's bound is the pruned work its emulation counts there
   (the brute-force bound logged beside it);
19. K7's ablations T4 and T5 (tools_torch/tile_kernel_micro.py) at phase
   14's recorded K7 call, its queries gathered per virtual tile (the
   per-tile form), and through the tool itself at its shape (2048 tiles ×
   256 queries × 4096 candidates), its launches counted from 0: both equal
   their plain version and K7's per-tile d² bit for bit; timed there beside
   K7's per-tile form and a batched ``torch.cdist`` + ``amin`` yardstick;
20. the 1-NN lowerings T1, T2 and T3 (tools_torch/knn_micro.py) at the
   tool's shape (20 480 x 12 459, uniform in [-10, 10]^3, the last 7% of
   the queries masked) and at phase 5's recorded K1 inputs: each equal to
   its plain version bit for bit, T1 and T2 equal to K1 in d² and ids, T3
   within 2^-20·(q² + r²max) of K1's d² with ids equal where the neighbour
   is unique beyond that bound; timed beside the plain versions and a
   yardstick (``torch.cdist`` + ``min``, the difference form for T1 and T2,
   the matrix-product form with TF32 off for T3); then the tool itself
   runs once, its launches counted from 0;
21. the loop modules (no kernel of their own: plain torch on the card):
   every outlier filter (RobustOutlierFilter with each cost and scale
   estimator), minimizer and transformation at the recorded first step of
   a sequence on phase 4's map with knn = 1 (K1) and with knn = 3 (K5),
   held to the same module on the CPU (tools_torch/loop_modules.py: weights
   equal, Robust within 1e-6 relative, transforms within 1e-5, covariances
   within 1e-4 of their largest entry) and timed with CUDA events; then
   the YAML chains PointToPoint + TrimmedDist, PointToPlane + Robust
   (cauchy, mad, ``nbIterationForScale: 2``), PointToPlaneWithCov +
   MedianDist + SurfaceNormal (normals on the reading) and PointToPoint +
   VarTrimmedDist, beside the default chain: ``ICPSequence.compute`` of 2
   scans on phase 4's map (K1 launches equal the iterations),
   ``register_batch_to_map`` of phase 7's 8 scans on the ~30 000-row map
   (K2 and K3 launches equal the lockstep iterations) and, for the Robust
   chain, ``register_queue_to_map`` of 16 of phase 11's scans through 8
   lanes; every pose under the gates, ``get_covariance`` finite, symmetric
   and positive semi-definite; ms per iteration and launches logged;
22. the engine features (no kernel of their own; each run through K1, K2 +
   K3 or K7): a FixStepSampling step filter (startStep 4, endStep 1,
   stepMult 0.5) on a sequence of 2 scans on phase 4's map, in the loop and
   forced through the stepped driver (the same iterations, poses within
   1e-5), a RandomSampling step filter (prob 0.5, the stepped driver), and
   FixStep on the batch of phase 7's 8 scans on the ~30 000-row map and a
   queue of 16 of phase 11's scans through 8 lanes (the queue gives the
   batch's iterations and poses within 1e-5); Anderson acceleration on the
   sequence and the batch beside the plain loop, summed iterations logged,
   the card's Anderson pose at a fixed budget of 10 iterations within 1e-5
   of the CPU's on the same inputs (a 4000-point scan, a 12 000-point
   scene), and the accelerated queue served as a batch and equal to it;
   one ``ICP`` with ``PerformanceInspector`` (the ten statistics, touched
   pairs = iterations × valid reading × valid map), a tile-route batch on
   phase 13's terrain reporting its per-scan tile pairs, ``VTKFileInspector``
   (binary, reading and links: one file of each an iteration) and a
   ``FileLogger`` holding the engine's line; ``SimpleSensorNoise`` on the
   reading: ``get_overlap()`` equal to ``estimate_overlap`` on the CPU at
   the same final matches (one pair of slack for the mean's sum order);
   every pose under the gates, the launches following each route, ms per
   iteration logged beside the card's name and power limit (each sequence
   chain, batch, queue and one-shot after one untimed call, beside a
   one-shot with the null inspector);
23. the data filters (no kernel of their own; their chains run K8 + K5,
   K1 and K2 + K3): the map maintenance of the reference's align_sequence
   (SurfaceNormal(knn 10, epsilon 5, densities) + MaxDensity(30), then
   MaxPointCount at half of what MaxDensity leaves) as the map chain of a
   sequence of 2 scans on the 100 000-point scene; a sensor's reading chain
   (BoundingBox around the sensor, MaxDist 12 m, MinDist 0.3 m,
   RandomSampling 0.5) in a batch of 8 and a queue of 16 (8 lanes) on the
   ~30 000-row map, the queue taking it and giving the batch's iterations
   and poses (within 1e-5); the descriptor chain (VoxelGrid 5 cm,
   SurfaceNormal, ObservationDirection, OrientNormals, IncidenceAngle,
   Shadow, Sphericality, CutAtDescriptorThreshold) as the map chain of the
   60 000-point scene in the frame of a sensor inside it, and an
   Elipsoids(samplingMethod 1) map, each with a sequence of 2 scans; every
   pose under the gates, each set_map's and run's launches and the ms per
   iteration logged. Then each new filter once at 100 000 rows (the
   scene with a time channel, or its SurfaceNormal output), its card time
   after one untimed call and its output held to the CPU's on the same
   input (tools_torch/filter_checks.py: masks, kept rows and times equal,
   OctreeGrid's medoid and CovarianceSampling sharing at least 99.9% and
   99% of their rows, values within the stated tolerances);
24. IO and the cell-grid matchers (no kernel of their own: host parsing
   and plain torch gathers; their paths run K8, K1 and K5): the 100 000-point
   scene with SurfaceNormal's normals and an int64 time channel saved as
   CSV, VTK, PLY and PCD (ascii and binary) and loaded onto the card through
   ``io.load``, each equal to the scene (floats bit for bit, times exact;
   PLY carries no time channel), save and load ms logged, the native parser
   required; ``CellGridMatcher`` (knn 1, maxDist ``CELL_MAX_DIST``) in the
   default chain on the map loaded from the binary VTK: a sequence of 2
   scans, a batch of 8, a queue of 16 through 8 lanes equal to the batch of
   the same 16 (iterations, poses within 1e-5), no k-NN kernel launched, ms
   per step (a lockstep or lane iteration, one grid search each) logged,
   ``cell_knn`` at the batch's second lockstep iteration timed and its first
   8192 queries equal to the CPU's (d² bit for bit, ids equal), mc, the
   tile's gather and the peak memory logged; ``KDTreeVarDistMatcher`` with
   a ``maxSearchDist`` descriptor on the readings: a sequence of 2 scans on
   the ~30 000-row map (the culled route, no launch), its culled and dense
   routes equal at a recorded step for knn 1 and 3, a batch of 8 on the
   host path and its queue served as that batch; sequences at knn 1 and 3 on
   a map of ``VAR_DENSE_ROWS`` rows (the dense route: K1 and K5 launches equal the
   iterations); the registered reading saved and read back. Every pose
   under the gates, ms per iteration logged beside the card's name and
   power limit;
25. the applications (no kernel of their own; their paths run K1, K5 and K8):
   every ported application's ``main`` in this process with ``--device
   cuda``, its output captured, on files written under ``.chip_scratch/``
   (the scans as binary VTK, the scene as CSV and VTK). icp_simple,
   icp_customized and icp_advance_api register scan 1, saved through a
   perturbed guess of its pose, onto scan 0, and icp scan 1 itself with
   that guess as ``--initTranslation``/``--initRotation``: each pose under
   the gates; align_sequence over the
   9 scans, each saved in scan 0's frame through a perturbed odometry guess,
   gives back each guess's error under the gates and a map that reloads;
   build_map merges the scans at their ground-truth poses; compute_overlap
   gives a 9 × 9 matrix with 1 on its diagonal, and its 1 → 0 entry again
   with the plain search; eval_solution on 16 pairs at ``--batch 1`` and
   ``--batch 8`` (a deterministic chain), every pair under the gates and
   the two drivers equal per pair (iterations and errors; rotation entries
   within 1e-5, translations within 3e-5 m), pairs/s
   logged; plot_results on its JSON; filter_profiler with
   SurfaceNormal(knn 10) on the scene (K8); list_modules in its three
   styles; golden_check on synthetic example data (the default chain and
   the known pose); demo_pipeline on the scene with 6 scans (the refined
   trajectory error at most the noisy one); and ``optimize_pose_graph``
   alone at the demo's size, timed. Each application's wall ms and its
   K1, K5, K7 and K8 launches are logged, and one that should launch K1, or
   K5 or K8, and launched none fails the phase;
26. multi-device on ``torch.distributed`` (no kernel of its own; its
   shards run K1, K5, K7 and K2 with K3/K4): on phase 11's sequence map
   (the K4 route's, padded to a multiple of 4 rows) and a 25 000-point
   scan in its frame, ``sharded_knn`` (k 1 and 5), ``sharded_tile_nn1``,
   ``sharded_nn1_sorted_v2`` (the map's survivor tables padded for the
   mesh), ``sharded_block_nn1``, ``register_batch(mesh=)`` on phase 12's
   4 pairs, ``register_batch_to_map(mesh=)`` on phase 11's 8 scans (the
   map installed from phase 11's arrays) and the sharded pose graph (64
   poses), first on one NCCL rank in this process, then on 2 and on 4
   gloo ranks spawned on the one card (``tests/torch_sharding_worker.py``,
   a ``file://`` store, every collective under a timeout, each group under
   a deadline): every result equal to the single-device one on the card
   bit for bit (the pose graph and the pairs within 1e-5), the batch equal
   to phase 11's poses bit for bit, ``gather_rows``' sharded case keeping
   −0.0 and ±inf; per rank the batch's registrations/s, its K1 launches an
   iteration, K1's ms (CUDA events) and the collectives' ms with their host
   staging (host clock between synchronizes) logged. Then
   ``scaling_bench --ranks 4 --backend gloo`` and ``--ranks 1 --backend
   nccl`` (each mesh size's registrations/s) and the two-process dry run
   (``tools_torch/dryrun_multihost.py``: poses within 1e-5 of one process)
   in subprocesses. A failed rank or a deadline fails the phase;
27. the JAX package's switches, each set for its case alone and restored
   after it: ``PMTPU_KNN_IMPL=mxu`` on phase 4's sequence of 8 scans (a
   fresh ``set_map`` of the scene), phase 7's batch on the 25 000-point
   scene's map (dense) and phase 11's queue of 64 on it: K9 launches equal
   to the iterations (lane iterations for the queue), K1 and every other
   kernel none, every pose under the gates; the relative excess of K9's
   pick over K1's d² at every recorded sequence search (maximum, 99th
   percentile) and both kernels' ms at the first one logged; phase 7's
   batch on the 50 147-row map (the survivor route, K2 + K4) launches no
   K9 and equals the batch without the switch bit for bit. The three
   switches the port does not read (``PMTPU_SOLVE=chol``,
   ``PMTPU_SELECT=bisect``, ``PMTPU_STACK_NUMPY=0``, ROADMAP Queue 3): the
   dense batch of host clouds under all three equal bit for bit, launches
   included, to the batch without them. The upload of host clouds: the
   dense batch and a terrain tile batch (phase 14's configuration, 8 scans
   on a fresh 10^5-point map), their scans handed in as host clouds,
   stacked on the host (the port's path) and moved one by one (the path of
   scans that differ in channels), in turns, equal bit for bit, each path's
   prep host ms and batch ms logged. ``PMTPU_CACHE_DIR``: a
   subprocess with a fresh directory builds the five CUDA sources and the
   native library there, and a second one loads all six with no compiler
   run (``subprocess.run`` refused in it); both gated.

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
from pathlib import Path

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
    # per (query row, chunk column) of the unpruned work: 13 operations for
    # the bound, 20 for the flag; the bound counts the pruned work instead
    # (K2_QUERY_OPS, K2_WARP_OPS), this only the figure logged beside it
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
    # per (valid query, valid map row) of the brute force: five products,
    # four sums, one min; the bound counts the pruned work instead
    # (K10_TEST_OPS, K10_PAIR_OPS), this only the figure logged beside it
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
# K2's work at its inputs (csrc/sweep.cu::survivors_bounds): fp32
# operations per (query, chunk) pair that pass 1 (the bound) and pass 2 (the
# flag) evaluate, and per (warp, chunk) pair of each pass's prefilter, which
# tests every pair: the box's gaps, their squares' sum, the candidate or
# the lhs, the compares
K2_QUERY_OPS = (13, 20)
K2_WARP_OPS = (22, 20)
# K10's work at its inputs (csrc/skip.cu::approx_min): fp32 operations per
# (warp, chunk) box test and per (query, chunk) lane test (three gaps, their
# squares' sum, the shaved bound, the limit, two compares) and per
# (query, map column) pair that a lane failing its own test needs (three
# products, three sums, a min); the pairs a sweep by all lanes forms for
# the other lanes are the kernel's choice, logged but not counted
K10_TEST_OPS = 23
K10_PAIR_OPS = 7
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
        # the function K9 computes: the matmul form, fp32 (TF32 off below)
        lib = lambda: torch.cdist(q, r[rm], compute_mode="use_mm_for_euclid_dist").min(dim=1)
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
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["library_ms"] = cuda_ms(torch, lib, plain_reps)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
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
    _, shares = k2_work(torch, qp, ct, 1, nch, (ub, surv), label)
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
        f"both flag folds; K2 prefilter {json.dumps(shares)}; lists "
        f"{json.dumps(list_stats(torch, qp, surv, ct, nch))}")
    return d2


def k10_work(torch, qa, ra, want, label):
    """K10's work at these inputs, from its schedule emulated in torch on
    the card (tests/torch_skip_emulation.py), whose output is held to the
    kernel's ``want`` → (fp32 operations, bytes, counts)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import torch_skip_emulation as skem

    got, c = skem.emulate_k10(qa, ra)
    if not torch.equal(got, want):
        raise AssertionError(f"{label}: K10 differs from its emulated schedule")
    ops = (K10_TEST_OPS * (c["box_tests"] + c["lane_tests"])
           + K10_PAIR_OPS * c["swept_pairs"])
    nch = -(-ra.shape[1] // skem.CHUNK)
    # qa's four read columns and the output per query row, ra's rows 0..3
    # per column, the chunk table written and read
    nbytes = 20 * c["dense_pairs"] // max(ra.shape[1], 1) + 16 * ra.shape[1] + 72 * nch
    c["per_warp"] = {"max": int(c["per_warp"].max()),
                     "mean": float(c["per_warp"].float().mean())}
    return ops, nbytes, {**c, "swept_share": c["swept_pairs"] / max(c["dense_pairs"], 1)}


def k2_work(torch, qp, ct, k, nch, want, label):
    """K2's work at these inputs, from its schedule emulated in torch on
    the card (tests/torch_survivor_emulation.py), whose bounds and flags are
    held to the kernel's ``want`` → (fp32 operations, the shares of (warp, chunk)
    pairs evaluated in pass 1, passing pass 2's test, evaluated in pass 2)."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import torch_survivor_emulation as em

    ub, surv, c = em.emulate_k2(qp, ct, k, nch=nch)
    if not (torch.equal(ub, want[0]) and torch.equal(surv, want[1])):
        raise AssertionError(f"{label}: K2 differs from its emulated schedule")
    ops = (32 * (K2_QUERY_OPS[0] * c["pass1"] + K2_QUERY_OPS[1] * c["pass2"])
           + (K2_WARP_OPS[0] + K2_WARP_OPS[1]) * c["pairs"])
    pairs = max(c["pairs"], 1)
    return ops, {"pairs": c["pairs"], "pass1": c["pass1"] / pairs,
                 "pass2_box": c["pass2_box"] / pairs, "pass2": c["pass2"] / pairs}


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
            # the work these inputs need (the padding chunks are not
            # visited); the query table read, the flags of every column
            # written
            n_pad, nch_pad = qp.shape[0], ct.shape[1]
            ops, sh = k2_work(torch, qp, ct, 1, nch, run(), name)
            nbytes = 36 * n_pad + 32 * nch + 4 * (n_pad // 256) * nch_pad
            unpruned, _ = bound_of(KERNELS[name][1] * n_pad * nch, nbytes)
            extra = (f", prefilter {json.dumps(sh)}, {ops:.6g} operations "
                     f"(the bound over every (query, chunk) pair, the "
                     f"unpruned work: {unpruned:.5f} ms)")
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
        # K2 takes tens of microseconds: a longer window
        ms = cuda_ms(torch, run, 200 if name.startswith("K2") else 20)
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
        #: every call, recorded or not
        self.count = 0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        setattr(self.module, self.name, self)
        return self

    def __call__(self, *a, **k):
        self.count += 1
        if self.keep is None or len(self.calls) < self.keep:
            self.calls.append(tuple(x.clone() if hasattr(x, "clone") else x
                                    for x in a))
        return self.orig(*a, **k)

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


class PrepTimer:
    """Host time of the serving batch's prep calls (``batch._prep_scans``,
    or the tile route's ``_prep_tile_scans``) while the context is open,
    summed in ``ms``."""

    def __init__(self, module, name="_prep_scans"):
        self.module = module
        self.name = name
        self.ms = 0.0

    def __enter__(self):
        self.orig = getattr(self.module, self.name)

        def timed(*a, **k):
            t = time.perf_counter()
            out = self.orig(*a, **k)
            self.ms += 1e3 * (time.perf_counter() - t)
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


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
    """K6 at K2's own 256-query flags (the route's) against its plain
    version there and, on the valid queries, against the plain version at
    the 1024-query fold (the TPU's flags), and the top-k survivor route
    against K5 on the map in its own order, on one query batch → the
    route's d²."""
    rt3, ct, _, _, rorder, ref, refm = tab
    nch = rt3.shape[0]
    qp = sweep.query_table(qs, qm, ub_t)
    _, surv = sc.survivors_and_bounds(qp, ct, k, nch=nch)
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    d6, i6 = sc.nnk_survivor_sweep(qp, rt3, surv, k)
    dp, ip = sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
    d4, i4 = sc.nnk_survivor_sweep_plain(qp, rt3, surv4, k)
    torch.cuda.synchronize()
    if not (torch.equal(d6, dp) and torch.equal(i6, ip)):
        raise AssertionError(f"{label}: K6 differs from its plain version")
    qv = qp[:, 3] == 0
    if not (torch.equal(d6[qv], d4[qv]) and torch.equal(i6[qv], i4[qv])):
        raise AssertionError(f"{label}: K6 at 256-query flags differs from "
                             f"the 1024-query fold")
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
        f"neighbours compared; K6 equals its plain version at its flags and "
        f"at the 1024-query fold, and K5")
    return dk


def record_topk_kernel(torch, sc, sweep, qs, qm, ub_t, tab, k, launches):
    """Time K6 at one serving iteration's inputs, at the route's flags (K2's
    own 256-query rows) → its kernel record; its bound counts the pairs of
    those tiles. The bound over the 1024-query fold's pairs is logged beside
    it, and so is K2 (k) on these inputs."""
    rt3, ct, ref_s, refm_s = tab[:4]
    nch = rt3.shape[0]
    name = "K6 nnk_survivor_sweep"
    qp = sweep.query_table(qs, qm, ub_t)
    k2_out = sc.survivors_and_bounds(qp, ct, k, nch=nch)
    surv = k2_out[1]
    surv4 = surv.reshape(-1, 4, surv.shape[1]).amax(dim=1)
    run = lambda: sc.nnk_survivor_sweep(qp, rt3, surv, k)
    plain = lambda: sc.nnk_survivor_sweep_plain(qp, rt3, surv, k)
    d, i = run()
    dp, ip = plain()
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        raise AssertionError(f"{name}: kernel and plain version differ")
    ms = cuda_ms(torch, run, 20)
    ms_k2 = cuda_ms(torch, lambda: sc.survivors_and_bounds(qp, ct, k, nch=nch), 200)
    _, shares = k2_work(torch, qp, ct, k, nch, k2_out, "K2 at K6's inputs")
    plain_ms = cuda_ms(torch, plain, 2)
    # the yardstick: one cdist + topk call per lane over its valid queries
    # (no one call takes the batch, as for K3)
    rv = ref_s[refm_s]
    lib = lambda: [torch.cdist(q[m], rv, compute_mode="donot_use_mm_for_euclid_dist")
                   .topk(k, dim=1, largest=False) for q, m in zip(qs, qm)]
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(torch, lib, 1)
    nbytes = (32 + 8 * k) * qp.shape[0] + 4096 * nch + 4 * surv.numel()
    pairs = survivor_work(torch, qp, surv, ct, nch)
    pairs4 = survivor_work(torch, qp, surv4, ct, nch)
    bms, by = bound_of(KERNELS[name][1] * pairs, nbytes)
    b1024, _ = bound_of(KERNELS[name][1] * pairs4,
                        nbytes - 4 * surv.numel() + 4 * surv4.numel())
    fin = torch.isfinite(dp)
    rec = {"name": name, "route": "cuda",
           "source": "libpointmatcher_tpu_torch/csrc/sweep.cu",
           "replaces": KERNELS[name][0], "launches": launches,
           "max_abs_err": float((d[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
           "library_ms": None}
    log(f"[kernel] main path {name} k={k} {qp.shape[0]} query rows x {nch} "
        f"chunks, cdist+topk one call per lane x{qs.shape[0]}: {lib_ms:.2f} ms, "
        f"{pairs:.6g} pairs at the 256-query tiles against {pairs4:.6g} at the "
        f"1024-query fold (bound over those {b1024:.5f} ms); K2 (k={k}) here "
        f"{ms_k2:.4f} ms, prefilter {json.dumps(shares)}; lists "
        f"{json.dumps(list_stats(torch, qp, surv, ct, nch))}: " + json.dumps(rec))
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


def vtile_inputs(torch, tc, args):
    """A recorded parent-form step's per-tile inputs: its queries gathered
    per virtual tile ``[Bf·Tv, TQ, 8]`` (every query of the parent, masked
    or not) and the tables ``[Bf·Tv, 8, M]`` → (q, cand_t, dim), what K7's
    per-tile form, T4, T5 and the ``cdist`` yardstick take."""
    pts, qmask, q_rows, cand_t, ncols, vrows = args
    bf, tp, tq, tv, _, m = tc._parent_shape(*args)
    q, _ = tc._queries(pts, q_rows, tp)
    q = tc._by_parent(q, tc._parents_of(vrows, bf, tv))
    return q.reshape(bf * tv, tq, tc.DPAD), cand_t.reshape(bf * tv, tc.DPAD, m), \
        pts.shape[-1]


def record_tile_kernel(torch, tc, name, call, k, launches):
    """K7 (``k`` 0) or K8 in the parent form at a recorded main-path call
    ``(points, qmask, q_rows, cand_t, ncols, vrows, max_dist[, k])``
    against its plain version, timed beside it and a batched
    ``torch.cdist`` yardstick over the same virtual tiles → its kernel
    record. The bound and the issue floor count what the function needs
    (tools_torch/tile_micro.py ``stats`` and ``bounds``): its operations on
    the valid (live query, real candidate) pairs of each parent, and its
    bytes, each live query's coordinates and outputs and the dim + 2 rows of
    each live column of a parent with a live query."""
    from tools_torch import tile_micro as tm

    args, max_dist = call[:6], call[6]
    if k == 0:
        run = lambda: tc.tile_sweep_parents(*args, max_dist)
        plain = lambda: tc.tile_sweep_parents_plain(*args, max_dist)
    else:
        run = lambda: tc.tile_sweep_k_parents(*args, max_dist, k)
        plain = lambda: tc.tile_sweep_k_parents_plain(*args, max_dist, k)
    d, i = run()
    dp, ip = plain()
    torch.cuda.synchronize()
    if not (torch.equal(d, dp) and torch.equal(i, ip)):
        raise AssertionError(f"{name}: kernel and plain version differ")
    ms = cuda_ms(torch, run, 20)
    plain_ms = cuda_ms(torch, plain, 2)
    q, cand_t, dim = vtile_inputs(torch, tc, args)
    pen = cand_t[:, 6]
    qq = q[..., :dim].contiguous()
    cc = cand_t[:, :dim].transpose(1, 2).contiguous()
    del q

    def lib():
        dist = torch.cdist(qq, cc, compute_mode="donot_use_mm_for_euclid_dist")
        d2 = dist * dist + pen[:, None, :]
        return d2.min(dim=2) if k == 0 else d2.topk(k, dim=2, largest=False)

    torch.cuda.empty_cache()
    try:
        library_ms = cuda_ms(torch, lib, 2)
    except RuntimeError as e:          # a batch cdist's grid may refuse it
        log(f"[kernel] {name}: batched cdist refused: {e}")
        library_ms = None
    del qq, cc, pen
    torch.cuda.empty_cache()
    st = tm.stats({"kernel": name[:2], "k": k, "args": args})
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    b = tm.bounds(st, sms, tm._sm_clock_hz())
    fin = torch.isfinite(dp)
    rec = {"name": name, "route": "cuda",
           "source": "libpointmatcher_tpu_torch/csrc/tile.cu",
           "replaces": KERNELS[name][0], "launches": launches,
           "max_abs_err": float((d[fin] - dp[fin]).abs().max()) if bool(fin.any()) else 0.0,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
           "bound_by": b["bound_by"], "library_ms": library_ms}
    log(f"[kernel] main path {name}{'' if k == 0 else f' k={k}'}: "
        f"{json.dumps(st)}, issue floor {b['issue_floor_ms']:.4f} ms: "
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
    """Phases 13-16 → (the K7 and K8 kernel records, K7's recorded call)."""
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
            rk = stack.enter_context(InputRecorder(tilesweep, "tile_sweep_k_parents",
                                                   keep=1))
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
            pts_c, mask_c = rs.calls[0][:2]
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
            k8_launches = counts["K8"]
            k8_call = rk.calls[0]
        del rk, rs
        # ---- 14. / 16. the batch of 8 scans
        register_batch_to_map(seq, clouds, seed=1)      # warm-up
        with ExitStack() as stack:
            r7 = stack.enter_context(InputRecorder(tilesweep, "tile_sweep_parents",
                                                   keep=2))
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
            k7_call = r7.calls[1]
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
    records.append(record_tile_kernel(torch, tc, "K7 tile_sweep", k7_call, 0,
                                      k7_launches))
    records.append(record_tile_kernel(torch, tc, "K8 tile_sweep_k", k8_call,
                                      k8_call[7], k8_launches))
    return records, k7_call


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
    _, _, work = k10_work(torch, qa, ra, amin, label)
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
        f"error constant {c_eff:.4f}, K10's swept share "
        f"{work['swept_share']:.5f} of {work['dense_pairs']} pairs "
        f"({work['swept_chunks']} (warp, chunk) sweeps, {work['few_sweeps']} "
        f"of them lane by lane, {work['lane_tests']} lane tests, "
        f"{work['formed_pairs']} pairs formed, chunks swept "
        f"a warp {work['per_warp']}); K10 and K11 equal "
        f"their plain versions and K10 its emulated schedule")
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
    amin = skc.approx_min_sorted(qa, ra)
    k10_ops, k10_bytes, work = k10_work(torch, qa, ra, amin, "K10's record")
    amin = amin[:, :n]
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
        # the pruned work of its emulation at these inputs
        ("K10 approx_min_sorted", lambda: skc.approx_min_sorted(qa, ra),
         lambda: skc.approx_min_sorted_plain(qa, ra), k10_lib, k10_ops, k10_bytes),
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
            if name.startswith("K10"):
                dense, _ = bound_of(KERNELS[name][1] * nq * mv, 24 * nq + 20 * mv)
                what = (f"{work['box_tests']} (warp, chunk) box tests, "
                        f"{work['lane_tests']} (query, chunk) lane tests, "
                        f"chunks swept a warp {work['per_warp']}, "
                        f"{work['swept_pairs']} (query, column) pairs needed "
                        f"(share {work['swept_share']:.5f}), "
                        f"{work['formed_pairs']} formed, brute-force bound "
                        f"{dense:.4f} ms")
            else:
                what = (f"skipped share {float(flags.float().mean()):.4f}, "
                        f"{pairs:.0f} pairs swept")
            log(f"[kernel] main path {name} {b} x {n} query rows ({nq:.0f} valid) "
                f"x {rt.shape[1]} map columns ({mv:.0f} valid), {what}, "
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
    # the same scans and map translated by 10^3 m, where the expansion form
    # cancels hardest (its effective constant is logged, not gated)
    far = torch.tensor([1.0e3, -0.7e3, 0.3e3], device="cuda")
    ftab = tuple(x + far if j in (2, 5) else x for j, x in enumerate(tab))
    fvt = v1_tables(torch, skip, ftab)
    _, c_far = check_v1_step(torch, kc, skc, skip, qs + far, qm, ub2, fvt, ftab,
                             "cold, 10^3 m")
    del fvt, ftab
    c_eff = max(c_cold, c_warm)
    headroom = skip.BOUND_ERR_C / c_eff if c_eff > 0 else float("inf")
    log(f"[v1] K10's effective error constant {c_eff:.4f} against BOUND_ERR_C "
        f"{skip.BOUND_ERR_C}: headroom {headroom:.2f}x (at 10^3 m: {c_far:.4f})")
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
    """(ms, calls) of ``torch.cdist`` + ``amin`` over the tiles (pen added),
    T4's and T5's function: one batched call, or, where cdist's grid
    refuses the shape (logged), the same call over chunks of tiles of at
    most 2^28 distances each; (None, 0) where that is refused too."""
    pen = cand_t[:, 6]
    qq = q[..., :dim].contiguous()
    cc = cand_t[:, :dim].transpose(1, 2).contiguous()

    def lib(t0=0, t1=None):
        dist = torch.cdist(qq[t0:t1], cc[t0:t1],
                           compute_mode="donot_use_mm_for_euclid_dist")
        return dist.square_().add_(pen[t0:t1, None, :]).amin(dim=2)

    tiles = q.shape[0]
    step = max(1, (1 << 28) // max(1, q.shape[1] * cand_t.shape[2]))
    chunks = [(t, t + step) for t in range(0, tiles, step)]
    torch.cuda.empty_cache()
    try:
        try:
            return cuda_ms(torch, lib, 1), 1
        except RuntimeError as e:      # a batch cdist's grid may refuse it
            log(f"[kernel] {label}: batched cdist refused at {tuple(q.shape)} x "
                f"{tuple(cand_t.shape)}: {e}; timing it over {len(chunks)} "
                f"calls of {step} tiles")
        torch.cuda.empty_cache()
        return cuda_ms(torch, lambda: [lib(*c) for c in chunks], 1), len(chunks)
    except RuntimeError as e:
        log(f"[kernel] {label}: chunked cdist refused too: {e}")
        return None, 0
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
    library_ms, calls = cdist_min_ms(torch, q, cand_t, dim, name)
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
        f"inputs {k7_ms:.4f} ms, the yardstick in {calls} cdist calls: "
        + json.dumps(rec))
    return rec


def tile_ablations(torch, tc, k7_call):
    """Phase 19 → the T4 and T5 kernel records (at the tool's shape)."""
    from tools_torch import tile_kernel_micro as tkm

    q7, cand7, dim7 = vtile_inputs(torch, tc, k7_call[:6])
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
    times["cdist + amin"], times["cdist calls"] = cdist_min_ms(
        torch, q7, cand7, dim7, "K7's inputs")
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
    sms = kc._sms(tool_inputs[0].device)
    log(f"[variants] reference chunks (splits, chunk) at the tool's shape: T2 "
        f"{kv.t2_split(knn_micro.N, knn_micro.M, sms)}, T3 "
        f"{kv.t3_split(knn_micro.N, knn_micro.M, sms)}")
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


def loop_chains(torch, pt, world, poses, scans, k3, launches, rng):
    """Phase 21: the loop modules on the card (tools_torch/loop_modules.py)
    at a recorded step of the K1 sequence and of a knn = 3 one (K5), held to
    the same modules on the CPU, then the YAML chains of the new modules
    beside the default chain: ``ICPSequence.compute`` of 2 scans on the
    phase-4 map (dense K1), ``register_batch_to_map`` of the 8 scans of
    phase 7 on the ~30 000-row map (K2 + K3), and the Robust chain through
    ``register_queue_to_map`` (16 scans, 8 lanes) there; every pose under
    the gates, the launches following each route, ``get_covariance``
    finite, symmetric and positive semi-definite."""
    from tools_torch import loop_modules as lm

    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    # ---- 21a. every module at a recorded step, card against CPU
    steps = {}
    for knn in (1, 3):
        seq = pt.ICPSequence()
        seq.load_from_yaml(lm.chain_yaml("cov_median_normal", knn=knn))
        seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        reset_launch_counts()
        T_init = perturb(rng) @ poses[1]
        steps[knn] = lm.record_step(lambda: seq.compute(
            pt.PointCloud.from_numpy(scans[1]), T_init=T_init, seed=1))
        counts = launches()
        if (knn == 1 and counts["K1"] == 0) or (knn == 3 and counts["K5"] == 0):
            raise AssertionError(f"knn={knn} step: launches {counts}")
        log(f"[modules] knn={knn} step recorded: {steps[knn][2].dists.shape[0]} "
            f"reading rows against {steps[knn][1].num_points} map rows, "
            f"launches {counts}")
    for knn, step in steps.items():
        lm.check_modules(*step, f"knn={knn}", log=log)
    del steps
    torch.cuda.empty_cache()

    # ---- 21b. the chains: sequence on the dense map, batch and queue on K3
    for name in lm.CHAINS:
        text = lm.chain_yaml(name)
        seq = pt.ICPSequence()
        seq.load_from_yaml(text)
        seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        reset_launch_counts()
        iters, ms = 0, 0.0
        for i in (1, 2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            T = seq.compute(pt.PointCloud.from_numpy(scans[i]),
                            T_init=perturb(rng) @ poses[i], seed=i).cpu().numpy()
            ms += 1e3 * (time.perf_counter() - t)
            iters += seq.last_iteration_count
            gates([T], [poses[i]], f"{name} sequence")
        counts = launches()
        if counts["K1"] != iters:
            raise AssertionError(f"{name} sequence: K1 launches {counts['K1']}, "
                                 f"iterations {iters}")
        row = {"sequence_iterations": iters,
               "sequence_ms_per_iteration": round(ms / iters, 3),
               "sequence_launches": {k: v for k, v in counts.items() if v}}
        if seq.error_minimizer.PRODUCES_COVARIANCE:
            cov = seq.get_covariance().astype(np.float64)
            scale = np.abs(cov).max()
            low = float(np.linalg.eigvalsh(0.5 * (cov + cov.T)).min())
            asym = float(np.abs(cov - cov.T).max())
            log(f"[chains] {name}: covariance diagonal "
                f"{np.round(np.diag(cov), 10).tolist()}, asymmetry {asym:.3g}, "
                f"lowest eigenvalue {low:.3g} (largest entry {scale:.3g})")
            if not (np.isfinite(cov).all() and asym <= 1e-5 * scale
                    and low >= -1e-5 * scale):
                raise AssertionError(f"{name}: covariance not symmetric PSD")

        b_seq = pt.ICPSequence()
        b_seq.load_from_yaml(text)
        b_seq.set_map(pt.PointCloud.from_numpy(k3["world"]), seed=0)
        clouds = [pt.PointCloud.from_numpy(x) for x in k3["scans"]]
        register_batch_to_map(b_seq, clouds, T_inits=k3["T_inits"], seed=1)
        torch.cuda.synchronize()
        reset_launch_counts()
        t = time.perf_counter()
        T, info = register_batch_to_map(b_seq, clouds, T_inits=k3["T_inits"],
                                        seed=1)
        ms = 1e3 * (time.perf_counter() - t)
        counts = launches()
        it = int(info["iterations"].max())
        gates(T, k3["poses"], f"{name} batch")
        if (counts["K2"], counts["K3"], counts["K1"]) != (it, it, 0):
            raise AssertionError(f"{name} batch: launches {counts}, lockstep "
                                 f"iterations {it}")
        row.update(batch_iterations=info["iterations"].tolist(),
                   batch_ms=round(ms, 2), batch_ms_per_iteration=round(ms / it, 3),
                   batch_launches={k: v for k, v in counts.items() if v})
        if name == "p2plane_robust":
            n_q = 2 * QUEUE_LANES
            reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            T, info = register_queue_to_map(
                b_seq, k3["qclouds"][:n_q], T_inits=k3["qinits"][:n_q], seed=1,
                lanes=QUEUE_LANES)
            ms = 1e3 * (time.perf_counter() - t)
            counts = launches()
            gates(T, k3["qposes"][:n_q], f"{name} queue")
            if counts["K2"] != counts["K3"] or counts["K2"] == 0 or counts["K1"]:
                raise AssertionError(f"{name} queue: launches {counts}")
            row.update(queue_scans=n_q, queue_ms=round(ms, 2),
                       queue_ms_per_lane_iteration=round(ms / counts["K3"], 3),
                       queue_launches={k: v for k, v in counts.items() if v})
        log(f"[chains] {name}: " + json.dumps(row))
        del seq, b_seq
        torch.cuda.empty_cache()


ENGINE_STATS = ("ReferencePreprocessingDuration", "ReferenceInPointCount",
                "ReferencePointCount", "ReadingPreprocessingDuration",
                "ReadingInPointCount", "ReadingPointCount", "IterationsCount",
                "PointCountTouched", "OverlapRatio", "ConvergenceDuration")
FIXSTEP = {"startStep": "4", "endStep": "1", "stepMult": "0.5"}


def engine_features(torch, pt, world, poses, scans, k3, launches, smi, rng):
    """Phase 22: the reading step filters and the stepped driver, Anderson
    acceleration, the inspectors with the engine's statistics and visit
    counts, the loggers and the overlap estimate, on scenes of phases 4, 7,
    11 and 13 (see the module docstring)."""
    import tempfile

    from libpointmatcher_tpu_torch import icp as icp_mod
    from libpointmatcher_tpu_torch import loggers
    from libpointmatcher_tpu_torch.checkers import CounterTransformationChecker
    from libpointmatcher_tpu_torch.filters import (
        FixStepSamplingDataPointsFilter, RandomSamplingDataPointsFilter,
        SimpleSensorNoiseDataPointsFilter)
    from libpointmatcher_tpu_torch.inspectors import (PerformanceInspector,
                                                      VTKFileInspector)
    from libpointmatcher_tpu_torch.matchers import Matches
    from libpointmatcher_tpu_torch.minimizers import estimate_overlap
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)
    from libpointmatcher_tpu_torch.parallel.stream import queue_eligible

    rows = {}

    def record(label, ms, iters, **extra):
        rows[label] = dict(ms=round(ms, 2), iterations=iters,
                           ms_per_iteration=round(ms / max(iters, 1), 3), **extra)
        log(f"[engine] {label}: " + json.dumps(rows[label]))

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    # ---- 22a. step filters on the sequence (K1, phase 4's map)
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    inits = {i: perturb(rng) @ poses[i] for i in (1, 2)}

    def run_sequence(label):
        # one untimed registration first: a chain's first call on the card
        # loads the kernels of operations it has not run before
        seq.compute(pt.PointCloud.from_numpy(scans[1]), T_init=inits[1], seed=1)
        reset_launch_counts()
        out, iters, ms = [], [], 0.0
        for i in (1, 2):
            T, t_ms = timed(lambda: seq.compute(pt.PointCloud.from_numpy(scans[i]),
                                                T_init=inits[i], seed=i))
            out.append(T.cpu().numpy())
            iters.append(seq.last_iteration_count)
            ms += t_ms
        counts = launches()
        if counts["K1"] != sum(iters) or counts["K2"] or counts["K5"]:
            raise AssertionError(f"{label}: launches {counts}, iterations {iters}")
        gates(out, [poses[1], poses[2]], label)
        record(label, ms, sum(iters), per_scan=iters)
        return np.stack(out), iters

    _, it_plain_seq = run_sequence("sequence plain")
    seq.reading_step_filters = [FixStepSamplingDataPointsFilter(FIXSTEP)]
    T_fix, it_fix = run_sequence("sequence FixStep in the loop")
    seq._step_chain_traced = lambda: False
    try:
        T_st, it_st = run_sequence("sequence FixStep, stepped driver")
    finally:
        del seq._step_chain_traced
    if it_st != it_fix or not np.allclose(T_st, T_fix, atol=1e-5, rtol=0):
        raise AssertionError(f"stepped FixStep: iterations {it_st} vs {it_fix}, "
                             f"pose difference {np.abs(T_st - T_fix).max()}")
    log(f"[engine] FixStep stepped vs in the loop: iterations {it_st}, pose "
        f"difference {float(np.abs(T_st - T_fix).max()):.3g}")
    seq.reading_step_filters = [RandomSamplingDataPointsFilter({"prob": "0.5"})]
    run_sequence("sequence RandomSampling step, stepped driver")

    # ---- 22b. Anderson on the sequence
    seq.reading_step_filters = []
    seq.acceleration = "anderson"
    _, it_aa_seq = run_sequence("sequence Anderson")
    seq.acceleration = None
    log(f"[engine] sequence iterations: plain {sum(it_plain_seq)}, Anderson "
        f"{sum(it_aa_seq)}")

    # ---- 22a/b. the batch (K2 + K3, phase 7's scans) and the queue (16 scans)
    b_seq = pt.ICPSequence()
    b_seq.set_default()
    b_seq.set_map(pt.PointCloud.from_numpy(k3["world"]), seed=0)
    clouds = [pt.PointCloud.from_numpy(x) for x in k3["scans"]]
    n_q = 2 * QUEUE_LANES
    qclouds, qinits, qposes = (k3["qclouds"][:n_q], k3["qinits"][:n_q],
                               k3["qposes"][:n_q])

    def run_batch(label, cl, ini, ps, queue=False):
        fn = register_queue_to_map if queue else register_batch_to_map
        kw = {"lanes": QUEUE_LANES} if queue else {}
        fn(b_seq, cl, T_inits=ini, seed=1, **kw)          # untimed, as above
        reset_launch_counts()
        (T, info), ms = timed(lambda: fn(b_seq, cl, T_inits=ini, seed=1, **kw))
        counts = launches()
        it = int(info["iterations"].max())
        gates(T, ps, label)
        # one K2 and one K3 launch a lockstep iteration, or a lane iteration
        # of a queue that serves the chain itself
        want = (counts["K3"],) * 2 if queue and queue_eligible(b_seq) else (it, it)
        if (counts["K2"], counts["K3"]) != want or counts["K3"] == 0 or counts["K1"]:
            raise AssertionError(f"{label}: launches {counts}, lockstep "
                                 f"iterations {it}")
        record(label, ms, int(counts["K3"]), per_scan=info["iterations"].tolist())
        return T, info

    T_b8, i_b8 = run_batch("batch plain", clouds, k3["T_inits"], k3["poses"])
    b_seq.reading_step_filters = [FixStepSamplingDataPointsFilter(FIXSTEP)]
    run_batch("batch FixStep", clouds, k3["T_inits"], k3["poses"])
    Tb, ib = run_batch("batch of 16 FixStep", qclouds, qinits, qposes)
    if not queue_eligible(b_seq):
        raise AssertionError("a FixStep chain must stay in the queue")
    Tq, iq = run_batch("queue of 16 FixStep", qclouds, qinits, qposes, queue=True)
    if not (np.array_equal(iq["iterations"], ib["iterations"])
            and np.allclose(Tq, Tb, atol=1e-5, rtol=0)):
        raise AssertionError(f"FixStep queue {iq['iterations']} vs batch "
                             f"{ib['iterations']}, pose difference "
                             f"{np.abs(Tq - Tb).max()}")
    log(f"[engine] FixStep queue vs batch of 16: iterations equal, pose "
        f"difference {float(np.abs(Tq - Tb).max()):.3g}")
    b_seq.reading_step_filters = []
    b_seq.acceleration = "anderson"
    _, i_aa8 = run_batch("batch Anderson", clouds, k3["T_inits"], k3["poses"])
    log(f"[engine] batch iterations summed over scans: plain "
        f"{int(i_b8['iterations'].sum())}, Anderson {int(i_aa8['iterations'].sum())}")
    if queue_eligible(b_seq):
        raise AssertionError("an accelerated chain must not enter the queue")
    Tb, ib = run_batch("batch of 16 Anderson", qclouds, qinits, qposes)
    Tq, iq = run_batch("queue of 16 Anderson (as a batch)", qclouds, qinits,
                       qposes, queue=True)
    if not (np.array_equal(Tq, Tb) and np.array_equal(iq["iterations"],
                                                      ib["iterations"])):
        raise AssertionError("the accelerated queue differs from the batch")
    del b_seq, clouds
    torch.cuda.empty_cache()

    # ---- 22b. Anderson at a fixed budget, card against CPU
    sub_map = world[rng.choice(len(world), min(12000, len(world)), replace=False)]
    sub_scan = scans[1][rng.choice(len(scans[1]), min(4000, len(scans[1])),
                                   replace=False)]
    T0 = perturb(rng) @ poses[1]
    fixed = {}
    for dev in ("cuda", "cpu"):
        s = pt.ICPSequence(device=dev)
        s.set_default()
        s.acceleration = "anderson"
        s.checkers = [CounterTransformationChecker({"maxIterationCount": "10"})]
        s.set_map(pt.PointCloud.from_numpy(sub_map, device=dev), seed=0)
        fixed[dev] = s.compute(pt.PointCloud.from_numpy(sub_scan, device=dev),
                               T_init=T0, seed=1).cpu().numpy()
    err = float(np.abs(fixed["cuda"] - fixed["cpu"]).max())
    log(f"[engine] Anderson at 10 iterations, card against CPU: pose "
        f"difference {err:.3g}")
    if not err <= 1e-5:
        raise AssertionError(f"Anderson card pose differs from the CPU's by {err}")

    # ---- 22c. inspectors, statistics, loggers (K1, one-shot)
    gT = np.linalg.inv(poses[0]) @ poses[1]
    T_pair = perturb(rng) @ gT
    icp = pt.ICP()
    icp.set_default()

    def one_shot():
        return icp.compute(pt.PointCloud.from_numpy(scans[1]),
                           pt.PointCloud.from_numpy(scans[0]), T_init=T_pair,
                           seed=1).cpu().numpy()

    one_shot()                                    # untimed, as above
    _, ms = timed(one_shot)
    record("one-shot NullInspector", ms, icp.last_iteration_count)
    icp.inspector = PerformanceInspector()
    tmp = tempfile.mkdtemp(prefix="pm_engine_")
    info_path = os.path.join(tmp, "info.txt")
    saved = loggers.get_logger()
    file_logger = loggers.FileLogger({"infoFileName": info_path})
    loggers.set_logger(file_logger)
    try:
        reset_launch_counts()
        T, ms = timed(one_shot)
    finally:
        loggers.set_logger(saved)
        file_logger.close()
    iters = icp.last_iteration_count
    gates([T], [gT], "one-shot PerformanceInspector")
    stats = icp.inspector.histograms
    touched = stats["PointCountTouched"].values
    want = [iters * icp.prefiltered_reading_pts_count
            * icp.prefiltered_reference_pts_count]
    if tuple(stats) != ENGINE_STATS or touched != want:
        raise AssertionError(f"statistics {list(stats)}, touched {touched} vs {want}")
    if launches()["K1"] != iters:
        raise AssertionError(f"PerformanceInspector run: launches {launches()}")
    with open(info_path) as f:
        text = f.read()
    if f"PointMatcher::icp - {iters} iterations took" not in text:
        raise AssertionError(f"FileLogger holds no engine line: {text!r}")
    record("one-shot PerformanceInspector", ms, iters,
           stats={k: stats[k].values[0] for k in ENGINE_STATS})

    icp.inspector = VTKFileInspector({
        "baseFileName": os.path.join(tmp, "run"), "dumpReading": "1",
        "dumpDataLinks": "1", "writeBinary": "1"})
    reset_launch_counts()
    _, ms = timed(one_shot)
    iters = icp.last_iteration_count
    files = {role: [f for f in os.listdir(tmp) if f.startswith(f"run-{role}-")]
             for role in ("reading", "link")}
    if (any(len(v) != iters for v in files.values())
            or launches()["K1"] != iters):
        raise AssertionError(f"VTKFileInspector: {iters} iterations, files "
                             f"{ {k: len(v) for k, v in files.items()} }, "
                             f"launches {launches()}")
    record("one-shot VTKFileInspector (stepped driver, binary dumps)", ms, iters,
           bytes_per_iteration=sum(os.path.getsize(os.path.join(tmp, f))
                                   for v in files.values() for f in v) // iters)

    # ---- 22c. the tile route's touched pairs (K7, phase 13's terrain)
    t_rng = np.random.default_rng(7)
    map_pts, side = make_terrain(TERRAIN_MAPS[0], t_rng)
    t_scans, t_poses = make_terrain_scans(map_pts, side, t_rng)
    tseq = terrain_sequence(pt)
    tseq.set_map(pt.PointCloud.from_numpy(map_pts), seed=0)
    t_clouds = [pt.PointCloud.from_numpy(x) for x in t_scans]
    reset_launch_counts()
    (T, info), ms = timed(lambda: register_batch_to_map(tseq, t_clouds, seed=1))
    it = int(info["iterations"].max())
    gates(T, t_poses, "tile batch")
    per_scan = tseq.matcher.touched_per_scan
    dense = (sum(c.num_points for c in t_clouds)
             * tseq.prefiltered_reference_pts_count)
    if (tc.tile_sweep.launches != it or len(per_scan) != len(t_clouds)
            or tseq.matcher.touched_per_iteration(None, None) != sum(per_scan)
            or not 0 < sum(per_scan) < dense):
        raise AssertionError(f"tile batch: K7 {tc.tile_sweep.launches} "
                             f"(iterations {it}), touched {per_scan}")
    record("tile batch", ms, it, touched_per_scan=per_scan,
           dense_pairs=dense)
    del tseq, t_clouds
    torch.cuda.empty_cache()

    # ---- 22d. the overlap estimate at the final matches, card against CPU
    icp.inspector = PerformanceInspector()
    icp.reading_filters = [RandomSamplingDataPointsFilter(),
                           SimpleSensorNoiseDataPointsFilter({"sensorType": "0"})]
    calls = []
    orig = icp_mod.estimate_overlap
    icp_mod.estimate_overlap = lambda *a: calls.append(a) or orig(*a)
    try:
        T = one_shot()
    finally:
        icp_mod.estimate_overlap = orig
    gates([T], [gT], "one-shot SimpleSensorNoise")
    rd, rf, w, m, wr = calls[0]
    cpu = float(estimate_overlap(rd.to("cpu"), rf.to("cpu"), w.cpu(),
                                 Matches(m.dists.cpu(), m.ids.cpu()), wr.cpu()))
    n_pairs = int((torch.isfinite(m.dists) & (w != 0)).sum())
    card = icp.get_overlap()
    log(f"[engine] overlap: card {card!r}, CPU {cpu!r} over {n_pairs} pairs")
    if not abs(card - cpu) <= 1.0 / n_pairs or icp.inspector.histograms[
            "OverlapRatio"].values != [card]:
        raise AssertionError(f"overlap on the card {card}, on the CPU {cpu}")
    log(f"[engine] {smi}: " + json.dumps(
        {k: v["ms_per_iteration"] for k, v in rows.items()}))


# ------------------------------------------------------------ data filters
#: the sensor's reading chain of phase 23 (BoundingBox around the sensor's
#: own body, range gates, then the draw)
SENSOR_CHAIN = [
    ("BoundingBoxDataPointsFilter", {"xMin": "-0.5", "xMax": "0.5", "yMin": "-0.5",
                                     "yMax": "0.5", "zMin": "-0.5", "zMax": "0.5",
                                     "removeInside": "1"}),
    ("MaxDistDataPointsFilter", {"dim": "-1", "maxDist": "12"}),
    ("MinDistDataPointsFilter", {"dim": "-1", "minDist": "0.3"}),
    ("RandomSamplingDataPointsFilter", {"prob": "0.5"}),
]
#: align_sequence.cpp:140-144's map maintenance
MAINTENANCE = [
    ("SurfaceNormalDataPointsFilter", {"knn": "10", "epsilon": "5",
                                       "keepDensities": "1"}),
    ("MaxDensityDataPointsFilter", {"maxDensity": "30"}),
]
OCTREE_NODE = "32"


def chain_yaml(reading=None, reference=None):
    """The default chain's YAML with other reading or reference filters,
    each a list of (name, parameters)."""
    def section(name, filters):
        lines = [f"{name}:"]
        for f, params in filters:
            lines.append(f"  - {f}:" if params else f"  - {f}")
            lines += [f"      {k}: {v}" for k, v in params.items()]
        return "\n".join(lines)

    reading = reading or [("RandomSamplingDataPointsFilter", {})]
    reference = reference or [("SamplingSurfaceNormalDataPointsFilter", {})]
    return "\n".join([section("readingDataPointsFilters", reading),
                      section("referenceDataPointsFilters", reference),
                      "matcher: KDTreeMatcher",
                      "outlierFilters:\n  - TrimmedDistOutlierFilter",
                      "errorMinimizer: PointToPlaneErrorMinimizer",
                      "transformationCheckers:\n  - CounterTransformationChecker"
                      "\n  - DifferentialTransformationChecker", ""])


def sensor_at(world):
    """A sensor 1.3 m above the floor of a room scene, off its centre so
    that it lies in none of its walls' planes (Shadow removes a wall seen
    edge-on)."""
    lo, hi = world.min(0), world.max(0)
    return np.r_[lo[:2] + np.array([0.3, 0.45]) * (hi[:2] - lo[:2]), lo[2] + 1.3]


def descriptor_chain(center):
    """The reference descriptor chain of phase 23, the sensor at ``center``."""
    x, y, z = (f"{float(v):.3f}" for v in center)
    return [("VoxelGridDataPointsFilter", {"vSizeX": "0.05", "vSizeY": "0.05",
                                           "vSizeZ": "0.05"}),
            ("SurfaceNormalDataPointsFilter", {"knn": "10", "keepEigenValues": "1"}),
            ("ObservationDirectionDataPointsFilter", {"x": x, "y": y, "z": z}),
            ("OrientNormalsDataPointsFilter", {}),
            ("IncidenceAngleDataPointsFilter", {}),
            ("ShadowDataPointsFilter", {"eps": "0.1"}),
            ("SphericalityDataPointsFilter", {}),
            ("CutAtDescriptorThresholdDataPointsFilter",
             {"descName": "sphericality", "threshold": "0.9"})]


def filter_chains(torch, pt, world, poses, scans, k3, launches, smi, rng):
    """Phase 23: the data filters on the card (see the module docstring):
    the map maintenance, the sensor chain's batch and queue, the descriptor
    chain and an Elipsoids map, each through the engines and under the
    gates, then every new filter once at 100 000 rows, timed and held to
    the CPU on the same input (tools_torch/filter_checks.py)."""
    from tools_torch import filter_checks as fc

    from libpointmatcher_tpu_torch.filters import apply_filter_chain
    from libpointmatcher_tpu_torch.filters.base import DataPointsFilterRegistrar
    from libpointmatcher_tpu_torch.icp import REFERENCE_STREAM, chain_key
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)
    from libpointmatcher_tpu_torch.parallel.stream import queue_eligible
    from libpointmatcher_tpu_torch.utils import prng

    create = DataPointsFilterRegistrar.create

    def counts():
        c = dict(launches(), K8=tc.tile_sweep_k.launches)
        return {k: v for k, v in c.items() if v}

    def set_map(seq, cloud, label):
        """``set_map`` with the chain's launches logged."""
        reset_launch_counts()
        seq.set_map(cloud, seed=0)
        log(f"[filters] {label}: set_map {cloud.num_points} -> "
            f"{seq.prefiltered_reference_pts_count} rows, launches {counts()}")

    def sequence(seq, idx, scene_scans, scene_poses, label):
        """``compute`` of the scans ``idx`` after one untimed call, under
        the gates, one K1 launch an iteration."""
        inits = {i: perturb(rng) @ scene_poses[i] for i in idx}
        seq.compute(pt.PointCloud.from_numpy(scene_scans[idx[0]]),
                    T_init=inits[idx[0]], seed=idx[0])
        reset_launch_counts()
        out, iters, ms = [], 0, 0.0
        for i in idx:
            torch.cuda.synchronize()
            t = time.perf_counter()
            T = seq.compute(pt.PointCloud.from_numpy(scene_scans[i]),
                            T_init=inits[i], seed=i).cpu().numpy()
            ms += 1e3 * (time.perf_counter() - t)
            out.append(T)
            iters += seq.last_iteration_count
        c = counts()
        gates(out, [scene_poses[i] for i in idx], label)
        if c.get("K1", 0) != iters:
            raise AssertionError(f"{label}: launches {c}, iterations {iters}")
        log(f"[filters] {label}: " + json.dumps(
            {"map_rows": seq.prefiltered_reference_pts_count, "iterations": iters,
             "ms_per_iteration": round(ms / iters, 3), "launches": c}))

    # ---- 23a. map maintenance (align_sequence.cpp:140-144), K8 + K5 then K1
    world_cloud = pt.PointCloud.from_numpy(world)
    reset_launch_counts()
    thinned = apply_filter_chain([create(n, p) for n, p in MAINTENANCE],
                                 world_cloud, chain_key(0, REFERENCE_STREAM))
    c = counts()
    if not c.get("K8"):
        raise AssertionError(f"SurfaceNormal at {len(world)} rows: launches {c}")
    max_count = thinned.count_host() // 2
    log(f"[filters] maintenance: {len(world)} rows, MaxDensity(30) leaves "
        f"{thinned.count_host()}, MaxPointCount keeps {max_count}; "
        f"SurfaceNormal launches {c}")
    seq = pt.ICPSequence()
    seq.load_from_yaml(chain_yaml(reference=MAINTENANCE + [
        ("MaxPointCountDataPointsFilter", {"seed": "0", "maxCount": str(max_count)})]))
    set_map(seq, world_cloud, "maintenance chain")
    if seq.prefiltered_reference_pts_count != max_count:
        raise AssertionError(f"maintained map has {seq.prefiltered_reference_pts_count}"
                             f" rows, expected {max_count}")
    sequence(seq, (1, 2), scans, poses, "maintained map, sequence")
    del seq, thinned
    torch.cuda.empty_cache()

    # ---- 23b. the sensor chain: batch of 8 and queue of 16 on K2 + K3
    b_seq = pt.ICPSequence()
    b_seq.load_from_yaml(chain_yaml(reading=SENSOR_CHAIN))
    set_map(b_seq, pt.PointCloud.from_numpy(k3["world"]), "sensor chain's map")
    if not queue_eligible(b_seq):
        raise AssertionError("the sensor chain is not served by the queue")
    clouds = [pt.PointCloud.from_numpy(x) for x in k3["scans"]]
    n_q = 2 * QUEUE_LANES
    q_clouds, q_inits, q_poses = (k3["qclouds"][:n_q], k3["qinits"][:n_q],
                                  k3["qposes"][:n_q])
    for label, fn, cl, ini, ps, kw in (
            ("sensor chain, batch of 8", register_batch_to_map, clouds,
             k3["T_inits"], k3["poses"], {}),
            ("sensor chain, queue of 16", register_queue_to_map, q_clouds, q_inits,
             q_poses, {"lanes": QUEUE_LANES})):
        fn(b_seq, cl, T_inits=ini, seed=1, **kw)              # untimed
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        T, info = fn(b_seq, cl, T_inits=ini, seed=1, **kw)
        ms = 1e3 * (time.perf_counter() - t)
        c = counts()
        gates(T, ps, label)
        it = int(info["iterations"].max())
        queue = fn is register_queue_to_map
        # one K2 and one K3 launch a lockstep iteration, or a lane iteration
        if (not c.get("K3") or c.get("K2") != c.get("K3") or c.get("K1")
                or (not queue and c["K3"] != it)):
            raise AssertionError(f"{label}: launches {c}, iterations {it}")
        log(f"[filters] {label}: " + json.dumps(
            {"ms": round(ms, 2), "iterations": info["iterations"].tolist(),
             "ms_per_iteration": round(ms / c["K3"], 3), "launches": c}))
        if queue:
            Tb, ib = register_batch_to_map(b_seq, cl, T_inits=ini, seed=1)
            diff = float(np.abs(Tb - T).max())
            if (not np.array_equal(ib["iterations"], info["iterations"])
                    or not np.array_equal(ib["codes"], info["codes"])
                    or diff > 1e-5):
                raise AssertionError(f"sensor queue against its batch: iterations "
                                     f"{info['iterations']} / {ib['iterations']}, "
                                     f"pose difference {diff}")
            log(f"[filters] sensor chain: the queue gives the batch's iterations, "
                f"pose difference {diff:.3g}")
    del b_seq
    torch.cuda.empty_cache()

    # ---- 23c. the descriptor chain as a map's chain (K5 below 60 000 rows)
    # the map in the frame of a sensor that saw it: Shadow reads the view
    # ray from the origin
    shift = np.eye(4)
    shift[:3, 3] = -sensor_at(k3["world"])
    d_seq = pt.ICPSequence()
    d_seq.load_from_yaml(chain_yaml(reference=descriptor_chain(np.zeros(3))))
    set_map(d_seq, pt.PointCloud.from_numpy(k3["world"] + shift[:3, 3]),
            "descriptor chain")
    sequence(d_seq, (0, 1), k3["scans"], [shift @ P for P in k3["poses"]],
             "descriptor chain map, sequence")
    del d_seq

    # ---- 23d. an Elipsoids map
    e_seq = pt.ICPSequence()
    e_seq.load_from_yaml(chain_yaml(reference=[(
        "ElipsoidsDataPointsFilter", {"samplingMethod": "1"})]))
    set_map(e_seq, world_cloud, "Elipsoids chain")
    sequence(e_seq, (1, 2), scans, poses, "Elipsoids map, sequence")
    del e_seq
    torch.cuda.empty_cache()

    # ---- 23e. every new filter at 100 000 rows, card against CPU
    stamps = {"stamps": 1_700_000_000_000_000_000 + np.arange(len(world)) * 1000}
    base = pt.PointCloud.from_numpy(world, times=stamps)
    center = sensor_at(world)
    key = prng.fold_in(prng.prng_key(23), 1)
    table = {}

    def check(name, params, cloud, label=None, **tol):
        f = create(name, params)
        out, ms = fc.timed(torch, lambda: f.filter(cloud, key=key))
        ref = create(name, params).filter(cloud.to("cpu"), key=key)
        res = fc.compare(out, ref, **tol)
        table[label or name] = dict(card_ms=round(ms, 3), rows_in=cloud.count_host(),
                                    rows_out=out.count_host(), **res)
        log(f"[filters] {label or name}: " + json.dumps(table[label or name]))
        return out

    reset_launch_counts()
    sn, ms = fc.timed(torch, lambda: create(
        "SurfaceNormalDataPointsFilter", {"knn": "10", "epsilon": "5",
                                          "keepDensities": "1",
                                          "keepEigenValues": "1"}).filter(base))
    log(f"[filters] SurfaceNormal(knn 10) at {len(world)} rows: {ms:.3f} ms card, "
        f"launches over two calls {counts()}")
    for name, params in SENSOR_CHAIN[:3] + [
            ("IdentityDataPointsFilter", {}), ("RemoveNaNDataPointsFilter", {}),
            ("DistanceLimitDataPointsFilter", {"dim": "0", "dist": "7.0"}),
            ("MaxQuantileOnAxisDataPointsFilter", {"dim": "2", "ratio": "0.9"})]:
        check(name, params, base)
    md = check("MaxDensityDataPointsFilter", {"maxDensity": "30"}, sn)
    check("MaxPointCountDataPointsFilter",
          {"seed": "0", "maxCount": str(md.count_host() // 2)}, md)
    od = check("ObservationDirectionDataPointsFilter",
               dict(zip("xyz", (f"{v:.3f}" for v in center))), sn)
    check("OrientNormalsDataPointsFilter", {}, od)
    check("IncidenceAngleDataPointsFilter", {}, od)
    check("ShadowDataPointsFilter", {"eps": "0.1"}, od)
    sph = check("SphericalityDataPointsFilter",
                {"keepUnstructureness": "1", "keepStructureness": "1"}, sn)
    check("CutAtDescriptorThresholdDataPointsFilter",
          {"descName": "sphericality", "threshold": "0.9"}, sph)
    check("VoxelGridDataPointsFilter", {"vSizeX": "0.05", "vSizeY": "0.05",
                                        "vSizeZ": "0.05"}, sn)
    for method in range(4):
        check("OctreeGridDataPointsFilter",
              {"maxPointByNode": OCTREE_NODE, "samplingMethod": str(method)}, sn,
              f"OctreeGrid({OCTREE_NODE}, method {method})",
              kept_share=0.999 if method == 3 else 1.0)
    check("NormalSpaceDataPointsFilter", {"nbSample": "5000"}, sn)
    check("CovarianceSamplingDataPointsFilter", {"nbSample": "5000"}, sn,
          kept_share=0.99)
    for method in (0, 1):
        check("ElipsoidsDataPointsFilter",
              {"samplingMethod": str(method), "keepEigenValues": "1",
               "keepDensities": "1", "keepShapes": "1", "keepMeans": "1"}, base,
              f"Elipsoids(method {method})")
    check("GestaltDataPointsFilter", {"ratio": "0.1", "radius": "1",
                                      "keepEigenValues": "1"}, base)
    chain = apply_filter_chain([create(n, p) for n, p in descriptor_chain(center)],
                               base, key)
    check("RemoveSensorBiasDataPointsFilter", {}, chain,
          "RemoveSensorBias (descriptor chain's output)")
    log(f"[filters] card: {smi}")
    del base, sn, md, od, sph, chain
    torch.cuda.empty_cache()
    return table


#: phase 24's CellGridMatcher cell edge (its maxDist): covers the scans'
#: initial error (perturb's 0.08 m and 0.03 rad) over most of their rows
CELL_MAX_DIST = 0.5
#: phase 24's per-point search radii (KDTreeVarDistMatcher's maxSearchDist)
VAR_RADII = (0.3, 0.6)
#: phase 24's map rows for KDTreeVarDistMatcher's dense route (under its
#: CULL_MIN_MAP of 16 384 in the JAX package's 512-row granule)
VAR_DENSE_ROWS = 15_000
#: the saved variants of phase 24: (extension, binary)
IO_VARIANTS = (("csv", False), ("vtk", False), ("vtk", True), ("ply", False),
               ("ply", True), ("pcd", False), ("pcd", True))


def matcher_yaml(matcher, reference=None):
    """The default chain's YAML with another matcher (its YAML block)."""
    return chain_yaml(reference=reference).replace(
        "matcher: KDTreeMatcher", "matcher:\n  " + matcher.replace("\n", "\n  "))


def same_arrays(got, want, label):
    """``(points, descriptors, times)`` equal, NaN where NaN, times exact."""
    for a, b, part in zip(got, want, ("points", "descriptors", "times")):
        if isinstance(a, dict):
            if list(a) != list(b):
                raise AssertionError(f"{label}: {part} {list(a)}, expected {list(b)}")
            pairs = [(a[k], b[k], f"{part} {k}") for k in a]
        else:
            pairs = [(a, b, part)]
        for x, y, what in pairs:
            if x.shape != y.shape or not np.array_equal(x, y, equal_nan=x.dtype.kind == "f"):
                raise AssertionError(f"{label}: {what} differ")


def io_and_cellgrid(torch, pt, world, poses, scans, k3, launches, smi, rng):
    """Phase 24: IO and the cell-grid matchers on the card (see the module
    docstring) → the logged table."""
    import shutil

    from libpointmatcher_tpu_torch import io, matchers
    from libpointmatcher_tpu_torch.filters.base import DataPointsFilterRegistrar
    from libpointmatcher_tpu_torch.matchers import KDTreeVarDistMatcher
    from libpointmatcher_tpu_torch.ops import cellgrid
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)
    from libpointmatcher_tpu_torch.parallel.batch import _host_path
    from libpointmatcher_tpu_torch.parallel.stream import queue_eligible

    table = {}

    def counts():
        c = dict(launches(), K8=tc.tile_sweep_k.launches)
        return {k: v for k, v in c.items() if v}

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t)

    # ---- 24a. the 100 000-point scene in every format, loaded onto the card
    if not io.native.available():
        raise AssertionError("the native IO library (native/pm_native.cpp) "
                             "did not build: the loaders would parse in Python")
    stamps = (1_700_000_000_000_000_000 + np.arange(len(world), dtype=np.int64) * 1000
              + rng.integers(0, 1000, len(world)))
    reset_launch_counts()
    src = DataPointsFilterRegistrar.create(
        "SurfaceNormalDataPointsFilter", {"knn": "10"}).filter(
        pt.PointCloud.from_numpy(world, times={"time": stamps}))
    log(f"[io] scene: {src.count_host()} rows with normals (launches {counts()}) "
        f"and an int64 time channel")
    want = src.to_numpy(with_times=True)
    out = Path(__file__).resolve().parent / ".chip_scratch" / "io"
    out.mkdir(parents=True, exist_ok=True)
    loaded = {}
    try:
        for ext, binary in IO_VARIANTS:
            label = f"{ext} {'binary' if binary else 'ascii'}"
            path = str(out / f"scene_{int(binary)}.{ext}")
            _, save_ms = timed(lambda: io.save(src, path, binary=binary))
            cloud, load_ms = timed(lambda: io.load(path))
            if cloud.device.type != "cuda":
                raise AssertionError(f"{label}: loaded onto {cloud.device}")
            # PLY has no 64-bit integer type: no time channel is written
            same_arrays(cloud.to_numpy(with_times=True),
                        want[:2] + ({},) if ext == "ply" else want, label)
            loaded[(ext, binary)] = cloud
            table[f"io {label}"] = dict(save_ms=round(save_ms, 1),
                                        load_ms=round(load_ms, 1),
                                        mbytes=round(os.path.getsize(path) / 2 ** 20, 2))
            log(f"[io] {label}: " + json.dumps(table[f"io {label}"]))
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log("[io] every load equals the scene: points and normals bit for bit, "
        "times exact (PLY: no time channel)")

    def sequence(seq, idx, clouds, ps, label, kernel=None):
        """``compute`` of the scans ``idx`` after one untimed call, under the
        gates; ``kernel``'s launches equal the iterations, no other k-NN
        launch (none at all without a kernel)."""
        inits = {i: perturb(rng) @ ps[i] for i in idx}
        seq.compute(clouds[idx[0]], T_init=inits[idx[0]], seed=idx[0])
        reset_launch_counts()
        Ts, iters, ms = [], 0, 0.0
        for i in idx:
            T, t_ms = timed(lambda: seq.compute(clouds[i], T_init=inits[i], seed=i))
            Ts.append(T.cpu().numpy())
            ms += t_ms
            iters += seq.last_iteration_count
        c = counts()
        worst = gates(Ts, [ps[i] for i in idx], label)
        if c != ({kernel: iters} if kernel else {}):
            raise AssertionError(f"{label}: launches {c}, iterations {iters}")
        table[label] = dict(map_rows=seq.prefiltered_reference_pts_count,
                            iterations=iters, ms_per_iteration=round(ms / iters, 3),
                            launches=c, worst=[round(w, 5) for w in worst])
        log(f"[cellgrid] {label}: " + json.dumps(table[label]))

    def serve(seq, fn, clouds, inits, ps, label, **kw):
        """One serving call under the gates → (T, info); no k-NN launch. Its
        steps (lockstep or lane iterations) are its ``cell_knn`` calls."""
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with InputRecorder(matchers, "cell_knn", keep=0) as steps:
            (T, info), ms = timed(lambda: fn(seq, clouds, T_inits=inits, seed=1, **kw))
        c = counts()
        worst = gates(T, ps, label)
        if c or not steps.count:
            raise AssertionError(f"{label}: launches {c}, {steps.count} grid searches")
        table[label] = dict(ms=round(ms, 1), iterations=info["iterations"].tolist(),
                            steps=steps.count, ms_per_step=round(ms / steps.count, 3),
                            peak_gib=round(torch.cuda.max_memory_allocated() / 2 ** 30, 2),
                            worst=[round(w, 5) for w in worst])
        log(f"[cellgrid] {label}: " + json.dumps(table[label]))
        return T, info

    def same_results(a, b, label):
        (Ta, ia), (Tb, ib) = a, b
        diff = float(np.abs(Ta - Tb).max())
        if (not np.array_equal(ia["iterations"], ib["iterations"])
                or not np.array_equal(ia["codes"], ib["codes"]) or diff > 1e-5):
            raise AssertionError(f"{label}: iterations {ia['iterations']} / "
                                 f"{ib['iterations']}, pose difference {diff}")
        log(f"[cellgrid] {label}: the same iterations, pose difference {diff:.3g}")

    # ---- 24b. CellGridMatcher on the map loaded from the binary VTK
    seq = pt.ICPSequence()
    seq.load_from_yaml(matcher_yaml(
        f"CellGridMatcher:\n  knn: 1\n  maxDist: {CELL_MAX_DIST}"))
    _, ms = timed(lambda: seq.set_map(loaded[("vtk", True)], seed=0))
    del loaded
    grid = seq.matcher.grid
    tile = cellgrid.QUERY_TILE
    log(f"[cellgrid] set_map: {seq.prefiltered_reference_pts_count} map rows in "
        f"{ms:.1f} ms; grid {grid.dims} cells of {CELL_MAX_DIST} m, mc "
        f"{grid.max_per_cell}; a {tile}-query tile gathers "
        f"{tile * 27 * grid.max_per_cell} candidates, "
        f"{tile * 27 * grid.max_per_cell * 12 / 2 ** 20:.0f} MiB of ids and d²")
    clouds = [pt.PointCloud.from_numpy(x) for x in scans]
    sequence(seq, (1, 2), clouds, poses, "CellGrid sequence")
    b_clouds, b_poses = clouds[1:SERVE_BATCH + 1], poses[1:SERVE_BATCH + 1]
    b_inits = [perturb(rng) @ P for P in b_poses]
    with InputRecorder(matchers, "cell_knn", keep=2) as rec:
        serve(seq, register_batch_to_map, b_clouds, b_inits, b_poses,
              "CellGrid batch of 8")
    q, qm, ref, _, max_dist, k = rec.calls[1]
    del rec
    n_q = int(qm.sum())
    ms = cuda_ms(torch, lambda: cellgrid.cell_knn(q, qm, ref, grid, max_dist, k), 3)
    # each query's result depends on it alone: its first 8192 on the CPU
    qs, qms = q.reshape(-1, 3)[:8192], qm.reshape(-1)[:8192]
    card = cellgrid.cell_knn(qs, qms, ref, grid, max_dist, k)
    cpu_grid = cellgrid.build_cell_grid(ref.cpu().numpy(), np.ones(len(ref), bool),
                                        max_dist)
    cpu = cellgrid.cell_knn(qs.cpu(), qms.cpu(), ref.cpu(), cpu_grid, max_dist, k)
    if not (torch.equal(card[0].cpu(), cpu[0]) and torch.equal(card[1].cpu(), cpu[1])):
        raise AssertionError("cell_knn on the card differs from the CPU's")
    table["cell_knn"] = dict(queries=list(q.shape), valid=n_q, mc=grid.max_per_cell,
                             card_ms=round(ms, 3),
                             finite=round(float(torch.isfinite(card[0]).float().mean()), 4))
    log(f"[cellgrid] cell_knn at the batch's second lockstep iteration: "
        + json.dumps(table["cell_knn"]) + "; its first 8192 queries equal the "
        "CPU's (d² bit for bit, ids equal)")
    del q, qm, card, cpu
    if not queue_eligible(seq) or _host_path(seq):
        raise AssertionError("CellGridMatcher is not served by the queue's dense mode")
    q_idx = list(range(1, SERVE_BATCH + 1)) * 2
    q_clouds, q_poses = [clouds[i] for i in q_idx], [poses[i] for i in q_idx]
    q_inits = [perturb(rng) @ P for P in q_poses]
    queued = serve(seq, register_queue_to_map, q_clouds, q_inits, q_poses,
                   "CellGrid queue of 16", lanes=QUEUE_LANES)
    batched = serve(seq, register_batch_to_map, q_clouds, q_inits, q_poses,
                    "CellGrid batch of 16")
    same_results(queued, batched, "CellGrid queue of 16 against its batch")
    del seq, clouds, b_clouds, q_clouds
    torch.cuda.empty_cache()

    # ---- 24c. KDTreeVarDistMatcher on the ~30 000-row map (the culled route)
    def with_radii(x):
        return pt.PointCloud.from_numpy(x, {"maxSearchDist": rng.uniform(
            *VAR_RADII, len(x)).astype(np.float32)})

    v_clouds = [with_radii(x) for x in k3["scans"]]
    v_seq = pt.ICPSequence()
    v_seq.load_from_yaml(matcher_yaml("KDTreeVarDistMatcher:\n  knn: 1"))
    v_seq.set_map(pt.PointCloud.from_numpy(k3["world"]), seed=0)
    m = v_seq.matcher
    calls = []
    find = m.find_closests_in

    def recorded(reading, reference, aux=None):
        calls.append((reading, reference))
        return find(reading, reference, aux)

    m.find_closests_in = recorded
    sequence(v_seq, (0, 1), v_clouds, k3["poses"], "VarDist sequence, culled")
    del m.find_closests_in
    if m._vd_grid is None:
        raise AssertionError("the culled route did not engage")
    log(f"[cellgrid] VarDist grid: edge {m._vd_rmax:.4f} m, {m._vd_grid.dims} cells, "
        f"mc {m._vd_grid.max_per_cell}")
    reading, reference = calls[-2]
    rows = 512 * -(-reference.count_host() // 512)
    for knn in (1, 3):
        culled = KDTreeVarDistMatcher({"knn": str(knn)})
        culled.init(reference, rows=rows)
        culled.prepare_loop(reading)
        dense = KDTreeVarDistMatcher({"knn": str(knn)})
        dense.init(reference, rows=512)
        a, b = culled.find_closests_in(reading, reference), \
            dense.find_closests_in(reading, reference)
        differ = int((a.ids != b.ids).sum()) + int(
            ((a.dists != b.dists) & torch.isfinite(b.dists)).sum())
        if culled._vd_grid is None or dense._vd_grid is not None or differ:
            raise AssertionError(f"VarDist knn {knn}: the routes differ in {differ} "
                                 f"entries")
        log(f"[cellgrid] VarDist knn {knn}: the culled and dense routes equal at "
            f"a recorded step ({int(torch.isfinite(b.dists).sum())} finite matches)")
    del calls, reading, reference
    if not _host_path(v_seq) or queue_eligible(v_seq):
        raise AssertionError("KDTreeVarDistMatcher must serve on the batch's host path")
    batch = serve(v_seq, register_batch_to_map, v_clouds, k3["T_inits"],
                  k3["poses"], "VarDist batch of 8 (host path, culled)")
    queue = serve(v_seq, register_queue_to_map, v_clouds, k3["T_inits"],
                  k3["poses"], "VarDist queue of 8 (served as a batch)",
                  lanes=QUEUE_LANES)
    same_results(queue, batch, "VarDist queue against its batch")

    # ---- 24d. the dense route: a map under 16 384 rows, knn 1 (K1) and 3 (K5)
    small = [("SamplingSurfaceNormalDataPointsFilter", {}),
             ("MaxPointCountDataPointsFilter", {"seed": "0",
                                                "maxCount": str(VAR_DENSE_ROWS)})]
    for knn, kernel in ((1, "K1"), (3, "K5")):
        d_seq = pt.ICPSequence()
        d_seq.load_from_yaml(matcher_yaml(f"KDTreeVarDistMatcher:\n  knn: {knn}",
                                          reference=small))
        d_seq.set_map(pt.PointCloud.from_numpy(k3["world"]), seed=0)
        sequence(d_seq, (0, 1), v_clouds, k3["poses"],
                 f"VarDist sequence, dense, knn {knn}", kernel)
        if d_seq.matcher._vd_grid is not None:
            raise AssertionError("the dense route built a grid")

    # ---- 24e. the registered reading saved and read back
    T = batch[0][0]
    x = k3["scans"][0] @ T[:3, :3].T.astype(np.float32) + T[:3, 3].astype(np.float32)
    result = pt.PointCloud.from_numpy(
        x, {"maxSearchDist": v_clouds[0].get_descriptor("maxSearchDist").cpu().numpy()},
        times={"time": stamps[:len(x)]})
    out.mkdir(parents=True, exist_ok=True)
    try:
        for ext, binary in (("vtk", True), ("pcd", True), ("csv", False)):
            path = str(out / f"registered.{ext}")
            io.save(result, path, binary=binary)
            same_arrays(io.load(path).to_numpy(with_times=True),
                        result.to_numpy(with_times=True), f"registered {ext}")
    finally:
        shutil.rmtree(out, ignore_errors=True)
    log(f"[cellgrid] the registered reading ({len(x)} rows) saved as VTK, PCD and "
        f"CSV and read back equal; card: {smi}")
    del v_seq, batch, queue
    torch.cuda.empty_cache()
    return table


# ------------------------------------------------------------ slice 15
#: phase 25's eval_solution chain: deterministic filters (the batched and
#: sequential drivers key their draws differently), and a differential
#: rotation threshold well above the float32 resolution of an angle near
#: zero (about 5e-4 rad per ulp of a trace near 3), so that where a pair
#: stops is decided by its motion, not by rounding
EVAL_SOLUTION = "\n".join([
    "readingDataPointsFilters:",
    "  - MaxDistDataPointsFilter:\n      dim: -1\n      maxDist: 12",
    "referenceDataPointsFilters:",
    "  - SurfaceNormalDataPointsFilter:\n      knn: 10",
    "matcher: KDTreeMatcher",
    "outlierFilters:\n  - TrimmedDistOutlierFilter:\n      ratio: 0.8",
    "errorMinimizer: PointToPlaneErrorMinimizer",
    "transformationCheckers:",
    "  - CounterTransformationChecker:\n      maxIterationCount: 40",
    "  - DifferentialTransformationChecker:\n      minDiffRotErr: 0.005\n"
    "      minDiffTransErr: 0.01\n      smoothLength: 4", ""])
#: phase 25's gate on eval_solution's batched against sequential
#: translations, in metres: the lockstep loop sums each pair's normal
#: equations over the batch's padded rows, in another order than the
#: single loop; the H100's readings of that spread reached 1.27e-5 m
#: (PERF.md, "PR 15")
EVAL_TRANS_TOL = 3e-5
EVAL_PAIRS = 16
EVAL_BATCH = 8
DEMO_SCANS = 6
#: the applications that must launch a k-NN kernel, and which
APP_KERNELS = {"icp_simple": ("K1",), "icp": ("K1",), "icp_customized": ("K1",),
               "icp_advance_api": ("K1",), "align_sequence": ("K1", "K5|K8"),
               "build_map": ("K5|K8",), "compute_overlap": ("K1",),
               "eval_solution --batch 1": ("K1",), "eval_solution --batch 8": ("K1",),
               "filter_profiler": ("K8",), "golden_check": ("K1",),
               "demo_pipeline": ("K1",)}


def _matrix_after(text, tag):
    """The numbers of the first matrix printed after ``tag``."""
    tail = text.split(tag, 1)[1].split("]]", 1)[0]
    nums = re.findall(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?", tail)
    return np.array([float(v) for v in nums]).reshape(4, 4)


def apps_on_card(torch, pt, world, poses, scans, launches, smi, rng):
    """Phase 25: every ported application's ``main`` in this process with
    ``--device cuda`` (see the module docstring) → the logged table."""
    import contextlib
    import importlib
    import io as stdio
    import shutil

    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.ops.knn import knn_brute_force

    apps = {name: importlib.import_module(f"libpointmatcher_tpu_torch.apps.{name}")
            for name in ("icp_simple", "icp", "icp_customized", "icp_advance_api",
                         "align_sequence", "build_map", "compute_overlap",
                         "eval_solution", "plot_results", "filter_profiler",
                         "list_modules", "golden_check", "demo_pipeline")}
    dev = ["--device", "cuda"]
    table = {}

    def counts():
        c = dict(launches(), K7=tc.tile_sweep.launches, K8=tc.tile_sweep_k.launches)
        return {k: v for k, v in c.items() if v}

    def run(name, argv, label=None):
        """``name``'s main on ``argv``, its output captured → the output;
        its return code, wall time and launches checked and logged."""
        label = label or name
        reset_launch_counts()
        buf = stdio.StringIO()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = apps[name].main(argv)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t)
        c = counts()
        if rc != 0:
            raise AssertionError(f"{label}: return code {rc}:\n{buf.getvalue()[-2000:]}")
        for want in APP_KERNELS.get(label, ()):
            if not any(c.get(k) for k in want.split("|")):
                raise AssertionError(f"{label}: no {want} launch (launches {c})")
        table[label] = {"ms": round(ms, 1), "launches": c}
        log(f"[apps] {label}: {ms:.1f} ms, launches {c}")
        return buf.getvalue()

    def near(T, gT, label):
        ang, tr = pose_error(T, gT)
        if not (np.isfinite(T).all() and ang < ROT_TOL and tr < TRANS_TOL):
            raise AssertionError(f"{label}: pose error {ang}, {tr}")
        return round(ang, 5), round(tr, 5)

    def save(points, path, binary=True):
        pt.io.save(pt.PointCloud.from_numpy(points, device="cpu"), str(path),
                   binary=binary)

    def rigid(T, pts):
        return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32)

    out = Path(__file__).resolve().parent / ".chip_scratch" / "apps"
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    cwd = os.getcwd()
    t_phase = time.perf_counter()
    try:
        os.chdir(out)
        n = len(scans)
        # the scans in their sensor frames, with their poses (gT); and each
        # through a noisy odometry guess D_i into the frame of scan 0, whose
        # registration onto the map gives back D_i
        for i, s in enumerate(scans):
            save(s, out / f"scan{i}.vtk")
        head = ", ".join(f"gT{a}{b}" for a in range(4) for b in range(4))
        row = lambda T: ", ".join(repr(float(v)) for v in np.asarray(T).reshape(-1))
        (out / "gt.csv").write_text(f"reading, {head}\n" + "".join(
            f"scan{i}.vtk, {row(P)}\n" for i, P in enumerate(poses)))
        odo = [np.eye(4)] + [perturb(rng) for _ in range(n - 1)]
        for i in range(n):
            M = np.linalg.inv(odo[i]) @ np.linalg.inv(poses[0]) @ poses[i]
            save(rigid(M, scans[i]), out / f"odo{i}.vtk")
        (out / "odo.csv").write_text(
            "reading\n" + "".join(f"odo{i}.vtk\n" for i in range(n)))
        save(world.astype(np.float32), out / "scene.csv", binary=False)
        save(world.astype(np.float32), out / "scene.vtk")
        log(f"[apps] files: {n} scans of {len(scans[0])} points and the "
            f"{len(world)}-point scene in {out.name}/ "
            f"({time.perf_counter() - t_phase:.1f} s)")

        # ---- 25a. the one-shot applications on scans 1 → 0
        gT = np.linalg.inv(poses[0]) @ poses[1]
        guess = perturb(rng) @ gT
        want = gT @ np.linalg.inv(guess)          # ref ≈ want · reading
        save(rigid(guess, scans[1]), out / "reading.vtk")
        pair = [str(out / "scan0.vtk"), str(out / "reading.vtk")]
        for name in ("icp_simple", "icp_customized", "icp_advance_api"):
            text = run(name, pair + dev)
            table[name]["error"] = near(_matrix_after(text, "Final transformation:"),
                                        want, name)
        if not (out / "test_data_out.vtk").exists():
            raise AssertionError("icp_simple / icp_customized saved no aligned cloud")
        text = run("icp", [str(out / "scan0.vtk"), str(out / "scan1.vtk"),
                           "--initTranslation", ",".join(repr(float(v)) for v in guess[:3, 3]),
                           "--initRotation", ",".join(repr(float(v)) for v in guess[:3, :3].ravel()),
                           "--isVerbose", "--output", "cli"] + dev)
        table["icp"]["error"] = near(_matrix_after(text, "Final transformation:"),
                                     gT, "icp")
        if "readingDataPointsFilters:" not in text:
            raise AssertionError("icp --isVerbose printed no chain")

        # ---- 25b. align_sequence on the odometry-guessed scans
        text = run("align_sequence", [str(out / "odo.csv"), "--output", "odo_map.vtk"]
                   + dev)
        steps = re.findall(r"\[(\d+)\] T=\n(.*?\]\])\nmap: (\d+) points", text, re.S)
        if len(steps) != n - 1:
            raise AssertionError(f"align_sequence registered {len(steps)} of {n - 1} scans")
        errs = [near(np.array([float(v) for v in re.findall(
            r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?", m)]).reshape(4, 4),
            odo[int(i)], f"align_sequence scan {i}") for i, m, _ in steps]
        rows = pt.io.load(str(out / "odo_map.vtk"), device="cuda").count_host()
        if rows != int(steps[-1][2]):
            raise AssertionError(f"align_sequence map reloads with {rows} rows")
        table["align_sequence"].update(
            ms_per_scan=round(table["align_sequence"]["ms"] / (n - 1), 1),
            map_rows=rows, worst=[max(e[0] for e in errs), max(e[1] for e in errs)])

        # ---- 25c. build_map with the ground-truth poses
        text = run("build_map", [str(out / "gt.csv"), "gt_map.vtk"] + dev)
        rows = pt.io.load(str(out / "gt_map.vtk"), device="cuda").count_host()
        if f"map with {rows} points" not in text or rows == 0:
            raise AssertionError(f"build_map: the saved map has {rows} rows")
        table["build_map"]["map_rows"] = rows

        # ---- 25d. compute_overlap on the scans
        run("compute_overlap", [str(out / "gt.csv"), "--noise", "0.05", "--output",
                                "overlap.csv"] + dev)
        M = np.loadtxt(out / "overlap.csv", delimiter=",")
        off = M[~np.eye(n, dtype=bool)]
        if M.shape != (n, n) or not np.all(np.diag(M) == 1) or not (
                np.all((off >= 0) & (off <= 1)) and off.max() > 0):
            raise AssertionError(f"compute_overlap: matrix {M}")
        ov = apps["compute_overlap"]
        a, b = (pt.RigidTransformation().compute(
            pt.PointCloud.from_numpy(scans[i], device="cuda"),
            torch.as_tensor(poses[i], dtype=torch.float32, device="cuda"))
            for i in (1, 0))
        plain = ov.overlap_ratio(a, b, 0.05, search=knn_brute_force)
        if abs(plain - M[1, 0]) > 5e-7:
            raise AssertionError(f"overlap 1→0: {M[1, 0]} with K1, {plain} plain")
        table["compute_overlap"].update(pairs=n * (n - 1),
                                        overlap_range=[float(off.min()), float(off.max())])

        # ---- 25e. eval_solution, sequential and batched, then plot_results
        pairs = [(a, b) for d in (1, 2) for b in range(n - d) for a in (b + d,)]
        pairs = (pairs + [(b, a) for a, b in pairs])[:EVAL_PAIRS]
        ihead = ", ".join(f"iT{a}{b}" for a in range(4) for b in range(4))
        lines = [f"reading, reference, {ihead}, {head}"]
        for a, b in pairs:
            G = np.linalg.inv(poses[b]) @ poses[a]
            lines.append(f"scan{a}.vtk, scan{b}.vtk, {row(perturb(rng) @ G)}, {row(G)}")
        (out / "protocol.csv").write_text("\n".join(lines) + "\n")
        (out / "solution.yaml").write_text(EVAL_SOLUTION)
        res = {}
        for batch in (1, EVAL_BATCH):
            label = f"eval_solution --batch {batch}"
            run("eval_solution", ["protocol.csv", "solution.yaml", "--batch", str(batch),
                                  "--output", f"eval{batch}.json"] + dev, label)
            with open(out / f"eval{batch}.json") as f:
                res[batch] = json.load(f)
            r = res[batch]["results"]
            for x in r:
                if x["error"] or x["trans_err"] > TRANS_TOL or x["rot_err"] > ROT_TOL:
                    raise AssertionError(f"{label} pair {x['pair']}: {x}")
            table[label]["pairs_per_s"] = round(
                len(r) / (table[label]["ms"] / 1e3), 2)
        # per pair the same iterations and errors; the pose within 1e-5 on
        # rotation entries and EVAL_TRANS_TOL on translation
        d_rot = d_trans = 0.0
        for x, y in zip(res[1]["results"], res[EVAL_BATCH]["results"]):
            D = np.abs(np.array(x["T"]) - np.array(y["T"]))
            d_rot, d_trans = max(d_rot, float(D[:3, :3].max())), max(d_trans, float(D[:3, 3].max()))
            if (x["pair"], x["iterations"], x["error"]) != (y["pair"], y["iterations"],
                                                            y["error"]):
                raise AssertionError(f"eval_solution pair {x['pair']}: sequential "
                                     f"{x['iterations']} {x['error']}, batched "
                                     f"{y['iterations']} {y['error']}")
        if d_rot > 1e-5 or d_trans > EVAL_TRANS_TOL:
            raise AssertionError(f"eval_solution: batched poses differ by {d_rot} "
                                 f"(rotation), {d_trans} m (translation)")
        table["eval_solution --batch 8"]["vs_batch_1"] = [d_rot, d_trans]
        log(f"[apps] eval_solution: {len(pairs)} pairs, batched = sequential per pair "
            f"(iterations and errors equal, rotation entries within {d_rot:.3g}, "
            f"translations within {d_trans:.3g} m)")
        text = run("plot_results", [f"eval{EVAL_BATCH}.json", "--csv", "pairs.csv"])
        if "Translation error histogram" not in text or len(
                (out / "pairs.csv").read_text().splitlines()) != len(pairs) + 1:
            raise AssertionError("plot_results: no histogram or CSV")

        # ---- 25f. filter_profiler: SurfaceNormal on the scene (K8)
        text = run("filter_profiler", ["scene.vtk", "--param", "knn=10", "--runs", "3"]
                   + dev)
        table["filter_profiler"]["report"] = text.strip()

        # ---- 25g. list_modules in its three styles
        for style in ("normal", "roswiki", "bibtex"):
            text = run("list_modules", ["--citationStyle", style],
                       f"list_modules {style}")
            sections = re.findall(r"={60}\n(\w+)\n={60}", text)
            if len(sections) != 9 or text.count("\n* ") < 58:
                raise AssertionError(f"list_modules {style}: sections {sections}")
        icp = pt.ICP(device="cuda")
        icp.set_default()
        chain = apps["list_modules"].describe_chain(icp)
        for m in (icp.reading_filters + icp.reference_filters + [icp.matcher]
                  + icp.outlier_filters + [icp.error_minimizer] + icp.checkers):
            if type(m).__name__ not in chain:
                raise AssertionError(f"describe_chain lacks {type(m).__name__}")

        # ---- 25h. golden_check on synthetic example data
        gold = out / "golden"
        (gold / "icp_data").mkdir(parents=True)
        shutil.copy(out / "scan0.vtk", gold / "cloud.00000.vtk")
        shutil.copy(out / "reading.vtk", gold / "cloud.00001.vtk")
        np.savetxt(gold / "icp_data" / "default.ref_trans", want)
        (gold / "icp_data" / "default.yaml").write_text(chain_yaml())
        golden = apps["golden_check"]
        data, icp_data = golden.DATA, golden.ICP_DATA
        golden.DATA, golden.ICP_DATA = str(gold), str(gold / "icp_data")
        try:
            text = run("golden_check", ["--seeds", "1"] + dev)
        finally:
            golden.DATA, golden.ICP_DATA = data, icp_data
        if not text.startswith("PASS default"):
            raise AssertionError(f"golden_check: {text}")
        table["golden_check"]["report"] = text.splitlines()[0]

        # ---- 25i. demo_pipeline on the scene
        text = run("demo_pipeline", ["--cloud", "scene.csv", "--scans", str(DEMO_SCANS)]
                   + dev)
        demo = json.loads(text.strip().splitlines()[-1])
        if not demo["ate_refined"] <= demo["ate_odometry_noisy"]:
            raise AssertionError(f"demo_pipeline: {demo}")
        table["demo_pipeline"]["result"] = demo

        # ---- 25j. the pose graph alone, at the demo's size and settings
        from libpointmatcher_tpu_torch.parallel.posegraph import (
            edges_from_numpy, optimize_pose_graph, relative_pose_residual)

        gt = [np.linalg.inv(poses[0]) @ P for P in poses[:DEMO_SCANS]]
        ii = list(range(DEMO_SCANS - 1)) + [0]
        jj = list(range(1, DEMO_SCANS)) + [DEMO_SCANS - 1]
        edges = edges_from_numpy(ii, jj, np.stack([np.linalg.inv(gt[a]) @ gt[b]
                                                    for a, b in zip(ii, jj)]),
                                 device="cuda")
        noisy = np.stack([gt[0]] + [perturb(rng) @ P for P in gt[1:]]).astype(np.float32)
        optimize_pose_graph(noisy, edges, gn_iters=10, cg_iters=30)
        torch.cuda.synchronize()
        t = time.perf_counter()
        refined, res = optimize_pose_graph(noisy, edges, gn_iters=10, cg_iters=30)
        res = float(res)
        ms = 1e3 * (time.perf_counter() - t)
        before = float(relative_pose_residual(
            torch.as_tensor(noisy, device="cuda"), edges).norm())
        worst = max(pose_error(T, P) for T, P in zip(refined.cpu().numpy(), gt))
        if not (res < 1e-3 * before and worst[0] < 2e-3 and worst[1] < 1e-3):
            raise AssertionError(f"pose graph: residual {before} -> {res}, worst {worst}")
        table["pose graph"] = {"ms": round(ms, 1), "residual": [before, res],
                               "worst": [round(w, 6) for w in worst]}
        log(f"[apps] pose graph (K = {DEMO_SCANS}, 10 x 30): {ms:.1f} ms, residual "
            f"{before:.4g} -> {res:.3g}, worst pose error {worst}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(out, ignore_errors=True)
    log(f"[apps] card: {smi}; " + json.dumps(table))
    log(f"[apps] phase 25 took {time.perf_counter() - t_phase:.1f} s")
    return table


# ------------------------------------------------------------ slice 16
#: phase 26's gloo groups on the one card (NCCL takes one rank a card)
MULTI_GLOO_WORLDS = (2, 4)
#: each collective's timeout, and each spawned group's from start to join
MULTI_RANK_TIMEOUT_S = 300.0
MULTI_GROUP_TIMEOUT_S = 420.0
#: the sharded k-NN's k on K5's route, the tile route's radius and cell
#: edge (maxDist + motionBound of the tile phases), the cell blocks' edge
MULTI_KNN_K = 5
MULTI_MAX_DIST = 0.5
MULTI_TILE_CELL = 1.5
MULTI_BLOCK_CELL = 0.5
MULTI_POSE_GRAPH = (64, 8, 1)   # poses, extra closures, seed


def _worker():
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "tests"))
    import torch_sharding_worker as w
    return w


def multi_inputs(torch, cell, batch_T, pairs, pair_T):
    """Phase 26's inputs as host arrays: the K4 route's map (the sequence
    map) padded with masked rows to a multiple of 4, phase 11's 8 scans,
    their guesses and the batch's poses, one of them in the map's frame as
    the queries (and in its Morton order), the map's survivor tables,
    phase 12's pairs and their poses."""
    from libpointmatcher_tpu_torch.ops import morton, sweep

    internal = cell["seq"].get_prefiltered_internal_map()
    pts, mask = internal.host_rows()
    m = len(pts)
    m4 = -(-m // 4) * 4
    inp = {"map": pts, "mask": mask,
           "normals": internal.get_descriptor("normals").cpu().numpy(),
           "trm": cell["seq"].trm_host().astype(np.float32),
           "map_pad": np.concatenate([pts, np.zeros((m4 - m, 3), np.float32)]),
           "mask_pad": np.concatenate([mask, np.zeros(m4 - m, bool)]),
           "serve_T": batch_T, "pair_T": pair_T,
           "inits": np.stack(cell["qinits"][:SERVE_BATCH]).astype(np.float32)}
    for i, c in enumerate(cell["qclouds"][:SERVE_BATCH]):
        inp[f"scan_{i}"] = c.points.cpu().numpy()
    T = np.linalg.inv(cell["seq"].trm_host()) @ cell["qinits"][0]
    q = (inp["scan_0"] @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
    inp["q"], inp["qm"] = q, np.ones(len(q), bool)
    inp["qs"] = q[morton.morton_argsort(q, inp["qm"])[0]]
    rorder, _ = morton.morton_argsort(pts, mask)
    inp["rt3"] = sweep.chunked_ref_table(pts[rorder], mask[rorder])
    inp["ct"] = sweep.chunk_summaries(pts[rorder], mask[rorder])
    for i, (rd, rf, ti) in enumerate(zip(*pairs)):
        inp[f"pair_read_{i}"], inp[f"pair_ref_{i}"] = rd, rf
        inp[f"pair_init_{i}"] = np.asarray(ti, np.float32)
    return inp


def multi_cases(torch, mesh, pmesh, inp):
    """Phase 26's cases through the port's entry points on ``mesh`` (and
    ``pmesh``, its pair axis), or with ``mesh`` None the single-device ops
    → ``{case: numpy array}``. The serving batch is phase 11's 8 scans on
    the sequence map (installed from phase 11's arrays)."""
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import cellblocks, dispatch, sweep, tilesweep
    from libpointmatcher_tpu_torch.parallel import (posegraph, register_batch,
                                                    register_batch_to_map,
                                                    sharding)

    w = _worker()
    dev = "cuda" if mesh is None else mesh.device
    t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
    out = {}
    q, qm = t(inp["q"]), t(inp["qm"])
    r, rm = t(inp["map_pad"]), t(inp["mask_pad"])
    for k in (1, MULTI_KNN_K):
        d, i = (dispatch.knn_search(q, qm, r, rm, k=k) if mesh is None
                else sharding.sharded_knn(q, qm, r, rm, k, mesh))
        out[f"knn{k}_d"], out[f"knn{k}_i"] = d, i
    sub = tilesweep.build_sub_blocks(inp["map"], inp["mask"], MULTI_TILE_CELL)
    ta = tilesweep.assign_tiles(inp["q"], inp["qm"], sub, tile_q=64,
                                block_cap=1024)
    units = t(sub.units)
    out["tile_d"], out["tile_i"] = (
        tilesweep.tile_nn1(q, qm, ta, units, MULTI_MAX_DIST) if mesh is None
        else sharding.sharded_tile_nn1(q, qm, ta, units, MULTI_MAX_DIST, mesh))
    qs, ub = t(inp["qs"]), torch.full(qm.shape, float("inf"), device=dev)
    if mesh is None:
        d, i, _ = sweep.nn1_sorted_v2(
            qs, qm, ub, t(inp["rt3"]), t(inp["ct"]),
            stream=128 * inp["rt3"].shape[0] > sweep.SKIP_MAX_MPAD)
    else:
        rt3p, ctp = sharding.pad_sweep_tables_for_mesh(inp["rt3"], inp["ct"],
                                                       mesh.size)
        d, i = sharding.sharded_nn1_sorted_v2(qs, qm, ub, t(rt3p), t(ctp), mesh)
    out["sweep_d"], out["sweep_i"] = d, i
    rb = cellblocks.build_ref_blocks(inp["map"], inp["mask"], MULTI_BLOCK_CELL,
                                     device=dev)
    qb = cellblocks.assign_query_blocks(inp["q"], inp["qm"], rb)
    out["block_d"], out["block_i"] = (
        cellblocks.block_nn1(q, qb, rb.blocks, rb.block_ids, MULTI_MAX_DIST)
        if mesh is None else sharding.sharded_block_nn1(
            q, qb.rows, qb.nb_slots, rb.blocks, rb.block_ids, MULTI_MAX_DIST,
            mesh))
    icp = pt.ICP(device=dev)
    icp.set_default()
    n_pairs = len([k for k in inp if k.startswith("pair_read_")])
    cloud = lambda a: pt.PointCloud.from_numpy(a, device=dev)
    out["pair_T"], _ = register_batch(
        icp, [cloud(inp[f"pair_read_{i}"]) for i in range(n_pairs)],
        [cloud(inp[f"pair_ref_{i}"]) for i in range(n_pairs)],
        T_inits=[inp[f"pair_init_{i}"] for i in range(n_pairs)], seed=1,
        mesh=pmesh)
    seq = multi_sequence(torch, pt, inp, dev)
    out["serve_T"], info = register_batch_to_map(
        seq, multi_scans(pt, inp, dev), T_inits=list(inp["inits"]), seed=1,
        mesh=mesh)
    out["serve_iterations"], out["serve_codes"] = info["iterations"], info["codes"]
    init, ii, jj, meas, _ = w.pose_graph_inputs(*MULTI_POSE_GRAPH)
    edges = posegraph.edges_from_numpy(ii, jj, meas, device=dev)
    if mesh is not None:
        edges = posegraph.shard_edges(edges, mesh)
    out["pg_poses"], out["pg_res"] = posegraph.optimize_pose_graph(
        init, edges, gn_iters=10, cg_iters=30, mesh=mesh)
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def multi_sequence(torch, pt, inp, dev):
    """A default-chain sequence holding phase 11's sequence map."""
    from libpointmatcher_tpu_torch.state import install_map

    seq = pt.ICPSequence(device=dev)
    seq.set_default()
    install_map(seq, inp["map"], inp["normals"], inp["trm"], inp["mask"])
    return seq


def multi_scans(pt, inp, dev):
    return [pt.PointCloud.from_numpy(inp[f"scan_{i}"], device=dev)
            for i in range(len(inp["inits"]))]


def multi_meter(torch, mesh, inp):
    """The serving batch of phase 26 on ``mesh``, three times: one run for
    registrations/s (host clock ending in a synchronize), then one with
    every K1/K5 search timed by CUDA events and every collective (host
    staging included) by the host clock between two synchronizes → a dict
    of this rank's numbers."""
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import dispatch
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.parallel import batch as batch_mod
    from libpointmatcher_tpu_torch.parallel import register_batch_to_map, sharding

    seq = multi_sequence(torch, pt, inp, mesh.device)
    clouds = multi_scans(pt, inp, mesh.device)
    run = lambda: register_batch_to_map(seq, clouds, T_inits=list(inp["inits"]),
                                        seed=1, mesh=mesh)
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, info = run()
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    events, coll = [], [0, 0.0]
    orig = {"knn": dispatch.knn_search, "ar": sharding.all_reduce,
            "ag": sharding.all_gather}

    def knn(*a, **k):
        e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        e0.record()
        out = orig["knn"](*a, **k)
        e1.record()
        events.append((e0, e1))
        return out

    def timed(fn):
        def call(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            coll[0] += 1
            coll[1] += 1e3 * (time.perf_counter() - t)
            return out
        return call

    patches = [(dispatch, "knn_search", knn),
               (sharding, "all_reduce", timed(orig["ar"])),
               (sharding, "all_gather", timed(orig["ag"])),
               (batch_mod, "all_reduce", timed(orig["ar"])),
               (batch_mod, "all_gather", timed(orig["ag"]))]
    saved = [(m, n, getattr(m, n)) for m, n, _ in patches]
    kc.reset_launch_counts()
    try:
        for m, n, f in patches:
            setattr(m, n, f)
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        metered = time.perf_counter() - t0
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    it = int(info["iterations"].max())
    return {"rank": mesh.index, "ranks": mesh.size, "backend": mesh.backend,
            "iterations": it, "registrations_per_s": SERVE_BATCH / sec,
            "batch_ms": 1e3 * sec,
            "k1_launches_per_iteration": kc.knn1.launches / max(it, 1),
            "kernel_ms": sum(a.elapsed_time(b) for a, b in events),
            "collectives": coll[0], "collective_ms": coll[1],
            "metered_batch_ms": 1e3 * metered}


def multi_rank(rank, world, init_file, in_file, out_dir):
    """A gloo rank of phase 26 on the card: its group's cases and meter;
    rank 0 saves the cases, every rank its numbers."""
    import torch

    w = _worker()
    torch.cuda.set_device(0)
    w.init_rank(rank, world, init_file, "gloo", MULTI_RANK_TIMEOUT_S)
    from libpointmatcher_tpu_torch.parallel import sharding
    try:
        inp = dict(np.load(in_file))
        mesh = sharding.make_mesh(world, device="cuda")
        pmesh = sharding.make_mesh(world, axis_name="pairs", device="cuda")
        special = {}
        w.special_rows(mesh, special)
        out = multi_cases(torch, mesh, pmesh, inp)
        out.update(special)
        meter = multi_meter(torch, mesh, inp)
        if rank == 0:
            np.savez(os.path.join(out_dir, f"cases_{world}.npz"), **out)
        with open(os.path.join(out_dir, f"meter_{world}_{rank}.json"), "w") as f:
            json.dump(meter, f)
    finally:
        torch.distributed.destroy_process_group()


def multi_check(single, got, label):
    """Every case of ``got`` against the single-device ``single``: bit for
    bit but the pose graph and ``register_batch``'s poses (within 1e-5);
    and the sharded gather's signed zeros and infinities."""
    for key, want in single.items():
        v = got[key]
        if key.startswith("pg_") or key == "pair_T":
            err = float(np.abs(v - want).max())
            if not err <= 1e-5:
                raise AssertionError(f"{label}: {key} differs by {err}")
        elif v.shape != want.shape or v.tobytes() != want.tobytes():
            bad = int((v != want).sum()) if v.shape == want.shape else -1
            raise AssertionError(f"{label}: {key} not bit for bit ({bad} differ)")
    if "special_rows" in got and (got["special_rows"].tobytes()
                                  != got["special_want"].tobytes()):
        raise AssertionError(f"{label}: gather_rows lost a signed zero or inf")


def multi_device(torch, inp, smi):
    """Phase 26 (see the module docstring) → the logged table."""
    import torch.distributed as dist

    from libpointmatcher_tpu_torch.parallel import sharding

    w = _worker()
    t_phase = time.perf_counter()
    scratch = Path(__file__).resolve().parent / ".chip_scratch" / "multi"
    if scratch.exists():
        import shutil
        shutil.rmtree(scratch)
    scratch.mkdir(parents=True)
    in_file = str(scratch / "inputs.npz")
    np.savez(in_file, **inp)
    single = multi_cases(torch, None, None, inp)
    if single["serve_T"].tobytes() != inp["serve_T"].tobytes():
        raise AssertionError("phase 26's single-device batch differs from "
                             "phase 11's")
    single.pop("serve_iterations"), single.pop("serve_codes")
    table = {}

    # ---- 26a. one NCCL rank in this process
    from datetime import timedelta
    dist.init_process_group("nccl", init_method=f"file://{scratch / 'nccl'}",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=MULTI_RANK_TIMEOUT_S))
    try:
        mesh = sharding.make_mesh(1, device="cuda")
        pmesh = sharding.make_mesh(1, axis_name="pairs", device="cuda")
        got = multi_cases(torch, mesh, pmesh, inp)
        w.special_rows(mesh, got)
        multi_check(single, got, "NCCL world 1")
        table["nccl_1"] = [multi_meter(torch, mesh, inp)]
    finally:
        dist.destroy_process_group()
    log(f"[multi] NCCL world 1: every case equals the single-device one; "
        + json.dumps(table["nccl_1"]))

    # ---- 26b. gloo ranks on the one card
    for world in MULTI_GLOO_WORLDS:
        t = time.perf_counter()
        w.spawn_ranks(multi_rank, world,
                      (world, str(scratch / f"gloo_{world}"), in_file,
                       str(scratch)), MULTI_GROUP_TIMEOUT_S)
        got = dict(np.load(scratch / f"cases_{world}.npz"))
        multi_check(single, got, f"gloo world {world}")
        table[f"gloo_{world}"] = [
            json.loads((scratch / f"meter_{world}_{r}.json").read_text())
            for r in range(world)]
        log(f"[multi] gloo world {world} on the card ({time.perf_counter() - t:.1f} s): "
            f"every case equals the single-device one, the batch equals phase "
            f"11's; " + json.dumps(table[f"gloo_{world}"]))

    # ---- 26c. scaling_bench and the two-process dry run
    root = Path(__file__).resolve().parent
    for argv in (["--ranks", "4", "--backend", "gloo", "--device", "cuda"],
                 ["--ranks", "1", "--backend", "nccl", "--device", "cuda"]):
        proc = subprocess.run(
            [sys.executable, "-m", "libpointmatcher_tpu_torch.apps.scaling_bench",
             *argv], capture_output=True, text=True, timeout=MULTI_GROUP_TIMEOUT_S,
            cwd=root)
        if proc.returncode != 0:
            raise AssertionError(f"scaling_bench {argv}: {proc.stderr[-2000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        want = {f"{n}_devices" for n in sorted({1, max(1, int(argv[1]) // 2),
                                                int(argv[1])})}
        if set(res) != want or not all(v["registrations_per_s"] > 0
                                       for v in res.values()):
            raise AssertionError(f"scaling_bench {argv}: {res}")
        table[f"scaling_bench {' '.join(argv[:4])}"] = res
        log(f"[multi] scaling_bench {' '.join(argv[:4])}: {json.dumps(res)}")
    proc = subprocess.run(
        [sys.executable, str(root / "tools_torch" / "dryrun_multihost.py"),
         "--device", "cuda", "--out", str(scratch / "dryrun.json")],
        capture_output=True, text=True, timeout=MULTI_GROUP_TIMEOUT_S, cwd=root)
    if proc.returncode != 0:
        raise AssertionError(f"dry run: {proc.stdout[-2000:]} {proc.stderr[-2000:]}")
    dry = json.loads((scratch / "dryrun.json").read_text())
    table["dryrun"] = [{k: r[k] for k in ("multi_vs_single_maxdiff",
                                          "trans_err_max_vs_truth", "wall_s")}
                       for r in dry["results"]]
    log(f"[multi] dry run, 2 gloo processes: {json.dumps(table['dryrun'])}")
    log(f"[multi] card: {smi}; phase 26 took {time.perf_counter() - t_phase:.1f} s")
    return table


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


# ------------------------------------------------------------ slice 17
class switch:
    """``os.environ[name] = value`` while the context is open, the earlier
    state restored after it whatever happens inside (a failure still
    propagates)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.get(self.name)
        os.environ[self.name] = self.value
        return self

    def __exit__(self, *exc):
        if self.old is None:
            del os.environ[self.name]
        else:
            os.environ[self.name] = self.old


#: phase 27's probe of PMTPU_CACHE_DIR, run as ``python -c PROBE build|load``
#: with the variable set: it loads the five kernel libraries (one nvcc
#: each, together, where one is missing) and the native IO library and
#: prints where they lie and which this process built; ``load`` refuses
#: any compiler run
CACHE_PROBE = """
import json, subprocess, sys, time
from concurrent.futures import ThreadPoolExecutor
from libpointmatcher_tpu_torch.io import native
from libpointmatcher_tpu_torch.ops import (knn_cuda, knn_variants_cuda,
                                           skip_cuda, sweep_cuda, tile_cuda)
if sys.argv[1] == "load":
    def refuse(*a, **k):
        raise AssertionError("a compiler ran: " + str(a[0][0]))
    subprocess.run = refuse
libs = [m.LIBRARY for m in (knn_cuda, sweep_cuda, tile_cuda, skip_cuda,
                            knn_variants_cuda)]
t = time.perf_counter()
with ThreadPoolExecutor(len(libs)) as pool:
    list(pool.map(lambda lib: lib.load(), libs))
assert native.available(), "the native library did not load"
print(json.dumps({"s": time.perf_counter() - t,
                  "paths": [str(lib.path()) for lib in libs]
                  + [str(native._so_path())],
                  "built": [bool(lib.build_log) for lib in libs]}))
"""


def cache_dir_probe():
    """Phase 27's ``PMTPU_CACHE_DIR`` case → the two runs' seconds."""
    import shutil
    import tempfile

    root = Path(__file__).resolve().parent
    cache = Path(tempfile.mkdtemp(prefix="pmtpu_cache_")) / "libs"
    env = dict(os.environ, PMTPU_CACHE_DIR=str(cache),
               PYTHONPATH=os.pathsep.join(
                   [str(root)] + ([os.environ["PYTHONPATH"]]
                                  if os.environ.get("PYTHONPATH") else [])))
    env.pop("PMTPU_NO_NATIVE", None)
    runs = {}
    try:
        for mode in ("build", "load"):
            proc = subprocess.run([sys.executable, "-c", CACHE_PROBE, mode],
                                  cwd=root, env=env, capture_output=True,
                                  text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"PMTPU_CACHE_DIR {mode} run failed:\n"
                                     f"{proc.stderr[-3000:]}")
            runs[mode] = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[mode]["mtimes"] = [Path(p).stat().st_mtime_ns
                                    for p in runs[mode]["paths"]]
        build, load = runs["build"], runs["load"]
        if not all(Path(p).parent == cache for p in build["paths"]):
            raise AssertionError(f"libraries outside {cache}: {build['paths']}")
        if not all(build["built"]) or any(load["built"]):
            raise AssertionError(f"nvcc ran {build['built']} (build) and "
                                 f"{load['built']} (load)")
        if load["paths"] != build["paths"] or load["mtimes"] != build["mtimes"]:
            raise AssertionError("the load run did not reuse the built libraries")
        if sorted(p.name for p in cache.iterdir()) != sorted(
                Path(p).name for p in build["paths"]):
            raise AssertionError(f"stray files in {cache}: "
                                 f"{sorted(p.name for p in cache.iterdir())}")
    finally:
        shutil.rmtree(cache.parent, ignore_errors=True)
    log(f"[switches] PMTPU_CACHE_DIR: 5 CUDA libraries and the native one "
        f"built into a fresh directory in {build['s']:.2f} s, loaded by a "
        f"second process with no compiler run in {load['s']:.2f} s")
    return build["s"], load["s"]


def k9_excess(torch, kc, calls):
    """The relative excess of K9's pick over K1's d² (the exact distance of
    K9's row over the exact optimum, minus 1) at every valid query of the
    recorded searches → (maximum, 99th percentile, largest absolute d²
    excess)."""
    rel, absolute = [], 0.0
    for q, qm, r, rm in (c[:4] for c in calls):
        d1, _ = kc.knn1(q, qm, r, rm)
        _, i9 = kc.knn1_mxu(q, qm, r, rm)
        diff = q - r[i9.clamp(min=0).long()]
        dj = ((diff[:, 0] * diff[:, 0] + diff[:, 1] * diff[:, 1])
              + diff[:, 2] * diff[:, 2])
        ok = qm & torch.isfinite(d1)
        absolute = max(absolute, float((dj[ok] - d1[ok]).max()))
        pos = ok & (d1 > 0)
        rel.append(torch.sqrt(dj[pos] / d1[pos]) - 1.0)
    rel = torch.cat(rel)
    return (float(rel.max()), float(torch.quantile(rel.double(), 0.99)),
            absolute)


def switches(torch, pt, kc, world, poses, scans, cells, launches, smi, rng):
    """Phase 27 (see the module docstring)."""
    from libpointmatcher_tpu_torch.ops import dispatch
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import batch as batch_mod
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)

    t_phase = time.perf_counter()
    log(f"[switches] card: {smi}")

    def counts():
        return dict(launches(), K9=kc.knn1_mxu.launches,
                    K7=tc.tile_sweep.launches, K8=tc.tile_sweep_k.launches)

    def only(got, name, n, label):
        want = {k: n if k == name else 0 for k in got}
        if got != want:
            raise AssertionError(f"{label}: launches {got}, expected {want}")

    def serve(cell, clouds=None):
        reset_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        T, info = register_batch_to_map(
            cell["seq"], clouds or [pt.PointCloud.from_numpy(x) for x in cell["scans"]],
            T_inits=cell["T_inits"], seed=1)
        return T, info, 1e3 * (time.perf_counter() - t), counts()

    def same(a, b, label):
        (Ta, ia), (Tb, ib) = a, b
        if Ta.tobytes() != Tb.tobytes() or any(
                not np.array_equal(ia[k], ib[k]) for k in ia):
            raise AssertionError(f"{label}: results differ, largest |dT| "
                                 f"{float(np.abs(Ta - Tb).max()):.3g}")

    # ---- 27a. PMTPU_KNN_IMPL=mxu
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
    inits = [perturb(rng) @ poses[i] for i in range(1, SEQ_SCANS + 1)]

    def sequence(label):
        reset_launch_counts()
        iters, out = 0, []
        torch.cuda.synchronize()
        t = time.perf_counter()
        for i, T_init in zip(range(1, SEQ_SCANS + 1), inits):
            out.append(seq.compute(pt.PointCloud.from_numpy(scans[i]),
                                   T_init=T_init, seed=i).cpu().numpy())
            iters += seq.last_iteration_count
        ms = 1e3 * (time.perf_counter() - t)
        worst = gates(out, poses[1:SEQ_SCANS + 1], label)
        log(f"[switches] {label}: {SEQ_SCANS} scans, {iters} iterations, "
            f"{ms / SEQ_SCANS:.2f} ms a scan, worst errors {worst[0]:.5f} rad "
            f"{worst[1]:.5f} m, launches {counts()}")
        return iters

    # off, on, on, off: each side's time in both turns
    rec = InputRecorder(dispatch, "knn1_mxu")
    for turn, on in enumerate((False, True, True, False)):
        label = ("sequence under PMTPU_KNN_IMPL=mxu" if on else
                 "sequence, switch off") + f", turn {turn + 1}"
        if not on:
            it = sequence(label)
            only(counts(), "K1", it, label)
            continue
        with switch("PMTPU_KNN_IMPL", "mxu"):
            if turn == 1:
                with rec:
                    it = sequence(label)
                if rec.count != it:
                    raise AssertionError(f"{rec.count} K9 searches for {it} "
                                         f"iterations")
            else:
                it = sequence(label)
            only(counts(), "K9", it, label)
    excess = k9_excess(torch, kc, rec.calls)
    q, qm, r, rm = rec.calls[0][:4]
    k9_ms = cuda_ms(torch, lambda: kc.knn1_mxu(q, qm, r, rm), 20)
    k1_ms = cuda_ms(torch, lambda: kc.knn1(q, qm, r, rm), 20)
    log(f"[switches] K9's pick over K1's d² on the sequence's {len(rec.calls)} "
        f"searches: relative excess max {excess[0]:.4g}, 99th percentile "
        f"{excess[1]:.4g}, largest absolute d² excess {excess[2]:.3g}; at the "
        f"first ({q.shape[0]} x {r.shape[0]}) K9 {k9_ms:.4f} ms, K1 {k1_ms:.4f} ms")
    del rec, q, qm, r, rm
    seq = None
    torch.cuda.empty_cache()

    dense, big = cells["K1"], cells["K4"]
    serve(dense)                                 # warm-up
    times = {False: [], True: []}
    for on in (False, True, True, False):
        if not on:
            base = serve(dense)
            only(base[3], "K1", int(base[1]["iterations"].max()),
                 "dense batch, switch off")
            times[on].append(round(base[2], 2))
            continue
        with switch("PMTPU_KNN_IMPL", "mxu"):
            T, info, ms, got = serve(dense)
        times[on].append(round(ms, 2))
        n = int(info["iterations"].max())
        only(got, "K9", n, "dense batch under the switch")
        worst = gates(T, dense["poses"], "dense batch under the switch")
    log(f"[switches] dense batch under PMTPU_KNN_IMPL=mxu: {times[True]} ms "
        f"(switch off {times[False]} ms; turns off, on, on, off), iterations "
        f"{info['iterations'].tolist()}, worst errors {worst[0]:.5f} rad "
        f"{worst[1]:.5f} m, launches {got}")
    with switch("PMTPU_KNN_IMPL", "mxu"):
        T, info, got, steps, _ = run_queue(
            torch, register_queue_to_map, dense["seq"], dense, None,
            counts, "dense route under PMTPU_KNN_IMPL=mxu")
        only(got, "K9", steps, "dense queue under the switch")
    off = serve(big)
    with switch("PMTPU_KNN_IMPL", "mxu"):
        on = serve(big)
    if on[3]["K9"] or on[3]["K1"] or on[3]["K2"] != on[3]["K4"] or not on[3]["K4"]:
        raise AssertionError(f"50 147-row batch under the switch: launches "
                             f"{on[3]}, expected K2 = K4 > 0 and no K1, K9")
    same(off[:2], on[:2], "50 147-row batch under the switch")
    log(f"[switches] 50 147-row batch under PMTPU_KNN_IMPL=mxu: the survivor "
        f"route, launches {on[3]}, equal to the batch without it bit for bit")

    # ---- 27b. the switches the port does not read (Queue 3 #49, #52, #53)
    host = [pt.PointCloud.from_numpy(x, device="cpu") for x in dense["scans"]]
    base = serve(dense, host)
    unread = (("PMTPU_SOLVE", "chol"), ("PMTPU_SELECT", "bisect"),
              ("PMTPU_STACK_NUMPY", "0"))
    with switch(*unread[0]), switch(*unread[1]), switch(*unread[2]):
        got = serve(dense, host)
    same(base[:2], got[:2], "dense batch under the unread switches")
    if got[3] != base[3]:
        raise AssertionError(f"the unread switches changed the launches: "
                             f"{got[3]} vs {base[3]}")
    log(f"[switches] dense batch of host clouds under "
        f"{' '.join(f'{k}={v}' for k, v in unread)}: equal bit for bit to the "
        f"batch without them, launches {got[3]}")

    # ---- 27c. the upload of host clouds: one host stack against a copy a scan
    rng_t = np.random.default_rng(7)
    map_pts, side = make_terrain(TERRAIN_MAPS[0], rng_t)
    t_scans, t_poses = make_terrain_scans(map_pts, side, rng_t)
    tile = {"seq": terrain_sequence(pt), "scans": t_scans, "poses": t_poses,
            "T_inits": None}
    tile["seq"].set_map(pt.PointCloud.from_numpy(map_pts), seed=0)
    t_host = [pt.PointCloud.from_numpy(x, device="cpu") for x in t_scans]
    stacked = batch_mod._upload

    def one_by_one(readings, dev):
        return [rd.to(dev) for rd in readings]

    for label, cell, clouds, prep in (("dense batch", dense, host, "_prep_scans"),
                                      ("terrain tile batch", tile, t_host,
                                       "_prep_tile_scans")):
        serve(cell, clouds)                      # warm-up
        out = {}
        for path in ("stack", "per scan", "per scan", "stack"):
            batch_mod._upload = one_by_one if path == "per scan" else stacked
            try:
                with PrepTimer(batch_mod, prep) as timer:
                    T, info, ms, got = serve(cell, clouds)
            finally:
                batch_mod._upload = stacked
            out.setdefault(path, []).append((T, info, ms, timer.ms, got))
        for r in out["stack"][1:] + out["per scan"]:
            same(out["stack"][0][:2], r[:2], f"{label}, host stack against per scan")
            if r[4] != out["stack"][0][4]:
                raise AssertionError(f"{label}: launches {r[4]} against "
                                     f"{out['stack'][0][4]}")
        worst = gates(out["stack"][0][0], cell["poses"], label)
        log(f"[switches] {label} of host clouds, host stack against a copy a "
            f"scan (turns stack, per scan, per scan, stack): equal bit for bit; "
            f"prep ms stack {[round(r[3], 3) for r in out['stack']]}, per scan "
            f"{[round(r[3], 3) for r in out['per scan']]}; batch ms stack "
            f"{[round(r[2], 2) for r in out['stack']]}, per scan "
            f"{[round(r[2], 2) for r in out['per scan']]}; worst errors "
            f"{worst[0]:.5f} rad {worst[1]:.5f} m, launches {out['stack'][0][4]}")
    del tile, t_host, host
    torch.cuda.empty_cache()

    # ---- 27d. PMTPU_CACHE_DIR
    cache_dir_probe()
    log(f"[switches] phase 27 took {time.perf_counter() - t_phase:.1f} s")


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
    # the dense, survivor, tile and variant kernels keep their lists,
    # accumulators and staging in registers
    for lib in (kc.LIBRARY, sc.LIBRARY, tc.LIBRARY, kv.LIBRARY):
        spills = [ln.strip() for ln in lib.build_log.splitlines()
                  if any(int(x) for x in re.findall(r"(\d+) bytes spill", ln))]
        if spills:
            raise AssertionError(f"{lib.source.name} spills: {spills}")

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
                Tb, ib = register_batch_to_map(
                    q_seq, cell["qclouds"][:SERVE_BATCH],
                    T_inits=cell["qinits"][:SERVE_BATCH], seed=1)
                cell["queue_batch_T"] = Tb
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
    pair_inits = [perturb(rng) @ g for g in gts]
    kc.reset_launch_counts()
    with InputRecorder(matchers, "knn_search") as rec:
        T, info = register_batch(
            pair_icp, [pt.PointCloud.from_numpy(scans[i + 1]) for i in range(PAIRS)],
            [pt.PointCloud.from_numpy(scans[i]) for i in range(PAIRS)],
            T_inits=pair_inits, seed=1)
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
    # phase 26's inputs: phase 11's batch on the sequence map, these pairs
    multi_in = multi_inputs(
        torch, serve["K4"], serve["K4"]["queue_batch_T"],
        ([scans[i + 1] for i in range(PAIRS)], [scans[i] for i in range(PAIRS)],
         pair_inits), T)
    torch.cuda.empty_cache()

    # ---- 13.-16. large-map tile-sweep serving
    tile_records, k7_call = tile_serving(torch, pt, kc, sc, tc, launches)
    records += tile_records
    torch.cuda.empty_cache()

    # ---- 17.-18. the v1 skip routes on the ~30 000-row map
    records += v1_serving(torch, pt, kc, skc, skip, morton, serve["K3"],
                          launches, route_launches)
    k3 = serve["K3"]
    k3 = {k: k3[k] for k in ("world", "scans", "poses", "T_inits", "qclouds",
                             "qinits", "qposes")}
    # phase 27's cells: the dense map and the 50 147-row one
    switch_cells = {route: serve[route] for route in ("K1", "K4")}
    del serve
    torch.cuda.empty_cache()

    # ---- 19. K7's ablations T4 and T5
    records += tile_ablations(torch, tc, k7_call)
    del k7_call
    torch.cuda.empty_cache()

    # ---- 20. the 1-NN lowerings T1, T2 and T3
    records += knn_variants(torch, kc, kv, seq_k1_inputs)
    del seq_k1_inputs
    torch.cuda.empty_cache()

    # ---- 21. the loop modules and their chains
    t = time.perf_counter()
    loop_chains(torch, pt, world, poses, scans, k3, launches, rng)
    log(f"[chains] phase 21 took {time.perf_counter() - t:.1f} s")

    # ---- 22. the engine features
    t = time.perf_counter()
    engine_features(torch, pt, world, poses, scans, k3, launches, smi, rng)
    log(f"[engine] phase 22 took {time.perf_counter() - t:.1f} s")

    # ---- 23. the data filters and their chains
    t = time.perf_counter()
    filter_chains(torch, pt, world, poses, scans, k3, launches, smi, rng)
    log(f"[filters] phase 23 took {time.perf_counter() - t:.1f} s")

    # ---- 24. IO and the cell-grid matchers
    t = time.perf_counter()
    io_and_cellgrid(torch, pt, world, poses, scans, k3, launches, smi, rng)
    log(f"[cellgrid] phase 24 took {time.perf_counter() - t:.1f} s")

    # ---- 25. the applications
    apps_on_card(torch, pt, world, poses, scans, launches, smi, rng)

    # ---- 26. multi-device on torch.distributed
    torch.cuda.empty_cache()
    multi_device(torch, multi_in, smi)

    # ---- 27. the JAX package's switches
    torch.cuda.empty_cache()
    switches(torch, pt, kc, world, poses, scans, switch_cells, launches, smi, rng)

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
