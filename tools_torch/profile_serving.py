"""Where scan-to-map serving of the port spends its time on the card.

    python3 tools_torch/profile_serving.py [--driver batch|queue]
        [--coarse 4,16,1.0] [--batches 5] [--routes K4,K3,K1,K6,tile]
        [--out FILE.json]

For each route of chip_smoke.py's serving phase (the 100 000-point scene's
50 147-row map: K2 + K4; a 60 000-point scene's map: K2 + K3; a
25 000-point scene's map: dense K1) it serves, with ``--driver batch``, 8
scans of 25 000 points per ``register_batch_to_map`` call, or with
``--driver queue`` a queue of 64 such scans through 8 lanes per
``register_queue_to_map`` call (``--coarse`` adds the coarse pass). The K6
route (not in the default ``--routes``) serves a map of another scene of
the K3 route's size (60 000 points) with ``KDTreeMatcher({"knn": "3"})`` under
``PMTPU_SERVE_SKIP=1``: K2 (k = 3) + K6, chip_smoke.py's top-k route. The
tile route (K7) serves chip_smoke.py's large-map configuration: the
10^5-point terrain map through ``BlockGridMatcher``, 8 scans of ~18 500
points per batch, or a queue of those 8 scans three times (the tile route
has no coarse pass). ``--routes`` profiles a subset (each route's scene is
drawn all the same, so a route serves the same scans in any subset); the
v1 skip routes are the K3 route run under ``PMTPU_SKIP_V1=1`` (and
``PMTPU_SKIP_MXU_BOUND=1``) in the environment. After one warm-up call it

1. times ``--batches`` calls on the host clock, each ending in a
   synchronize (ms per call, iterations of the loop, ms per iteration: a
   lockstep iteration of the batch, a lane iteration of the queue, both
   passes counted);
2. traces as many more with ``torch.profiler`` and reports the device time
   by kernel name, the kernel launches per iteration, and the device busy
   share: traced kernel time per iteration over the untraced wall time per
   iteration (the profiler slows the host several-fold).

Needs a CUDA device; prints one JSON object (and writes it to ``--out``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools_torch.profile_registration import _device_us  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--driver", choices=("batch", "queue"), default="batch")
    ap.add_argument("--coarse", default=None,
                    help="the queue's coarse pass, e.g. 4,16,1.0")
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--routes", default="K4,K3,K1,tile",
                    help="the routes to profile, comma-separated")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_serving: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.matchers import KDTreeMatcher
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops import skip_cuda as skc
    from libpointmatcher_tpu_torch.ops import sweep_cuda as sc
    from libpointmatcher_tpu_torch.ops import tile_cuda as tc
    from libpointmatcher_tpu_torch.parallel import (register_batch_to_map,
                                                    register_queue_to_map)
    from torch.profiler import ProfilerActivity, profile

    for lib in (kc, sc, tc, skc):
        lib.build()
    routes = args.routes.split(",")
    rng = np.random.default_rng(0)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    queue = args.driver == "queue"
    coarse = (tuple(float(x) if "." in x else int(x)
                    for x in args.coarse.split(",")) if args.coarse else None)
    out = {"device": smi, "driver": args.driver,
           "lanes": cs.QUEUE_LANES if queue else None, "coarse": coarse,
           "switches": {k: os.environ[k] for k in cs.V1_KEYS if k in os.environ},
           "routes": {}}
    for route in (*cs.SERVE_SCENES, "K6", "tile"):
        if route == "K6" and route not in routes:
            continue
        if route == "tile":
            if route not in routes:
                continue
            trng = np.random.default_rng(7)      # chip_smoke.py's scene
            terrain, side = cs.make_terrain(cs.TERRAIN_MAPS[0], trng)
            scans_np, _ = cs.make_terrain_scans(terrain, side, trng)
            if queue:
                scans_np = scans_np * cs.TILE_QUEUE_REPEAT
            clouds = [pt.PointCloud.from_numpy(x) for x in scans_np]
            inits = None
            seq = cs.terrain_sequence(pt)
            seq.set_map(pt.PointCloud.from_numpy(terrain), seed=0)
        else:
            # the K6 route serves the K3 route's scene, as in chip_smoke.py
            scene = cs.SERVE_SCENES["K3" if route == "K6" else route]
            world = cs.make_scene(rng, scene)
            poses = cs.make_poses(
                world, cs.QUEUE_SCANS if queue else cs.SERVE_BATCH, rng)
            clouds = [pt.PointCloud.from_numpy(cs.make_scan(world, P, rng))
                      for P in poses]
            inits = [cs.perturb(rng) @ P for P in poses]
            if route not in routes:
                continue
            seq = pt.ICPSequence()
            seq.set_default()
            if route == "K6":
                seq.matcher = KDTreeMatcher({"knn": "3"})
            seq.set_map(pt.PointCloud.from_numpy(world), seed=0)
        scans = len(clouds)
        env_skip = os.environ.get("PMTPU_SERVE_SKIP")
        if route == "K6":
            os.environ["PMTPU_SERVE_SKIP"] = "1"
        steps = [0]
        step = seq._step

        def counted(*a, **k):
            steps[0] += 1
            return step(*a, **k)

        seq._step = counted

        def serve(seed):
            """One call → the loop iterations it ran."""
            steps[0] = 0
            if queue:
                register_queue_to_map(seq, clouds, T_inits=inits, seed=seed,
                                      lanes=cs.QUEUE_LANES, coarse=coarse)
            else:
                register_batch_to_map(seq, clouds, T_inits=inits, seed=seed)
            return steps[0]

        serve(0)                                     # warm-up: map tables
        wall, iters = [], []
        for b in range(1, args.batches + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            iters.append(serve(b))
            torch.cuda.synchronize()
            wall.append(1e3 * (time.perf_counter() - t))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            traced_iters = sum(serve(b) for b in range(args.batches + 1,
                                                       2 * args.batches + 1))
            torch.cuda.synchronize()
        kernels = []
        for evt in prof.key_averages():
            us = _device_us(evt)
            if us > 0 and str(getattr(evt, "device_type", "")).endswith("CUDA"):
                kernels.append((evt.key, us / 1e3, evt.count))
        kernels.sort(key=lambda x: -x[1])
        device_ms = sum(k[1] for k in kernels)
        per_iter = float(np.median(np.array(wall) / np.array(iters)))
        out["routes"][route] = {
            "map_rows": seq.prefiltered_reference_pts_count,
            "scans_per_call": scans,
            "ms_per_call": wall,
            "registrations_per_s": [1e3 * scans / w for w in wall],
            "loop_iterations": iters,
            "ms_per_iteration_median": per_iter,
            "traced_iterations": traced_iters,
            "device_ms_per_iteration": device_ms / traced_iters,
            "device_busy_share": (device_ms / traced_iters) / per_iter,
            "kernel_launches_per_iteration":
                sum(k[2] for k in kernels) / traced_iters,
            "top_kernels_ms_per_iteration": [
                (k, ms / traced_iters, c / traced_iters)
                for k, ms, c in kernels[:15]],
        }
        if route == "K6":
            if env_skip is None:
                del os.environ["PMTPU_SERVE_SKIP"]
            else:
                os.environ["PMTPU_SERVE_SKIP"] = env_skip
        del seq, clouds
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
