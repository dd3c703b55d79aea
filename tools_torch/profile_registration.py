"""Where a scan-to-map registration of the port spends its time on the card.

    python3 tools_torch/profile_registration.py [--scans 8] [--out FILE.json]

Builds the scene and scans of chip_smoke.py (about 100 000 map points before
filtering, scans of 25 000 points), runs ``ICPSequence.set_map`` and one
warm-up registration, then

1. times ``--scans`` registrations on the host clock, each ending in a
   synchronize (ms per registration, iterations, ms per iteration);
2. traces ``--scans`` more with ``torch.profiler`` and reports the device
   time by kernel name, the kernel launches per ICP iteration, and the
   device busy share: traced kernel time per iteration over the untraced
   wall time per iteration (the profiler slows the host several-fold).

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


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=8)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_registration: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc

    kc.build()
    rng = np.random.default_rng(0)
    world = cs.make_scene(rng)
    n = 2 * args.scans + 1
    poses = cs.make_poses(world, n, rng)
    scans = [cs.make_scan(world, P, rng) for P in poses]
    inits = [cs.perturb(rng) @ P for P in poses]
    seq = pt.ICPSequence()
    seq.set_default()
    seq.set_map(pt.PointCloud.from_numpy(world), seed=0)

    def register(i):
        T = seq.compute(pt.PointCloud.from_numpy(scans[i]), T_init=inits[i], seed=i)
        T.cpu()
        return seq.last_iteration_count

    register(0)                                      # warm-up
    wall, iters = [], []
    for i in range(1, args.scans + 1):
        torch.cuda.synchronize()
        t = time.perf_counter()
        iters.append(register(i))
        torch.cuda.synchronize()
        wall.append(1e3 * (time.perf_counter() - t))

    from torch.profiler import ProfilerActivity, profile

    kc.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        traced_iters = sum(register(i) for i in range(args.scans + 1, n))
        torch.cuda.synchronize()
    traced_ms = 1e3 * (time.perf_counter() - t)
    kernels = []
    for evt in prof.key_averages():
        us = _device_us(evt)
        if us > 0 and getattr(evt, "device_type", None) is not None and \
                str(evt.device_type).endswith("CUDA"):
            kernels.append((evt.key, us / 1e3, evt.count))
    kernels.sort(key=lambda x: -x[1])
    device_ms = sum(k[1] for k in kernels)
    launches = sum(k[2] for k in kernels)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    out = {
        "device": smi,
        "map_points": seq.prefiltered_reference_pts_count,
        "reading_points": seq.prefiltered_reading_pts_count,
        "ms_per_registration": wall,
        "iterations": iters,
        "ms_per_iteration_median": float(np.median(np.array(wall) / np.array(iters))),
        "traced_registrations": args.scans,
        "traced_iterations": traced_iters,
        # the profiler's own cost inflates the traced wall time, so the busy
        # share divides the traced device time per iteration by the
        # untraced wall time per iteration
        "traced_wall_ms_with_profiler": traced_ms,
        "traced_device_ms": device_ms,
        "device_ms_per_iteration": device_ms / traced_iters,
        "device_busy_share": (device_ms / traced_iters)
        / float(np.median(np.array(wall) / np.array(iters))),
        "kernel_launches_per_iteration": launches / traced_iters,
        "k1_launches": kc.knn1.launches,
        "top_kernels_ms": [(k, ms, c) for k, ms, c in kernels[:20]],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
