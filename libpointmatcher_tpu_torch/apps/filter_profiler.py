"""Timing harness for data filters (reference: examples/filterProfiler.cpp).
``--device cpu`` runs on the CPU; the card is the default, where each run
is timed to the card's completion."""

from __future__ import annotations

import argparse
import sys
import time

import torch

import libpointmatcher_tpu_torch as pt
from libpointmatcher_tpu_torch.apps._common import add_device_argument
from libpointmatcher_tpu_torch.utils import prng


def main(argv=None):
    p = argparse.ArgumentParser(description="Profile a data filter.")
    p.add_argument("cloud")
    p.add_argument("--filter", default="SurfaceNormalDataPointsFilter")
    p.add_argument("--param", action="append", default=[],
                   help="name=value, repeatable")
    p.add_argument("--runs", type=int, default=5)
    add_device_argument(p)
    args = p.parse_args(argv)

    params = dict(kv.split("=", 1) for kv in args.param)
    cloud = pt.io.load(args.cloud, device=args.device)
    f = pt.DataPointsFilterRegistrar.create(args.filter, params)
    key = prng.prng_key(0)

    def sync():
        if cloud.device.type == "cuda":
            torch.cuda.synchronize(cloud.device)

    # warmup
    out = f.filter(cloud, key=key)
    out.count_host()
    times = []
    for i in range(args.runs):
        sync()
        t0 = time.perf_counter()
        out = f.filter(cloud, key=prng.fold_in(key, i))
        out.count_host()
        sync()
        times.append(time.perf_counter() - t0)
    n_in = cloud.count_host()
    n_out = out.count_host()
    print(
        f"{args.filter}: {n_in} → {n_out} pts, "
        f"mean {1e3 * sum(times) / len(times):.2f} ms "
        f"(min {1e3 * min(times):.2f}, max {1e3 * max(times):.2f}) "
        f"over {args.runs} runs"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
