"""Scaling study: registrations/s as the pair batch is split over ranks
(counterpart of ``libpointmatcher_tpu.apps.scaling_bench``).

    python -m libpointmatcher_tpu_torch.apps.scaling_bench --ranks 4
        [--backend gloo] [--pairs-per-device 2] [--points 2048] [--runs 3]
        [--device cuda]

The JAX package runs ``register_batch`` over a device mesh of 1, n/2 and
n devices (``--virtual-devices`` forces n CPU devices). Here the devices
are ranks of a ``torch.distributed`` group: the parent spawns ``--ranks``
local processes, which join a group with ``--backend`` (``file://``
store, every collective under a timeout) and share the host's cores
evenly, and each mesh size runs
``register_batch(..., mesh=)`` with ``--pairs-per-device`` pairs a rank,
once to warm up and then ``--runs`` times, each run ending when every
rank holds the whole batch's poses. Rank r runs on ``cuda:r`` modulo the
cards present, or on the CPU with ``--device cpu``. NCCL takes one rank
per card, so more NCCL ranks than cards are refused; gloo puts several
ranks on one card, staging each collective through host memory, and then
the ranks share the card's SMs: such numbers say how the layer scales,
not what several cards would do.

Prints a line a mesh size, then the JSON object of the JAX package
(``{"<n>_devices": {"pairs": ..., "registrations_per_s": ...}}``); on
the card, the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from libpointmatcher_tpu_torch.apps._common import add_device_argument

#: each rank's timeout on the group's collectives, and the parent's on
#: the whole run
RANK_TIMEOUT_S = 600.0
RUN_TIMEOUT_S = 1800.0


def _rank(rank: int, args, init_file: str, out_file: str) -> None:
    """One rank: every mesh size in turn, rank 0 writing the results."""
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.parallel import make_mesh, register_batch

    device = args.device
    # the ranks share the host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.ranks))
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = f"cuda:{torch.cuda.current_device()}"
    dist.init_process_group(args.backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=args.ranks,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        rng = np.random.default_rng(0)
        src = rng.uniform(-1, 1, size=(args.points, 3)).astype(np.float32)
        shift = np.float32([0.1, -0.05, 0.08])
        reading = pt.PointCloud.from_numpy(src, device=device)
        reference = pt.PointCloud.from_numpy(src + shift, device=device)
        icp = pt.ICP(device=device)
        icp.set_default()
        icp.reading_filters = []
        sync = torch.cuda.synchronize if device.startswith("cuda") else (lambda: None)
        results = {}
        for n in sorted({1, max(1, args.ranks // 2), args.ranks}):
            mesh = make_mesh(n, axis_name="pairs", device=device,
                             timeout=timedelta(seconds=RANK_TIMEOUT_S))
            if not mesh.member:
                continue
            b = args.pairs_per_device * n
            register_batch(icp, [reading] * b, [reference] * b, seed=0,
                           mesh=mesh)
            sync()
            t0 = time.perf_counter()
            for i in range(args.runs):
                register_batch(icp, [reading] * b, [reference] * b,
                               seed=i + 1, mesh=mesh)
            sync()
            dt = (time.perf_counter() - t0) / args.runs
            results[f"{n}_devices"] = {"pairs": b,
                                       "registrations_per_s": b / dt,
                                       "ms_per_batch": 1e3 * dt}
        if rank == 0:
            with open(out_file, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ranks", type=int, default=2,
                   help="local ranks to spawn (the largest mesh)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default="gloo",
                   help="the group's backend: nccl (device tensors, one rank "
                   "per card) or gloo (host tensors)")
    p.add_argument("--pairs-per-device", type=int, default=2)
    p.add_argument("--points", type=int, default=2048)
    p.add_argument("--runs", type=int, default=3)
    add_device_argument(p)
    args = p.parse_args(argv)

    import torch

    from libpointmatcher_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.backend == "nccl":
        if dev.type != "cuda":
            raise SystemExit("scaling_bench: an NCCL group needs --device cuda")
        if args.ranks > torch.cuda.device_count():
            raise SystemExit(f"scaling_bench: NCCL takes one rank per card; "
                             f"{args.ranks} ranks for "
                             f"{torch.cuda.device_count()} cards")
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        out_file = os.path.join(tmp, "results.json")
        ctx = torch.multiprocessing.start_processes(
            _rank, args=(args, os.path.join(tmp, "store"), out_file),
            nprocs=args.ranks, join=False, start_method="spawn")
        deadline = time.monotonic() + RUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise SystemExit("scaling_bench: the ranks did not finish "
                                     f"within {RUN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(10)
        with open(out_file) as f:
            results = json.load(f)
    for key, r in results.items():
        print(f"{key.split('_')[0]} devices: {r['pairs']} pairs in "
              f"{r['ms_per_batch']:.1f} ms → {r['registrations_per_s']:.2f} "
              f"reg/s", flush=True)
    print(json.dumps({k: {"pairs": r["pairs"],
                          "registrations_per_s": round(r["registrations_per_s"], 3)}
                      for k, r in results.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
