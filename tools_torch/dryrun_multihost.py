"""Two-process run of the pair-parallel axis (counterpart of
tools/dryrun_multihost.py).

    python3 tools_torch/dryrun_multihost.py [--points 2048] [--device cuda]
        [--out FILE.json]

Two processes, one rank and one thread each, join a gloo group
(``file://`` store, every collective under a timeout) and run
``register_batch(..., mesh=)`` on the same 8 deterministic pairs: each
registers its 4 and gathers the other rank's. Each then runs the one-process ``register_batch`` on the whole
batch as the oracle. A rank passes when every pose is within 1e-5 of the
oracle's (tests/test_multihost.py's gate) and every translation within
0.05 m of the truth. Both ranks run on ``--device`` (the card by default,
``cpu`` for the CPU), gloo staging its collectives through host memory on
the card. Prints one line a rank and the JSON summary; writes the summary
only to ``--out``. Exits 0 when both ranks pass.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_PROCS = 2
PAIRS = 8
POSE_TOL = 1e-5
TRUTH_TOL = 0.05
RANK_TIMEOUT_S = 300.0
RUN_TIMEOUT_S = 900.0


def make_pairs(points: int):
    """The deterministic pair batch, the same in every process → numpy
    ``(readings, references, T_true)``: crossed waves and a bowl (all six
    degrees of freedom constrained), each reading the reference moved by a
    small random pose."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(42)
    readings, references, T_true = [], [], []
    for _ in range(PAIRS):
        base = rng.uniform(-3, 3, size=(points, 3)).astype(np.float32)
        base[:, 2] = (0.4 * np.sin(1.7 * base[:, 0])
                      + 0.4 * np.cos(1.7 * base[:, 1])
                      + 0.08 * (base[:, 0] ** 2 + base[:, 1] ** 2))
        base += rng.normal(scale=0.005, size=base.shape).astype(np.float32)
        R = Rotation.from_rotvec(rng.normal(scale=0.05, size=3)).as_matrix()
        t = rng.normal(scale=0.1, size=3).astype(np.float32)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = R
        T[:3, 3] = t
        references.append(base)
        readings.append((base @ R.T.astype(np.float32) + t).astype(np.float32))
        T_true.append(np.linalg.inv(T))
    return readings, references, T_true


def _rank(rank: int, points: int, device: str, init_file: str,
          out_dir: str) -> None:
    from datetime import timedelta

    import numpy as np
    import torch
    import torch.distributed as dist

    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.parallel import make_mesh, register_batch

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=N_PROCS,
                            timeout=timedelta(seconds=RANK_TIMEOUT_S))
    try:
        reads, refs, T_true = make_pairs(points)

        def run(mesh):
            icp = pt.ICP(device=device)
            icp.set_default()
            return register_batch(
                icp, [pt.PointCloud.from_numpy(r, device=device) for r in reads],
                [pt.PointCloud.from_numpy(r, device=device) for r in refs],
                seed=0, mesh=mesh)

        mesh = make_mesh(N_PROCS, axis_name="pairs", device=device,
                         timeout=timedelta(seconds=RANK_TIMEOUT_S))
        t0 = time.perf_counter()
        T_multi, info = run(mesh)
        wall = time.perf_counter() - t0
    finally:
        dist.destroy_process_group()
    T_single, info1 = run(None)
    dT = float(np.abs(T_multi - T_single).max())
    err_t = max(float(np.linalg.norm(T_multi[i][:3, 3] - T_true[i][:3, 3]))
                for i in range(PAIRS))
    same = bool(np.array_equal(info["iterations"], info1["iterations"])
                and np.array_equal(info["codes"], info1["codes"]))
    result = {"process": rank, "processes": N_PROCS, "pairs": PAIRS,
              "device": device, "multi_vs_single_maxdiff": dT,
              "trans_err_max_vs_truth": err_t,
              "iterations": [int(x) for x in info["iterations"]],
              "same_iterations_and_codes": same, "wall_s": wall,
              "ok": bool(dT < POSE_TOL and err_t < TRUTH_TOL and same)}
    with open(os.path.join(out_dir, f"p{rank}.json"), "w") as f:
        json.dump(result, f)
    print(f"proc {rank}: dT={dT:.2e} err_t={err_t:.4f} ok={result['ok']}",
          flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--points", type=int, default=2048,
                   help="points of each cloud")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    p.add_argument("--out", help="write the JSON summary to this file")
    args = p.parse_args(argv)

    import torch

    from libpointmatcher_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _rank, args=(args.points, str(dev), os.path.join(tmp, "store"), tmp),
            nprocs=N_PROCS, join=False, start_method="spawn")
        deadline = time.monotonic() + RUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise SystemExit(f"dryrun: the ranks did not finish within "
                                     f"{RUN_TIMEOUT_S} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
                    proc.join(10)
        results = []
        for r in range(N_PROCS):
            with open(os.path.join(tmp, f"p{r}.json")) as f:
                results.append(json.load(f))
    summary = {"benchmark": "two-process pair-parallel registration",
               "backend": f"gloo, one rank a process, on {dev}",
               "ok": all(r["ok"] for r in results), "results": results}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary, indent=1))
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
