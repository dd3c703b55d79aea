"""Pose errors of the loop chains under two stop rules, on the card.

    python3 tools_torch/chain_convergence.py [--seeds 3] [--device cuda]

For each seed, a fresh 60 000-point room of ``chip_smoke.py`` (its K3
serving scene) with 8 scans of 25 000 points and perturbed initial poses
(``make_scene``, ``make_poses``, ``make_scan``, ``perturb`` from
``numpy.random.default_rng(100 + seed)``) is served through
``register_batch_to_map`` with the point-to-point chains of
``tools_torch/loop_modules.py`` under the default stop rule (Counter(40),
Differential(1e-3)) and under theirs (Counter(100), Differential(1e-4)),
and with the default chain. Each line gives the scans outside
``chip_smoke.py``'s gates (0.02 rad, 0.05 m), the iterations, the worst
errors and the batch's wall time; the last line is one JSON object of the
same. ``--device cpu`` runs the plain versions (slow at this size: cut
with ``--scene 20000 --scan 8000``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402

import libpointmatcher_tpu_torch as pt  # noqa: E402
from libpointmatcher_tpu_torch.parallel import register_batch_to_map  # noqa: E402
from tools_torch import loop_modules as lm  # noqa: E402


def run(seeds: int, device: str, scene: int, scan: int) -> list:
    out = []
    for seed in range(seeds):
        rng = np.random.default_rng(100 + seed)
        world = cs.make_scene(rng, scene)
        poses = cs.make_poses(world, 8, rng)
        scans = [cs.make_scan(world, P, rng, scan) for P in poses]
        inits = [cs.perturb(rng) @ P for P in poses]
        cases = [("p2p_trimmed", "default"), ("p2p_trimmed", "own"),
                 ("p2p_vartrimmed", "default"), ("p2p_vartrimmed", "own"),
                 ("default", "own")]
        for name, rule in cases:
            text = lm.chain_yaml(
                name, stop=lm.DEFAULT_STOP if rule == "default" else None)
            seq = pt.ICPSequence(device=device)
            seq.load_from_yaml(text)
            seq.set_map(pt.PointCloud.from_numpy(world, device=device))
            t = time.perf_counter()
            T, info = register_batch_to_map(
                seq, [pt.PointCloud.from_numpy(s, device=device) for s in scans],
                T_inits=inits, seed=1)
            ms = 1e3 * (time.perf_counter() - t)
            errs = [cs.pose_error(Ti, P) for Ti, P in zip(T, poses)]
            row = {"seed": seed, "chain": name, "stop": rule,
                   "outside_gates": sum(not (a < cs.ROT_TOL and b < cs.TRANS_TOL)
                                        for a, b in errs),
                   "iterations": info["iterations"].tolist(),
                   "worst_rot": max(a for a, _ in errs),
                   "worst_trans": max(b for _, b in errs), "ms": ms}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scene", type=int, default=60_000)
    ap.add_argument("--scan", type=int, default=cs.SCAN_POINTS)
    args = ap.parse_args()
    rows = run(args.seeds, args.device, args.scene, args.scan)
    summary = {}
    for r in rows:
        key = f"{r['chain']} {r['stop']}"
        summary[key] = summary.get(key, 0) + r["outside_gates"]
    print(json.dumps({"outside_gates": summary, "scans_each": 8 * args.seeds}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
