"""End-to-end system demo: trajectory generation → scan-to-map odometry →
pose-graph refinement → evaluation.

The harness synthesizes a measurable stand-in for a dataset from any seed
cloud: a trajectory of partially-overlapping scans with known ground-truth
poses and sensor noise. It then runs the full stack — ICPSequence odometry
with priors and Anderson acceleration, relative-pose constraint collection,
Gauss-Newton pose-graph refinement with a loop closure — and reports
absolute trajectory error before and after refinement. ``--device cpu``
runs on the CPU; the card is the default.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from libpointmatcher_tpu_torch.apps._common import (REFERENCE_DATA,
                                                    add_device_argument, host)


def rotz(a):
    return np.array(
        [[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
         [0.0, 0.0, 1.0]], np.float32,
    )


def make_trajectory(seed_cloud, n_scans, noise, rng, device=None):
    """Ground-truth poses on an arc + per-scan visibility crops + noise;
    the scans on ``device`` (the card unless ``device="cpu"``)."""
    import libpointmatcher_tpu_torch as pt

    pts, _ = seed_cloud.to_numpy()
    center = pts.mean(axis=0)
    gt = []
    scans = []
    for k in range(n_scans):
        a = 0.06 * k
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = rotz(a)
        T[:3, 3] = center + np.float32([0.15 * k, 0.05 * k, 0.0]) - rotz(a) @ center
        gt.append(T)
        # scan = world points visible from this pose (a moving half-space
        # crop for partial overlap), expressed in the sensor frame
        Tinv = np.linalg.inv(T)
        local = pts @ Tinv[:3, :3].T + Tinv[:3, 3]
        keep = local[:, 0] > np.quantile(local[:, 0], 0.25)
        scan = local[keep] + rng.normal(scale=noise, size=(keep.sum(), 3)).astype(np.float32)
        scans.append(pt.PointCloud.from_numpy(scan.astype(np.float32),
                                              device=device))
    return gt, scans


def ate(poses, gt):
    return float(np.sqrt(np.mean([
        np.linalg.norm(np.asarray(p)[:3, 3] - g[:3, 3]) ** 2
        for p, g in zip(poses, gt)
    ])))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--cloud", default=os.path.join(REFERENCE_DATA,
                                                   "car_cloud400.csv"))
    p.add_argument("--scans", type=int, default=6)
    p.add_argument("--noise", type=float, default=0.005)
    p.add_argument("--decimate", type=int, default=4)
    p.add_argument("--odometry-noise", type=float, default=0.02,
                   help="perturbation injected into odometry estimates to "
                   "give the pose graph something to correct")
    p.add_argument("--seed", type=int, default=0)
    add_device_argument(p)
    args = p.parse_args(argv)

    import libpointmatcher_tpu_torch as pt
    from libpointmatcher_tpu_torch.parallel.posegraph import (
        edges_from_numpy, optimize_pose_graph)

    rng = np.random.default_rng(args.seed)
    seed_cloud = pt.io.load(args.cloud, device=args.device)
    if args.decimate > 1:
        pts, _ = seed_cloud.to_numpy()
        seed_cloud = pt.PointCloud.from_numpy(pts[::args.decimate],
                                              device=args.device)
    gt, scans = make_trajectory(seed_cloud, args.scans, args.noise, rng,
                                device=args.device)

    # ---- scan-to-map odometry with priors (the reference's align_sequence
    # pattern, ICPSequence amortizing map prep)
    seq = pt.ICPSequence(device=args.device)
    seq.set_default()
    seq.acceleration = "anderson"
    seq.set_map(scans[0], seed=args.seed)
    poses = [np.eye(4, dtype=np.float32) @ gt[0]]
    print(f"[0] map seeded ({scans[0].count_host()} pts)")
    for k in range(1, args.scans):
        prior = poses[-1]
        T = host(seq(scans[k], T_init=prior, seed=args.seed + k))
        poses.append(T)
        te = np.linalg.norm(T[:3, 3] - gt[k][:3, 3])
        print(f"[{k}] odometry terr={te:.4f} iters={seq.last_iteration_count}")

    # inject drift so refinement has work to do
    noisy = [poses[0]]
    for k in range(1, args.scans):
        P = poses[k].copy()
        P[:3, :3] = P[:3, :3] @ rotz(rng.normal(scale=args.odometry_noise))
        P[:3, 3] += rng.normal(scale=args.odometry_noise, size=3)
        noisy.append(P)

    ate_before = ate(noisy, gt)

    # ---- pose graph: consecutive odometry constraints + one loop closure
    # (first↔last registered directly)
    ii, jj, Ts = [], [], []
    for k in range(args.scans - 1):
        ii.append(k)
        jj.append(k + 1)
        Ts.append(np.linalg.inv(poses[k]) @ poses[k + 1])
    icp = pt.ICP(device=args.device)
    icp.set_default()
    T_loop = host(icp(scans[-1], scans[0],
                      T_init=np.linalg.inv(gt[0]) @ noisy[-1], seed=args.seed))
    ii.append(0)
    jj.append(args.scans - 1)
    Ts.append(T_loop)
    edges = edges_from_numpy(ii, jj, np.stack(Ts), device=args.device)
    refined, final_res = optimize_pose_graph(
        np.stack(noisy), edges, gn_iters=10, cg_iters=30)
    ate_after = ate(list(host(refined)), gt)

    out = {
        "scans": args.scans,
        "ate_odometry_noisy": round(ate_before, 5),
        "ate_refined": round(ate_after, 5),
        "posegraph_residual": round(float(final_res), 6),
    }
    print(json.dumps(out))
    return 0 if ate_after <= ate_before else 1


if __name__ == "__main__":
    sys.exit(main())
