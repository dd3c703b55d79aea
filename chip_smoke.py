"""Smoke run of libpointmatcher_tpu_torch on one CUDA card (Hopper, sm_90).

    python3 chip_smoke.py

Phases, each fatal on failure:

1. device: the card's name and power limit, torch and CUDA versions;
   compute capability 9.0 is required;
2. build: the k-NN kernels from ``libpointmatcher_tpu_torch/csrc`` (nvcc);
3. kernels: K1, K9 and K5 against their plain torch versions on the card,
   at the serving shapes 20480 x 12459 and 25000 x 100000, timed with CUDA
   events beside the plain version and a ``torch.cdist`` yardstick;
4. registration: a synthetic indoor scene of about 100 000 points and
   scans of 25 000 points (numpy, seeded). One one-shot ``ICP`` of two
   scans, ``ICPSequence.set_map`` on the scene and eight scans through
   ``compute``, each pose held to the ground truth (rotation < 0.02 rad,
   translation < 0.05 m). Kernel launch counts are set to 0 just before
   and read just after; the same is done for a matcher with ``epsilon`` at
   the K9 floor (the K9 route) and one with ``knn`` = 5 (the K5 route);
5. each kernel once more at the shapes the registration gave it, for the
   JSON line of kernels (times, error, bound, launches).

The second-to-last line is the JSON of kernels, the last line
``{"ok": true, "device": {...}}``. Without a CUDA device it exits 1 and
prints no result. Only the port is imported.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Published H100 SXM peaks (dense, no sparsity), used for the bound.
FP32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12

SCENE_POINTS = 100_000
SCAN_POINTS = 25_000
SEQ_SCANS = 8
ROT_TOL = 0.02
TRANS_TOL = 0.05


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
}


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
    from libpointmatcher_tpu_torch.ops import knn_cuda as kc
    from libpointmatcher_tpu_torch.ops.dispatch import MXU_EPSILON_FLOOR
    from libpointmatcher_tpu_torch.matchers import KDTreeMatcher

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
    kc.build()
    log(f"[build] k-NN kernels built in {time.perf_counter() - t0:.2f} s")
    for line in kc.build_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

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
    # K9 serves the (1+ε) contract only if its measured excess over the
    # exact neighbour distance stays below the routing floor
    if max(k9_excess) >= MXU_EPSILON_FLOOR:
        raise AssertionError(f"K9 excess {max(k9_excess):.3g} not below "
                             f"MXU_EPSILON_FLOOR {MXU_EPSILON_FLOOR}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
